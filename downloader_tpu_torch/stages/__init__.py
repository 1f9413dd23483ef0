"""Pipeline stages.

Three plugins with a uniform async contract, run strictly sequentially per
job with each stage's return value threaded to the next as
``job.last_stage`` (reference stage order + threading:
upstream lib/main.js:28-32,126-140).
"""

from .base import STAGES, Job, StageContext, get_stage_factory, load_stages, register_stage

__all__ = [
    "STAGES",
    "Job",
    "StageContext",
    "get_stage_factory",
    "load_stages",
    "register_stage",
]
