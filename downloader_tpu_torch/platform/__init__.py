"""Platform layer: cross-cutting services.

Capability-equivalent to the reference's external ``triton-core`` npm package
(config, logging, tracing, metrics, telemetry, service discovery — SURVEY.md
§1 "Platform layer"), rebuilt in-tree so the framework is self-contained.
"""
