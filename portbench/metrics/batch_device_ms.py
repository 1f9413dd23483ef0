"""Device time of one dispatched batch: CUDA events around each
``FrameUpscaler._core`` call in the window (on several cards, the
longest shard of each dispatch), averaged over the dispatches."""

UNIT = "ms"


def read(r):
    core = r.get("core_ms")
    return sum(core) / len(core) if core else None
