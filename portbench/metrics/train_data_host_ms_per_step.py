"""The trainer's data path per step in the window, from the program's
own ranges on the profiler's timeline: ``host.trainer.read``, ``to_rgb``,
``downsample`` and ``h2d``, clipped to the window, over its steps."""

UNIT = "ms"

SPANS = ("host.trainer.read", "host.trainer.to_rgb", "host.trainer.downsample",
         "host.trainer.h2d")


def read(r):
    timeline, steps = r.get("timeline"), r.get("steps")
    if timeline is None or not steps:
        return None
    spans = [end - start for name, start, end in timeline.spans if name in SPANS]
    return 1e3 * sum(spans) / steps if spans else None
