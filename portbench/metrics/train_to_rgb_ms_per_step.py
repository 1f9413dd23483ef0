"""The trainer's conversion of whole frames to RGB per step in the
window: the program's ``host.trainer.to_rgb`` ranges on the profiler's
timeline, clipped to the window, over its steps."""

UNIT = "ms"


def read(r):
    timeline, steps = r.get("timeline"), r.get("steps")
    if timeline is None or not steps:
        return None
    spans = [end - start for name, start, end in timeline.spans
             if name == "host.trainer.to_rgb"]
    return 1e3 * sum(spans) / steps if spans else None
