"""The host's time to launch one train step: the program's
``host.trainer.launch`` ranges on the profiler's timeline (the step's
call, which returns before the card finishes), clipped to the window,
over its steps."""

UNIT = "ms"


def read(r):
    timeline, steps = r.get("timeline"), r.get("steps")
    if timeline is None or not steps:
        return None
    spans = [end - start for name, start, end in timeline.spans
             if name == "host.trainer.launch"]
    return 1e3 * sum(spans) / steps if spans else None
