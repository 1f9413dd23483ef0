"""One train step's device time, from the profiler's timeline: the
seconds in which one of the card's operations ran between the first and
the last ``host.step`` span's start in the window, over the steps
between.  The copies of the crops to the card are the data path's, and
left out; every other operation in the window is a step's."""

UNIT = "ms"

DATA_COPIES = ("Memcpy HtoD",)


def read(r):
    timeline = r.get("timeline")
    if r["traffic"]["driver"] != "train" or timeline is None or not timeline.ops:
        return None
    starts = timeline.span_starts("host.step")
    if len(starts) < 2:
        return None
    busy = timeline.mean_busy_between(starts[0], starts[-1], DATA_COPIES)
    return 1e3 * busy / (len(starts) - 1)
