"""The share of the window the engine's host thread spent waiting on the
card (the ``compute`` hop of the program's ``HopSink``)."""

UNIT = "%"


def read(r):
    hops = [s for hop, s in r.get("hops", ()) if hop == "compute"]
    return 100.0 * sum(hops) / r["window_s"] if hops else None
