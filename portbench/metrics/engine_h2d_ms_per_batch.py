"""The engine's ``h2d`` hop (staging into pinned memory and the
non-blocking uploads) per dispatched batch, from the program's
``HopSink`` notes inside the window."""

UNIT = "ms"


def read(r):
    hops = [s for hop, s in r.get("hops", ()) if hop == "h2d"]
    return 1e3 * sum(hops) / len(hops) if hops else None
