"""The share of the window the engine's host thread spent on its own
work rather than waiting on the card: the ``read``, ``h2d``, ``launch``
and ``write`` hops of the program's ``HopSink`` notes, over the window.
``launch`` is billed on CUDA only, so a CPU rehearsal, or a program
without these hops, reads nothing."""

UNIT = "%"

HOPS = ("read", "h2d", "launch", "write")


def read(r):
    hops = r.get("hops", ())
    if not any(hop == "launch" for hop, _ in hops):
        return None
    return 100.0 * sum(s for hop, s in hops if hop in HOPS) / r["window_s"]
