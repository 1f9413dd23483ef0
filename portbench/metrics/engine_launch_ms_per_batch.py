"""The engine's ``launch`` hop per dispatched batch: the model's
launches on every shard, the pinned output buffers, the d2h enqueue and
the events, from the program's ``HopSink`` notes inside the window (CUDA
only)."""

UNIT = "ms"


def read(r):
    hops = [s for hop, s in r.get("hops", ()) if hop == "launch"]
    return 1e3 * sum(hops) / len(hops) if hops else None
