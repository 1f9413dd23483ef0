"""The engine's stream I/O per dispatched batch: its ``read`` (the
source's frames read, parsed and stacked) and ``write`` (the output
frames into the sink) hops inside the window, over the count of its
``launch`` notes there (CUDA only)."""

UNIT = "ms"

HOPS = ("read", "write")


def read(r):
    hops = r.get("hops", ())
    batches = sum(hop == "launch" for hop, _ in hops)
    io = [s for hop, s in hops if hop in HOPS]
    return 1e3 * sum(io) / batches if batches and io else None
