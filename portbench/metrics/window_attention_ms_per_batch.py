"""The card's window attention per dispatched batch on a SwinIR cell:
the program's ``attention`` hop (timing events around every Swin
block's attention, the longest shard's sum) over its ``launch`` hops,
from the ``HopSink`` notes inside the window.  Nothing to read where the
program bills no such hop."""

UNIT = "ms"


def read(r):
    if r["traffic"]["driver"] != "stream_arch" or r["config"].get("arch") != "swinir":
        return None
    hops = r.get("hops", ())
    attention = [s for hop, s in hops if hop == "attention"]
    launches = sum(1 for hop, _ in hops if hop == "launch")
    return 1e3 * sum(attention) / launches if attention and launches else None
