"""The share of the card's batch time that SwinIR's window attention
takes: the program's ``attention`` hop over its ``device`` hop (timing
events around each shard's whole compute), inside the window.  What a
fused window-attention kernel would work on."""

UNIT = "%"


def read(r):
    if r["traffic"]["driver"] != "stream_arch" or r["config"].get("arch") != "swinir":
        return None
    hops = r.get("hops", ())
    attention = sum(s for hop, s in hops if hop == "attention")
    device = sum(s for hop, s in hops if hop == "device")
    return 100.0 * attention / device if attention and device else None
