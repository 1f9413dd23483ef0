"""The card's seconds per dispatched batch as the program bills them:
its ``device`` hop, timing events before and after each shard's compute
(the longest shard of a dispatch), one note a batch inside the window."""

UNIT = "ms"


def read(r):
    hops = [s for hop, s in r.get("hops", ()) if hop == "device"]
    return 1e3 * sum(hops) / len(hops) if hops else None
