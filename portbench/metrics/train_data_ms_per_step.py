"""Host time between consecutive train steps in the window: from one
step's return to the next step's call, the crops, the downsample and
the copies to the card (the trainer's data path)."""

UNIT = "ms"


def read(r):
    gaps = r.get("data_ms")
    return sum(gaps) / len(gaps) if gaps else None
