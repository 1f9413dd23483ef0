"""The share of the traced window in which the card ran no operation,
on the training cells."""

UNIT = "%"


def read(r):
    timeline = r["timeline"]
    if r["traffic"]["driver"] != "train" or timeline is None:
        return None
    share = timeline.idle_share()
    return None if share is None else 100.0 * share
