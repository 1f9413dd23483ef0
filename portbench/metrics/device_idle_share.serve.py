"""The share of the traced window in which the idlest card ran no
operation (kernels, copies and fills), on the serving cells."""

UNIT = "%"


def read(r):
    timeline = r["timeline"]
    if r["traffic"]["driver"] != "stream" or timeline is None:
        return None
    share = timeline.idle_share()
    return None if share is None else 100.0 * share
