"""Percent of the traced window in which no operation ran on the device:
one less the union of the device operations' intervals over the window
(forward cells)."""
from stats import idle_share


def read(rec):
    tr = rec.get("trace")
    if tr is None or rec["kind"] != "forward":
        return None
    return idle_share(tr["busy_s"], tr["window_s"])
