"""K1's share of its bound by bytes (``peaks.k1_bytes`` of each launch
of one replay, recorded on an eager run of the program's body) over K1's
device time a replay in the traced window (forward cells)."""
from devtrace import kernel_seconds
from peaks import k1_bytes, roofline_percent


def read(rec):
    tr, la = rec.get("trace"), rec.get("launches")
    if tr is None or not la or not la["k1"] or rec["kind"] != "forward":
        return None
    n_bytes = sum(k1_bytes(*x) for x in la["k1"])
    return roofline_percent(n_bytes, kernel_seconds(tr, "k1_kernel")
                            / rec["replays"])
