"""Seconds of the first call of the cell's programs (warm-up, capture and
the first replay, ending in a synchronize), host clock around each."""


def read(rec):
    return rec.get("capture_s")
