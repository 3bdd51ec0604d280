"""Samples rendered per second: images completed in the window x width x
height x spp x passes over the window's seconds (host clock)."""
from stats import rate


def read(rec):
    if rec["kind"] != "forward":
        return None
    return rate(rec["steps"], rec["samples_per_step"], rec["window_s"])
