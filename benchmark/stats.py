"""Whole-window arithmetic: every end-to-end number is taken over all the
steps and all the time of the measured window, never from chunks."""
from __future__ import annotations


def rate(steps: int, per_step: float, window_s: float) -> float:
    """Work completed per second: ``steps`` x ``per_step`` over the
    window's seconds."""
    if window_s <= 0:
        raise ValueError("the window has no length")
    return steps * per_step / window_s


def merged(intervals) -> list:
    """``intervals`` [(start, end), ...] merged where they overlap or
    touch, in order: their union, each instant counted once."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def idle_share(busy_s: float, window_s: float) -> float:
    """Percent of the window in which nothing ran on the device."""
    return 100.0 * (1.0 - busy_s / window_s)
