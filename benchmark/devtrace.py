"""The device's work in a ``torch.profiler`` trace of the measured window,
read from the profiler's raw events (``key_averages()`` would first build
the host's event tree, which takes far longer than the window on a trace
of a million kernels).

``summarize(prof, window_s)`` returns a dict:
* ``kernels``: {device operation name: [launches, device seconds]};
* ``busy_s``: the union of the device operations' intervals, overlaps
  counted once; ``window_s``: the host-clock length of the window;
* ``idle_gaps``: [[what the host was doing, seconds]], the gaps between
  device operations summed by the innermost host event that covers each
  gap's middle (gaps under ``SHORT_GAP_S`` together as one entry);
* ``device_ops``: the ten device operations with the most time."""
from __future__ import annotations

import bisect

from stats import merged

SHORT_GAP_S = 20e-6
NAME_CHARS = 120


def _events(prof):
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        s, d = e.start_ns(), e.duration_ns()
        if e.is_user_annotation():
            continue        # a host span mirrored on the device's timeline
        if str(e.device_type()).endswith("CUDA"):
            dev.append((s, s + d, e.name()))
        elif d > 0:
            host.append((s, s + d, e.name()))
    return dev, host


def _label(host, starts, t):
    """The innermost host event that covers time ``t``."""
    best = None
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 4000), -1):
        s, e, name = host[j]
        if e >= t and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return best[2] if best else "no host event"


def summarize(prof, window_s: float) -> dict:
    dev, host = _events(prof)
    kernels = {}
    for s, e, name in dev:
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += (e - s) * 1e-9
    spans = merged((s, e) for s, e, _ in dev)
    busy_s = sum(e - s for s, e in spans) * 1e-9
    host.sort()
    starts = [h[0] for h in host]
    gaps = {}
    for (_, e0), (s1, _) in zip(spans, spans[1:]):
        g = (s1 - e0) * 1e-9
        name = (f"gaps under {SHORT_GAP_S * 1e6:g} us" if g < SHORT_GAP_S
                else _label(host, starts, (e0 + s1) // 2))
        gaps[name[:NAME_CHARS]] = gaps.get(name[:NAME_CHARS], 0.0) + g
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    return {
        "kernels": kernels,
        "busy_s": busy_s,
        "window_s": window_s,
        "device_ops": [[k[:NAME_CHARS], v[1]] for k, v in top],
        "idle_gaps": sorted(([k, v] for k, v in gaps.items()),
                            key=lambda kv: -kv[1])[:10],
    }


def kernel_seconds(summary: dict, fragment: str) -> float:
    """Device seconds of the operations whose name holds ``fragment``."""
    return sum(v[1] for k, v in summary["kernels"].items() if fragment in k)
