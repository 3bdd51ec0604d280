"""Timing and profiling. Counterpart of ``psdr_tpu/profiling.py``:
``timed`` wall-clocks a block (``.block(x)`` on the yielded handle waits
for the card's work first, so the time includes it; on the CPU there is
nothing to wait for), ``trace`` records a ``torch.profiler`` trace of a
block into a directory (Chrome trace format: open it in ui.perfetto.dev),
``render_timed`` is renderC with the timing print that ``log_level`` turns
on.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch


def _synchronize(x) -> None:
    """Wait for the card if any tensor in ``x`` (a tensor or a nest of
    dicts, lists and tuples) lies on it."""
    stack = [x]
    while stack:
        y = stack.pop()
        if isinstance(y, torch.Tensor):
            if y.is_cuda:
                torch.cuda.synchronize(y.device)
                return
        elif isinstance(y, dict):
            stack.extend(y.values())
        elif isinstance(y, (list, tuple)):
            stack.extend(y)


@contextlib.contextmanager
def timed(label: str, result_holder: dict | None = None, log: bool = True):
    """Wall-clock a block; ``handle.block(x)`` returns ``x`` once the
    device work that produces it is done."""
    t0 = time.perf_counter()

    class Handle:
        elapsed = None

        @staticmethod
        def block(x):
            _synchronize(x)
            return x

    h = Handle()
    try:
        yield h
    finally:
        h.elapsed = time.perf_counter() - t0
        if result_holder is not None:
            result_holder[label] = h.elapsed
        if log:
            print(f"[psdr_tpu_torch] {label}: {h.elapsed * 1e3:.1f} ms",
                  flush=True)


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` trace of the block (host, and the card's kernels
    where there is one), written to ``log_dir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        try:
            yield
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def render_timed(integrator, scene, sensor_id: int = 0, seed: int = 0):
    """renderC with a timing print when ``scene.opts.log_level > 0`` ->
    (image, seconds)."""
    holder: dict = {}
    with timed("renderC", holder, log=scene.opts.log_level > 0) as h:
        img = h.block(integrator.renderC(scene, sensor_id, seed))
    return img, holder["renderC"]
