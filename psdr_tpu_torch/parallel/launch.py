"""Run a function on the ranks of a process group, one process a rank.

``run_ranks(fn, world, backend, args)`` starts ``world`` processes (the
``spawn`` method: fresh interpreters that import only this package and what
``fn``'s module imports), joins them into a ``torch.distributed`` group over
``tcp://localhost:<free port>`` and returns each rank's ``fn(*args)`` in
rank order. Every wait has a deadline: a rank that dies, raises or hangs
fails the call, and no process outlives it. The gloo backend takes CPU
tensors and CUDA tensors (through the host), so several ranks may share one
card; NCCL needs a card a rank. Under ``torchrun``, which starts the
processes itself, call ``initialize_distributed`` instead.
"""
from __future__ import annotations

import multiprocessing
import queue as queue_mod
import socket
import time
import traceback

import torch

from .sharding import initialize_distributed


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, backend, port, args, threads, results):
    import torch.distributed as dist
    torch.set_num_threads(threads)
    try:
        initialize_distributed(backend, f"tcp://localhost:{port}", world,
                               rank)
        try:
            results.put((rank, True, fn(*args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn, world: int, backend: str = "gloo", args=(),
              timeout: float = 600.0, threads: int = 1) -> list:
    """``fn(*args)`` on each of ``world`` ranks; the results by rank.
    ``fn`` and its results must pickle (a module-level function; numpy
    arrays). Raises if a rank fails or the deadline ``timeout`` (seconds)
    passes."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, backend, port, args, threads,
                               results), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    out, errors = {}, []
    try:
        # drain the queue before joining: a child blocks until it is read
        while len(out) + len(errors) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{world - len(out)} of {world} ranks gave "
                                   f"no result in {timeout:.0f} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 5.0))
            except queue_mod.Empty:
                dead = [p.exitcode for p in procs
                        if not p.is_alive() and p.exitcode != 0]
                if dead and results.empty():
                    raise RuntimeError(f"a rank exited with {dead[0]} and no "
                                       "result")
                continue
            if ok:
                out[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
        if errors:
            raise RuntimeError("\n".join(errors))
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
            if p.is_alive() or p.exitcode != 0:
                raise RuntimeError(f"a rank did not exit cleanly "
                                   f"({p.exitcode})")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    return [out[r] for r in range(world)]
