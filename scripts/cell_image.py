#!/usr/bin/env python3
"""One image of a benchmark cell rendered by the PyTorch + CUDA port of a
checkout, to compare two checkouts bit for bit: the same cell and seed give
the same image wherever the two programs do the same arithmetic.

    python3 scripts/cell_image.py ROOT CELL SEED OUT.npy

ROOT is a checkout of this repository; its ``benchmark/harness.py`` builds
the cell's program, parameters and keys as a benchmark run does. OUT.npy
receives the image (float32). The last line printed is JSON: the cell,
the graph's nodes, the image's mean and SHA-256, whether a second image
at the same keys equals the first, the seconds taken, and what one eager
run of the program's body does in the random stream: the launches of its
kernels (``launches.rng``; null where the port counts none) and the calls
into its int64 tensor code (the Threefry rotation, the (0,2)-sequence's
bit loops, the pixel hash). Card only (exits 3 without one); imports no
JAX. Compare the digests of two runs, or load both files and compare them
bit for bit."""
from __future__ import annotations

import hashlib
import json
import sys
import time
from pathlib import Path

import numpy as np


def main(argv) -> int:
    if len(argv) != 5:
        print(__doc__, file=sys.stderr)
        return 2
    root, cell, out = Path(argv[1]).resolve(), argv[2], argv[4]
    seed = int(argv[3])
    sys.path[:0] = [str(root / "benchmark"), str(root)]
    import torch
    if not torch.cuda.is_available():
        print("cell_image: no CUDA device", file=sys.stderr)
        return 3
    import harness
    t0 = time.perf_counter()
    wl, prog, params = harness.program(harness.Bench(root), cell, "cuda:0")
    words, _ = harness.key_words(seed, wl["passes"])
    keys = harness.key_tensor(words, "cuda:0")
    first = harness.image(prog, params, keys)
    img = harness.image(prog, params, keys)
    np.save(out, img)
    launches, calls = eager_rng(prog, params, keys[0])
    print(json.dumps({
        "root": str(root), "cell": cell, "seed": seed, "nodes": prog.nodes,
        "mean": float(img.mean()),
        "sha256": hashlib.sha256(np.ascontiguousarray(img).tobytes())
        .hexdigest(),
        "repeat_equal": bool(np.array_equal(first.view(np.int32),
                                            img.view(np.int32))),
        "seconds": time.perf_counter() - t0,
        "eager_rng_launches": launches, "eager_tensor_code_calls": calls}),
        flush=True)
    return 0


def eager_rng(prog, params, key):
    """One eager run of the program's body: (the random stream's kernel
    launches, or None where the port has no ``launches.rng``; its tensor
    code's calls by function)."""
    import torch
    from psdr_tpu_torch import profiling
    from psdr_tpu_torch.core import sampler, threefry
    calls = {}
    patched = [(threefry, "_tensor_rotl")] + [
        (sampler, name) for name in ("_lp32", "_bit_reverse32", "_pix_hash")
        if hasattr(sampler, name)]

    def counting(mod, name):
        fn = getattr(mod, name)

        def counted(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kwargs)
        setattr(mod, name, counted)
        return fn
    originals = [counting(mod, name) for mod, name in patched]
    before = profiling.counters().get("launches.rng")
    try:
        with torch.no_grad():
            prog.fn(params, key)
        torch.cuda.synchronize()
    finally:
        for (mod, name), fn in zip(patched, originals):
            setattr(mod, name, fn)
    after = profiling.counters().get("launches.rng")
    return (None if after is None else after - (before or 0)), calls


if __name__ == "__main__":
    sys.exit(main(sys.argv))
