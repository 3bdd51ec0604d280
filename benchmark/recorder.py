"""The shape of each launch of the kernels whose roofline the benchmark
reports, recorded on one eager run of the cell's program body: while a
``LaunchRecorder`` stands, K1's launch wrapper in the port is wrapped, and
each call's lanes, active lanes and faces are kept, one record a launch.
Where the port has no such wrapper any more, nothing is recorded, the
metrics that read the records read nothing, and the run stops
(``harness.result``)."""
from __future__ import annotations

import importlib

import torch


class LaunchRecorder:
    def __init__(self):
        self.k1: list = []        # (lanes, active lanes, faces)
        self._undo = []
        self._wrap("psdr_tpu_torch.accel.intersect", "k1_cuda", self._k1)

    def _wrap(self, module: str, name: str, make):
        try:
            mod = importlib.import_module(module)
        except ImportError:
            return
        fn = getattr(mod, name, None)
        if fn is None:
            return
        setattr(mod, name, make(fn))
        self._undo.append((mod, name, fn))

    def _k1(self, fn):
        def wrapped(bvh, ray_o, ray_d, active, tmax, *args, **kw):
            if not torch.cuda.is_current_stream_capturing():
                self.k1.append((int(ray_o.shape[0]), int(active.sum()),
                                int(bvh.tri_valid.sum())))
            return fn(bvh, ray_o, ray_d, active, tmax, *args, **kw)
        return wrapped

    def stop(self) -> dict:
        for mod, name, fn in reversed(self._undo):
            setattr(mod, name, fn)
        self._undo = []
        return {"k1": self.k1}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False
