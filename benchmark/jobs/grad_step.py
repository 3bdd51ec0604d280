"""Gradient steps, as an inverse-rendering user runs them: the cell's
scene and integrator (``configs/<config>.py`` ``build``) under the
workload's film, spp, sppe and sppse; the secondary-edge guiding table
built (``guiding``: ``preprocess_secondary_edges`` at its ``reso``,
``nrounds`` and ``seed``, timed as ``guiding_s``); then the port's
``grad_program`` with its boundary terms, the value and gradient of
mean((image - T)^2) with respect to every params leaf, replayed once a
step with a new key drawn from the seed. The params stay fixed: the
update is the trainer's. Each step's loss is read on the host, and a
step fails where the loss or any gradient leaf is not finite.

T, the target (``check.grad_target``), is the reference's image, made
before the port is set up (or read from the checkout's cache): its
seconds (``target_s``) are kept out of ``setup_s``, and the peak of
device memory is read from after it. The check (``check.grad_numbers``):
the mean over the window's steps of the gradient of a translation of
mesh ``grad.mesh`` along ``grad.axes`` (its vertex gradient's rows
summed, on the device, every step) against the reference's finite
differences (``check.fd_gradient``)."""
from __future__ import annotations

import time

import numpy as np

import check
import harness


class GradStep:
    """The job; ``spp``, ``with_boundary`` and ``guided`` depart from the
    cell for the readings that its limit is set from (``calibrate.py``)."""

    def __init__(self, run, spp=None, with_boundary: bool = True,
                 guided: bool = True):
        import torch
        import psdr_tpu_torch as port
        self.run = run
        wl, dev = run.wl, run.device
        g = wl["grad"]
        self.mesh = g["mesh"]
        self.axes = torch.tensor(g["axes"], dtype=torch.float64, device=dev)
        t = time.perf_counter()
        target = check.grad_target(run.bench, run.cell, dev)
        self.excluded_s = time.perf_counter() - t
        if run.on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        w, h = wl["film"]
        spp = wl["spp"] if spp is None else spp
        opts = dict(width=w, height=h, spp=spp, sppe=wl["sppe"],
                    sppse=wl["sppse"])
        scene, integ = run.bench.builder(run.config).build(
            port, harness.scene_data(run.bench, run.cell), opts, dev)
        self.params = harness.device_params(scene.params(), dev)
        self.extra = {"target_s": self.excluded_s}
        gd = wl["guiding"]
        if guided:
            t = time.perf_counter()
            integ.preprocess_secondary_edges(
                scene, 0, reso=tuple(gd["reso"]), nrounds=gd["nrounds"],
                seed=gd["seed"])
            harness.sync(dev)
            self.extra["guiding_s"] = time.perf_counter() - t
        self.prog = integ.grad_program(scene,
                                       torch.as_tensor(target, device=dev),
                                       with_boundary=with_boundary)
        self.reseed(run.seed)
        t = time.perf_counter()
        self.prog(self.params, self.keys[harness.KEYS])
        harness.sync(dev)
        self.capture_s = time.perf_counter() - t
        self.samples_per_step = w * h * (spp + wl["sppe"] + wl["sppse"])
        self.replays_per_step = 1
        self.min_steps = 1

    def reseed(self, seed: int):
        """Keys drawn from ``seed``, and the sum of the window's gradients
        set to 0."""
        import torch
        words, _ = harness.key_words(seed, harness.KEYS + 1)
        self.keys = harness.key_tensor(words, self.run.device)
        self.sum = torch.zeros(len(self.axes), dtype=torch.float64,
                               device=self.run.device)
        self.steps = 0

    def warm(self):
        loss, _ = self.prog(self.params, self.keys[harness.KEYS])
        float(loss)

    def step(self, i: int) -> bool:
        import torch
        from torch.utils._pytree import tree_flatten
        if i >= harness.KEYS:
            raise RuntimeError("the window ran out of keys")
        loss, grads = self.prog(self.params, self.keys[i])
        leaves = [x.reshape(-1) for x in tree_flatten(grads)[0]]
        ok = torch.isfinite(torch.cat([loss.reshape(1)] + leaves)).all()
        vg = grads["meshes"][self.mesh]["vertex_positions"]
        self.sum += self.axes @ vg.sum(0).double()
        self.steps += 1
        float(loss)
        return bool(ok)

    def mean_grad(self) -> np.ndarray:
        """The window's gradient along each axis, averaged over its
        steps."""
        return (self.sum / self.steps).cpu().numpy()

    def body(self):
        import torch
        with torch.enable_grad():
            self.prog.fn(self.params, self.keys[0])

    def close(self):
        self.mean = self.mean_grad()
        del self.prog, self.params, self.keys

    def judge(self) -> dict:
        run = self.run
        return check.grad_numbers(
            self.mean, check.fd_gradient(run.bench, run.cell, run.device))


def setup(run) -> GradStep:
    return GradStep(run)
