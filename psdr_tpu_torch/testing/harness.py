"""AD-vs-FD validation harness. Counterpart of
``psdr_tpu/testing/harness.py``:

* ``run_orig``: the npass-averaged forward render;
* ``run_ad``: the forward-mode derivative image d(image)/dP at P = 0
  (``torch.autograd.forward_ad``) through the scene build and
  ``render_fn(with_boundary=True)``: the interior and the boundary terms,
  optionally after the secondary-edge guiding preprocess;
* ``run_fd``: central finite differences of two renders at P = +-eps with
  common random numbers (the same key on both sides).

Derivative images are the correctness standard of a differentiable
renderer: the AD and FD images must agree. All three return (H, W, 3)
numpy arrays and run on the scene's device, each render through a
``Program`` (captured once on the card and replayed with the key on the
device, as the JAX package jits them): ``run_orig``'s and ``run_fd``'s the
forward render, ``run_ad``'s the forward-mode derivative image.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from ..convert import params_from_numpy
from ..core import threefry
from ..program import Program
from .differential import apply_perturbation


def _image(scene, acc, npass: int) -> np.ndarray:
    return (acc / npass).cpu().numpy().reshape(scene.opts.height,
                                               scene.opts.width, 3)


def run_orig(scene, integrator, npass: int = 1,
             sensor_id: int = 0) -> np.ndarray:
    """npass-averaged forward render -> (H, W, 3), through one
    ``Program`` (captured once on the card, as the JAX package jits it)."""
    render = Program(integrator.render_fn(scene, sensor_id,
                                          with_boundary=False), "run_orig",
                     retrace_on=lambda: scene.accel_version)
    params = params_from_numpy(scene.params(), device=scene.device)
    acc = 0.0
    for i in range(npass):
        acc = acc + render(params, threefry.PRNGKey(i, device=scene.device))
    return _image(scene, acc, npass)


def run_ad(scene, integrator, perturbation: str, npass: int = 1,
           sensor_id: int = 0, guiding: Optional[tuple] = None,
           seed0: int = 1000, **pkwargs) -> np.ndarray:
    """Forward-mode derivative image d(image)/dP at P = 0 -> (H, W, 3).
    ``guiding``: optional (reso, nrounds) for the secondary-edge guiding
    table, built first. The derivative image of a key is one ``Program``
    (the JAX package's jitted ``jvp``), the dual level opened inside it;
    no reverse graph is kept (``no_grad`` leaves the forward-mode tangents
    on)."""
    if guiding is not None and hasattr(integrator,
                                       "preprocess_secondary_edges"):
        integrator.preprocess_secondary_edges(scene, sensor_id, guiding[0],
                                              guiding[1])
    render = integrator.render_fn(scene, sensor_id, with_boundary=True)
    base = params_from_numpy(scene.params(), device=scene.device)

    def deriv(key):
        zero = torch.zeros((), device=key.device)
        with fwAD.dual_level():
            P = fwAD.make_dual(zero, torch.ones_like(zero))
            img = render(apply_perturbation(perturbation, base, P, **pkwargs),
                         key)
            tangent = fwAD.unpack_dual(img).tangent
        return torch.zeros_like(img) if tangent is None else tangent

    prog = Program(deriv, "run_ad", retrace_on=lambda: scene.accel_version)
    acc = 0.0
    for i in range(npass):
        acc = acc + prog(threefry.PRNGKey(seed0 + i, device=scene.device))
    return _image(scene, acc, npass)


def run_fd(scene, integrator, perturbation: str, eps: float = 0.01,
           npass: int = 8, sensor_id: int = 0, seed0: int = 0,
           **pkwargs) -> np.ndarray:
    """Central-difference derivative image -> (H, W, 3), the same key at
    +eps and -eps in each pass; both renders through one ``Program`` (the
    perturbed params are its arguments)."""
    render = Program(integrator.render_fn(scene, sensor_id,
                                          with_boundary=False), "run_fd",
                     retrace_on=lambda: scene.accel_version)
    base = params_from_numpy(scene.params(), device=scene.device)
    acc = 0.0
    with torch.no_grad():
        for i in range(npass):
            key = threefry.PRNGKey(seed0 + i, device=scene.device)
            hi = render(apply_perturbation(perturbation, base, +eps,
                                           **pkwargs), key)
            lo = render(apply_perturbation(perturbation, base, -eps,
                                           **pkwargs), key)
            acc = acc + (hi - lo) / (2.0 * eps)
    return _image(scene, acc, npass)
