"""Carry scene parameters and sampling tables across from the JAX package.

``psdr_tpu``'s ``Scene.params()`` is a pytree of dicts and lists whose
leaves are numpy arrays (or anything ``numpy.asarray`` takes);
``params_from_numpy`` returns the same tree with float32 tensors on
``device``, which this package's ``Scene.build`` and ``render_fn`` take;
``requires_grad=True`` makes every leaf a fresh autograd leaf, so a
backward fills its ``.grad``.

Sampling tables are state, not parameters: ``discrete_from_numpy`` and
``hypercube_from_numpy`` rebuild a ``Discrete`` or a guiding ``HyperCube``
from the other package's arrays. Given its ``cmf`` too, the table is that
cmf bit for bit (two cumulative sums of one pmf may round apart in the last
place, and a sample that falls between the two values would pick another
entry); without it the cmf is summed here. ``envmap_state_from_numpy``
hands a scene the other package's environment-map table
(``FlatScene.envmap.cell_distrb.distrb``), which every later build then
samples.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.distribution import (Discrete, HyperCube, discrete_init,
                                hypercube_init)


def params_from_numpy(tree, device="cuda", requires_grad: bool = False):
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, requires_grad)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device, requires_grad)
                          for v in tree)
    if isinstance(tree, torch.Tensor):     # a leaf set from a tensor
        return tree.detach().to(device=device, dtype=torch.float32,
                                copy=True).requires_grad_(requires_grad)
    return torch.tensor(np.asarray(tree, np.float32), device=device,
                        requires_grad=requires_grad)


def adam_state_from_numpy(opt, mu, nu, count) -> None:
    """Carry an optax Adam state into ``opt`` (an ``opt.Optimizer``), so a
    run begun in the JAX package continues here step for step: ``mu`` and
    ``nu`` are the moments of the selected leaves as numpy arrays in the
    params tree's order (``jax.tree.leaves`` of the masked state, which
    leaves the frozen leaves out), ``count`` the steps taken."""
    paths = [path for path, _ in opt.trainable()]
    if len(mu) != len(paths) or len(nu) != len(paths):
        raise ValueError(f"{len(paths)} selected leaves, {len(mu)} / "
                         f"{len(nu)} moments")
    dev = opt.scene.device
    for path, m, v in zip(paths, mu, nu):
        shape = tuple(opt.state["mu"][path].shape)
        if np.shape(m) != shape or np.shape(v) != shape:
            raise ValueError(f"{path}: moments of shape {np.shape(m)} / "
                             f"{np.shape(v)}, the leaf {shape}")
        opt.state["mu"][path] = torch.tensor(np.asarray(m, np.float32),
                                             device=dev)
        opt.state["nu"][path] = torch.tensor(np.asarray(v, np.float32),
                                             device=dev)
    opt.state["count"] = torch.tensor(int(count), dtype=torch.int32,
                                      device=dev)


def discrete_from_numpy(pmf, cmf=None, device="cuda") -> Discrete:
    pmf = torch.tensor(np.asarray(pmf, np.float32), device=device)
    if cmf is None:
        return discrete_init(pmf)
    cmf = torch.tensor(np.asarray(cmf, np.float32), device=device)
    return Discrete(pmf=pmf, cmf=cmf, total=cmf[-1])


def hypercube_from_numpy(resolution, pmf, cmf=None,
                         device="cuda") -> HyperCube:
    """A ``HyperCube`` over ``resolution`` with the cell masses ``pmf`` (as
    ``hypercube_set_mass`` left them in the other package: its
    ``distrb.pmf``) and optionally its ``distrb.cmf``."""
    d = discrete_from_numpy(pmf, cmf, device)
    return hypercube_init(resolution, d.pmf)._replace(distrb=d)


def envmap_state_from_numpy(scene, pmf, cmf=None) -> None:
    """Make ``scene``'s environment map sample the importance table
    ``pmf`` / ``cmf`` (the other package's
    ``flat.envmap.cell_distrb.distrb``) in every build from now on, on the
    scene's device. The grid must be the one ``configure_envmap`` chooses
    here; ``Scene.build`` checks the cell count."""
    scene.envmap_distrb = discrete_from_numpy(pmf, cmf, scene.device)
    scene._flat_cache = None
