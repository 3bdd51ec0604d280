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
    return torch.tensor(np.asarray(tree, np.float32), device=device,
                        requires_grad=requires_grad)


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
