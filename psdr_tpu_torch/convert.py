"""Carry scene parameters across from the JAX package.

``psdr_tpu``'s ``Scene.params()`` is a pytree of dicts and lists whose
leaves are numpy arrays (or anything ``numpy.asarray`` takes);
``params_from_numpy`` returns the same tree with float32 tensors on
``device``, which this package's ``Scene.build`` and ``render_fn`` take;
``requires_grad=True`` makes every leaf a fresh autograd leaf, so a
backward fills its ``.grad``.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, device="cuda", requires_grad: bool = False):
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, requires_grad)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device, requires_grad)
                          for v in tree)
    return torch.tensor(np.asarray(tree, np.float32), device=device,
                        requires_grad=requires_grad)
