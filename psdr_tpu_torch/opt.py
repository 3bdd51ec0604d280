"""Inverse-rendering optimization: masked Adam over the scene's params.

Counterpart of ``psdr_tpu/opt.py``. Leaves are chosen by ``param_map``
paths ("BSDF[id=white].reflectance", "Mesh[0].vertex_positions", or a whole
object, "Mesh[1]"). The JAX package chains optax's ``adam`` on the chosen
leaves with ``set_to_zero`` on the others; here the same update is written
out in tensor code, in optax's order of operations (``eps_root`` 0):

    mu <- b1 mu + (1 - b1) g;   nu <- b2 nu + (1 - b2) g^2
    p  <- p - lr (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)

(``torch.optim.Adam`` rounds differently: ``sqrt(nu) / sqrt(1 - b2^t)``
and a step of ``lr / (1 - b1^t)``.) Frozen leaves get no update and keep
zero moments, as under ``set_to_zero``. The step count is a 0-dim int32
tensor on the params' device, as optax's is an int32 array: the bias
corrections and a schedule's rate are float32 tensor code on that count,
so an update reads nothing back to the host and runs as a captured
program (``Optimizer._jit_update``, the JAX package's jitted
``Optimizer._update``).

The sharded steps (``parallel/sharding.py``) and the examples take a few of
optax's functional transforms, each an ``(init, update)`` pair over a whole
params tree with ``update(grads, state, params) -> (updates, state)`` and
``apply_updates(params, updates)``: ``adam`` (a constant rate or a schedule
such as ``exponential_decay``), ``sgd`` and ``masked`` (another transform's
updates times a mask, entry by entry).
"""
from __future__ import annotations

from typing import Callable, Iterable, NamedTuple

import numpy as np
import torch

from .convert import params_from_numpy
from .core.hoist import const
from .program import Program
from .scene.scene import Scene, _host_tree

_GROUP_OF = {"Mesh": "meshes", "BSDF": "bsdfs", "Emitter": "emitters",
             "Sensor": "sensors"}
GROUPS = ("meshes", "bsdfs", "emitters", "sensors")


def resolve_param_path(scene: Scene, path: str):
    """'BSDF[id=white].reflectance' -> ('bsdfs', index, 'reflectance'); a
    path without a leaf gives None in its place."""
    key, _, leaf = path.partition(".")
    if key not in scene.param_map:
        raise KeyError(f"Unknown param_map key '{key}' "
                       f"(have: {sorted(scene.param_map)})")
    obj = scene.param_map[key]
    group = _GROUP_OF[key.split("[")[0]]
    index = next(i for i, o in enumerate(getattr(scene, group)) if o is obj)
    if leaf:
        if leaf not in obj.params():
            raise KeyError(f"'{key}' has no parameter '{leaf}' "
                           f"(have: {sorted(obj.params())})")
        return group, index, leaf
    return group, index, None


def param_mask(scene: Scene, paths: Iterable[str]) -> dict:
    """Boolean mask tree: True on the leaves ``paths`` select."""
    selected = [resolve_param_path(scene, p) for p in paths]
    params = scene.params()

    def mask_leaf(group, index, name):
        return any(g == group and i == index and (lf is None or lf == name)
                   for g, i, lf in selected)

    return {group: [{name: mask_leaf(group, i, name) for name in entry}
                    for i, entry in enumerate(params[group])]
            for group in params}


def leaf_items(tree):
    """((group, index, name), leaf) over a params tree, in the order of
    ``jax.tree.flatten`` (dict keys sorted, lists in order)."""
    for group in sorted(tree):
        for i, entry in enumerate(tree[group]):
            for name in sorted(entry):
                yield (group, i, name), entry[name]


def new_count(device) -> torch.Tensor:
    """A step count of 0: a 0-dim int32 tensor on ``device``."""
    return torch.zeros((), dtype=torch.int32, device=device)


def _adam_direction(g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                    count, b1: float, b2: float, eps: float):
    """optax's ``scale_by_adam`` after ``count`` earlier steps (a 0-dim
    integer tensor on g's device, or an int): the bias-corrected direction
    and the new (mu, nu)."""
    with torch.no_grad():
        t = (torch.as_tensor(count, device=g.device) + 1).to(torch.float32)
        # optax's bias corrections: float32 powers of the float32 betas;
        # tensors on g's device, as divisors (CUDA divides by a host scalar
        # as a product with its reciprocal)
        c1 = 1.0 - torch.pow(const(b1, torch.float32, g.device), t)
        c2 = 1.0 - torch.pow(const(b2, torch.float32, g.device), t)
        mu = (1.0 - b1) * g + b1 * mu
        nu = (1.0 - b2) * (g * g) + b2 * nu
        return (mu / c1) / (torch.sqrt(nu / c2) + eps), mu, nu


def adam_update(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
                nu: torch.Tensor, count, lr: float, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-8):
    """One Adam step of ``p`` in place, in optax's arithmetic, after
    ``count`` earlier steps (an int or a 0-dim integer tensor). Returns
    the new (mu, nu)."""
    direction, mu, nu = _adam_direction(g, mu, nu, count, b1, b2, eps)
    with torch.no_grad():
        p.sub_(lr * direction)
    return mu, nu


# -- functional transforms ----------------------------------------------------

class GradientTransformation(NamedTuple):
    """optax's pair: ``init(params) -> state`` and ``update(grads, state,
    params=None) -> (updates, state)``."""
    init: Callable
    update: Callable


def tree_map(fn, *trees):
    """``fn`` over the leaves of params-shaped trees (dicts and lists)."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The leaves of a params-shaped tree, in ``tree_map``'s order."""
    out = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(like, leaves):
    """A tree shaped as ``like`` holding ``leaves`` in ``tree_leaves``
    order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def apply_updates(params, updates):
    """``optax.apply_updates``: params + updates, leaf by leaf."""
    return tree_map(lambda p, u: (p + u).detach(), params, updates)


def sgd(learning_rate: float) -> GradientTransformation:
    """``optax.sgd(learning_rate)``: the update is -lr g."""
    def update(grads, state, params=None):
        return tree_map(lambda g: g * (-learning_rate), grads), state
    return GradientTransformation(lambda params: {}, update)


def adam(learning_rate, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> GradientTransformation:
    """``optax.adam``: ``learning_rate`` a number or a schedule ``count ->
    rate``, read at the count of earlier updates (a 0-dim int32 tensor on
    the params' device, ``state["count"]``)."""
    def init(params):
        return {"count": new_count(tree_leaves(params)[0].device),
                "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    def update(grads, state, params=None):
        t = state["count"]
        out = [_adam_direction(g, m, v, t, b1, b2, eps) for g, m, v in zip(
            *(tree_leaves(x) for x in (grads, state["mu"], state["nu"])))]
        rate = learning_rate(t) if callable(learning_rate) else learning_rate
        return (tree_unflatten(grads, [d * (-rate) for d, _, _ in out]),
                {"count": t + 1,
                 "mu": tree_unflatten(grads, [m for _, m, _ in out]),
                 "nu": tree_unflatten(grads, [v for _, _, v in out])})
    return GradientTransformation(init, update)


def exponential_decay(init_value: float, transition_steps: int,
                      decay_rate: float) -> Callable:
    """``optax.exponential_decay`` (no staircase, no delay):
    ``count -> init_value * decay_rate ** (count / transition_steps)`` in
    float32 tensor code, a 0-dim tensor on the count's device (an int
    count: on the CPU)."""
    def schedule(count) -> torch.Tensor:
        count = torch.as_tensor(count)
        dev = count.device

        def f32(v):
            return const(v, torch.float32, dev)
        p = count.to(torch.float32) / f32(transition_steps)
        return f32(init_value) * torch.pow(f32(decay_rate), p)
    return schedule


def masked(inner: GradientTransformation, mask) -> GradientTransformation:
    """``inner``'s updates times ``mask`` (a params-shaped tree of 0/1
    tensors or numbers) entry by entry: the entrywise mask the examples
    chain after Adam."""
    def update(grads, state, params=None):
        updates, state = inner.update(grads, state, params)
        return tree_map(lambda u, m: u * m, updates, mask), state
    return GradientTransformation(inner.init, update)


class Optimizer:
    """Adam over selected scene parameters.

    >>> opt = Optimizer(scene, ["BSDF[id=white].reflectance"], lr=2e-2)
    >>> loss = opt.step(loss_fn)     # loss_fn(params, *args) -> scalar

    ``params`` is the scene's params tree as float32 tensors on the scene's
    device; ``step`` differentiates ``loss_fn`` with respect to the selected
    leaves only (the others carry no graph), eagerly as the JAX package's
    ``step`` does, and updates them in place through ``_jit_update``, the
    Adam update as a ``Program`` (captured on the card). ``state`` holds
    the step count (a 0-dim int32 tensor) and the moments of the selected
    leaves.
    """

    def __init__(self, scene: Scene, paths: Iterable[str], lr: float = 1e-2,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.scene = scene
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mask = param_mask(scene, paths)
        self.params = params_from_numpy(scene.params(), scene.device)
        self.state = self._fresh_state()
        self._jit_update = Program(self._update, "Optimizer._jit_update")

    def _fresh_state(self) -> dict:
        mu, nu = {}, {}
        for path, leaf in self.trainable():
            mu[path] = torch.zeros_like(leaf)
            nu[path] = torch.zeros_like(leaf)
        return {"count": new_count(self.scene.device), "mu": mu, "nu": nu}

    def trainable(self):
        """((group, index, name), leaf) of the selected leaves."""
        return [(path, leaf) for path, leaf in leaf_items(self.params)
                if self.mask[path[0]][path[1]][path[2]]]

    def _update(self, leaves, grads, mu, nu, count):
        """The body of ``_jit_update``: one Adam step of the selected
        ``leaves`` -> (new leaves, mu, nu, count + 1)."""
        out = [_adam_direction(g, m, v, count, self.b1, self.b2, self.eps)
               for g, m, v in zip(grads, mu, nu)]
        return ([p - self.lr * d for p, (d, _, _) in zip(leaves, out)],
                [m for _, m, _ in out], [v for _, _, v in out], count + 1)

    def update(self, grads: dict) -> None:
        """One Adam update of the selected leaves from ``grads``, keyed
        like ``trainable()``'s paths (a missing gradient counts as 0),
        through ``_jit_update``; the leaves are updated in place."""
        paths, leaves = zip(*self.trainable())
        g = [grads.get(p) for p in paths]
        new, mu, nu, count = self._jit_update(
            list(leaves),
            [torch.zeros_like(x) if gi is None else gi
             for x, gi in zip(leaves, g)],
            [self.state["mu"][p] for p in paths],
            [self.state["nu"][p] for p in paths], self.state["count"])
        with torch.no_grad():
            for leaf, x in zip(leaves, new):
                leaf.copy_(x)
        self.state = {"count": count, "mu": dict(zip(paths, mu)),
                      "nu": dict(zip(paths, nu))}

    def step(self, loss_fn: Callable, *args) -> float:
        """Differentiate ``loss_fn(params, *args)`` with respect to the
        selected leaves and take one Adam step. Returns the loss."""
        group_of = {}
        live = {g: [dict(e) for e in self.params[g]] for g in GROUPS}
        for path, leaf in self.trainable():
            v = leaf.detach().requires_grad_(True)
            live[path[0]][path[1]][path[2]] = v
            group_of[path] = v
        loss = loss_fn(live, *args)
        keys = list(group_of)
        grads = torch.autograd.grad(loss, [group_of[k] for k in keys],
                                    allow_unused=True)
        self.update({k: g for k, g in zip(keys, grads) if g is not None})
        return float(loss.detach())

    def maybe_rebuild_accel(self, threshold: float = 1.5) -> bool:
        """Re-sort the BVH topology if geometry optimization has degraded
        the frozen Morton order (``Scene.refit_quality``). Each call costs
        a scene build and a host Morton sort (on the 20,492-face bench
        scene about a quarter of a 256 x 256, spp 16 boundary step on an
        NVIDIA H100): call it every ~10 steps when optimizing vertex
        positions."""
        return self.scene.maybe_rebuild_accel(self.params,
                                              threshold=threshold)

    def write_back(self) -> None:
        """Push the optimized parameters into the host scene objects."""
        self.scene.set_params(_host_tree(self.params))

    # -- checkpoint / resume -----------------------------------------------
    def save(self, path: str) -> None:
        """Params and optimizer state to one .npz file."""
        arrays = {"count": np.int64(int(self.state["count"]))}
        for (g, i, n), leaf in leaf_items(self.params):
            arrays[f"param/{g}/{i}/{n}"] = leaf.detach().cpu().numpy()
        for key in ("mu", "nu"):
            for (g, i, n), v in self.state[key].items():
                arrays[f"{key}/{g}/{i}/{n}"] = v.cpu().numpy()
        np.savez(path, **arrays)

    def load(self, path: str) -> None:
        """Resume from a file ``save`` wrote for the same scene and
        selection."""
        data = np.load(path)
        dev = self.scene.device
        for (g, i, n), leaf in leaf_items(self.params):
            key = f"param/{g}/{i}/{n}"
            if key not in data or data[key].shape != tuple(leaf.shape):
                raise ValueError(f"checkpoint does not match: {key}")
            self.params[g][i][n] = torch.tensor(data[key], device=dev)
        state = self._fresh_state()
        for key in ("mu", "nu"):
            for g, i, n in state[key]:
                state[key][(g, i, n)] = torch.tensor(
                    data[f"{key}/{g}/{i}/{n}"], device=dev)
        state["count"] = torch.tensor(int(data["count"]), dtype=torch.int32,
                                      device=dev)
        self.state = state


