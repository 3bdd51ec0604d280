"""Scalar-parameter scene perturbations for AD-vs-FD validation.
Counterpart of ``psdr_tpu/testing/differential.py``: each mode maps a
scalar P (a float, a tensor, or a forward-mode dual tensor) to a perturbed
params tree, so the forward-mode derivative image d(image)/dP can be held
against central finite differences. Modes: ``mesh_transform`` (a rigid
translation), ``mesh_rotate``, ``vertex_transform`` (one vertex moved),
``material_roughness``, ``envmap_rotate``. The params tree holds tensors
(``convert.params_from_numpy``); leaves that P does not touch are shared,
not copied.
"""
from __future__ import annotations

import math

import torch

from ..core.hoist import const


def _scalar(P, like: torch.Tensor) -> torch.Tensor:
    if isinstance(P, torch.Tensor):
        return P.to(device=like.device, dtype=torch.float32)
    return torch.tensor(float(P), device=like.device)


def _vec(v, like: torch.Tensor) -> torch.Tensor:
    """A direction or an axis: a tensor as it is, a literal made once per
    value and device (``hoist.const``: inside a captured derivative it
    must not copy from the host)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=like.device, dtype=torch.float32)
    return const(v, torch.float32, like.device)


def translate(v: torch.Tensor) -> torch.Tensor:
    """4x4 translation by the (3,) tensor ``v``, differentiable in ``v``."""
    eye = torch.eye(4, device=v.device)
    return torch.cat([torch.cat([eye[:3, :3], v[:, None]], dim=1), eye[3:]])


def rotate(axis: torch.Tensor, angle_deg: torch.Tensor) -> torch.Tensor:
    """4x4 rotation about ``axis`` by ``angle_deg`` degrees (the formula of
    ``core.transform.rotate``), differentiable in the angle."""
    axis = axis / torch.clamp(torch.sqrt(torch.sum(axis * axis)), min=1e-20)
    theta = angle_deg * (math.pi / 180.0)
    s, c = torch.sin(theta), torch.cos(theta)
    x, y, z = axis[0], axis[1], axis[2]
    C = 1.0 - c
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    rows = [[x * x * C + c, x * y * C - z * s, x * z * C + y * s, zero],
            [y * x * C + z * s, y * y * C + c, y * z * C - x * s, zero],
            [z * x * C - y * s, z * y * C + x * s, z * z * C + c, zero],
            [zero, zero, zero, one]]
    return torch.stack([torch.stack(r) for r in rows])


def _replace(params: dict, group: str, index: int, entry: dict) -> dict:
    out = dict(params)
    out[group] = list(params[group])
    out[group][index] = entry
    return out


def _per_mesh(params: dict, mesh_index, vecs, update) -> dict:
    """``update(mesh params, vec) -> new to_world`` on one mesh or on each
    of a list of meshes (one vector for all, or one each)."""
    idxs = (list(mesh_index) if isinstance(mesh_index, (list, tuple))
            else [mesh_index])
    vecs = (list(vecs) if isinstance(vecs[0], (list, tuple))
            else [vecs] * len(idxs))
    out = params
    for i, v in zip(idxs, vecs):
        new = dict(out["meshes"][i])
        new["to_world"] = update(new, _vec(v, new["to_world"]))
        out = _replace(out, "meshes", i, new)
    return out


def mesh_transform(params: dict, P, *, mesh_index=0,
                   direction=(1.0, 0.0, 0.0)) -> dict:
    return _per_mesh(params, mesh_index, direction,
                     lambda m, d: translate(d * _scalar(P, d))
                     @ m["to_world"])


def mesh_rotate(params: dict, P, *, mesh_index=0,
                axis=(0.0, 1.0, 0.0)) -> dict:
    # the axis direction carries the sign; rotate normalizes its length
    return _per_mesh(params, mesh_index, axis,
                     lambda m, a: rotate(a, _scalar(P, a)) @ m["to_world"])


def vertex_transform(params: dict, P, *, mesh_index: int = 0,
                     vertex_index: int = 0,
                     direction=(0.0, 1.0, 0.0)) -> dict:
    m = params["meshes"][mesh_index]
    vp = m["vertex_positions"]
    d = _vec(direction, vp) * _scalar(P, vp)
    onehot = torch.zeros((vp.shape[0], 1), device=vp.device)
    onehot[vertex_index] = 1.0
    return _replace(params, "meshes", mesh_index,
                    dict(m, vertex_positions=vp + onehot * d))


def material_roughness(params: dict, P, *, bsdf_index: int = 0) -> dict:
    b = params["bsdfs"][bsdf_index]
    p = _scalar(P, b["alpha_u"])
    return _replace(params, "bsdfs", bsdf_index,
                    dict(b, alpha_u=b["alpha_u"] + p,
                         alpha_v=b["alpha_v"] + p))


def envmap_rotate(params: dict, P, *, emitter_index: int = 0,
                  axis=(0.0, 1.0, 0.0)) -> dict:
    e = params["emitters"][emitter_index]
    a = _vec(axis, e["to_world"])
    return _replace(params, "emitters", emitter_index,
                    dict(e, to_world=rotate(a, _scalar(P, a))
                         @ e["to_world"]))


PERTURBATIONS = {
    "mesh_transform": mesh_transform,
    "mesh_rotate": mesh_rotate,
    "vertex_transform": vertex_transform,
    "material_roughness": material_roughness,
    "envmap_rotate": envmap_rotate,
}


def apply_perturbation(kind: str, params: dict, P, **kwargs) -> dict:
    return PERTURBATIONS[kind](params, P, **kwargs)
