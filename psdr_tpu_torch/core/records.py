"""Record types flowing between sampling and shading stages.

Counterpart of ``psdr_tpu/core/records.py``: NamedTuples of tensors, and
``RenderOptions`` with the JAX package's field names.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from .frame import Frame


class Ray(NamedTuple):
    o: torch.Tensor      # (..., 3)
    d: torch.Tensor      # (..., 3)

    def at(self, t: torch.Tensor) -> torch.Tensor:
        return self.o + self.d * t[..., None]

    def reversed(self) -> "Ray":
        return Ray(self.o, -self.d)


class Intersection(NamedTuple):
    """Surface interaction. ``J`` is the reparameterization Jacobian (1 in
    a detached render)."""
    valid: torch.Tensor       # (N,) bool
    t: torch.Tensor           # (N,)
    p: torch.Tensor           # (N, 3)
    n: torch.Tensor           # (N, 3) geometric normal
    sh_frame: Frame           # shading frame
    uv: torch.Tensor          # (N, 2)
    wi: torch.Tensor          # (N, 3) incident dir in local (shading) coords
    J: torch.Tensor           # (N,)
    mesh_id: torch.Tensor     # (N,) int32
    tri_id: torch.Tensor      # (N,) int32, global triangle index
    bsdf_id: torch.Tensor     # (N,) int32, -1 for none
    emitter_id: torch.Tensor  # (N,) int32, -1 for none

    def is_emitter(self) -> torch.Tensor:
        return self.emitter_id >= 0


class PositionSample(NamedTuple):
    """A sampled emitter point, with the sampled emitter's index."""
    valid: torch.Tensor
    pdf: torch.Tensor
    p: torch.Tensor       # (..., 3)
    n: torch.Tensor       # (..., 3)
    J: torch.Tensor
    emitter: torch.Tensor  # int32, -1 for none


class BSDFSample(NamedTuple):
    """wo is in local shading coordinates."""
    valid: torch.Tensor
    pdf: torch.Tensor
    wo: torch.Tensor      # (..., 3)


class SensorDirectSample(NamedTuple):
    """Projection of a world point to the sensor."""
    valid: torch.Tensor
    q: torch.Tensor           # (..., 2) sample-plane coords in [0,1)^2
    pixel_idx: torch.Tensor   # (...) int32, -1 if offscreen
    sensor_val: torch.Tensor  # importance W


class PrimaryEdgeSample(NamedTuple):
    """A point on a screen-space silhouette edge."""
    idx: torch.Tensor       # pixel index, -1 invalid
    x_dot_n: torch.Tensor   # normal velocity of the edge point: the only
    #                         output that carries a gradient
    ray_p: Ray              # offset ray on the positive side
    ray_n: Ray              # offset ray on the negative side
    pdf: torch.Tensor
    ray_c: Ray              # center ray toward the edge point (vis check)
    vis_dist: torch.Tensor  # camera -> edge-point distance, margin applied


class BoundarySegSample(NamedTuple):
    """A direct boundary segment: p0 on an edge (differentiable), p2 on an
    emitter; pdf in area measure x direction factor."""
    valid: torch.Tensor
    p0: torch.Tensor     # (..., 3) differentiable edge point
    edge: torch.Tensor   # (..., 3) normalized (detached) edge direction
    edge2: torch.Tensor  # (..., 3) detached: the edge triangle's opposite
    #                      vertex minus the edge's first endpoint
    p2: torch.Tensor     # (..., 3) emitter point (detached)
    n: torch.Tensor      # (..., 3) emitter normal
    pdf: torch.Tensor


def _map_tensors(fn, x):
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_map_tensors(fn, v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_map_tensors(fn, v) for v in x)
    if isinstance(x, dict):
        return {k: _map_tensors(fn, v) for k, v in x.items()}
    return x


def detach_tree(x):
    """``x`` (a tensor, or NamedTuples, tuples, lists and dicts of them)
    with every tensor detached: the JAX package's ``stop_gradient`` of a
    pytree."""
    return _map_tensors(torch.Tensor.detach, x)


def any_requires_grad(x) -> bool:
    """Whether a tensor of ``x`` (a tree as ``detach_tree`` takes)
    requires grad."""
    found = []
    _map_tensors(lambda t: found.append(t.requires_grad), x)
    return any(found)


@dataclass(frozen=True)
class RenderOptions:
    """Render configuration; field names and defaults as in the JAX
    package. ``log_level`` is carried for the same name and has no effect.
    ``sppe`` and ``sppse`` are the samples per pixel of the primary- and
    secondary-edge boundary terms; ``primary_edge_vis_check`` rejects
    primary-edge samples whose edge point is hidden from the camera."""
    width: int = 64
    height: int = 64
    spp: int = 1
    sppe: int = 0
    sppse: int = 0
    log_level: int = 0
    primary_edge_vis_check: bool = False
    # max lanes materialized at once; larger wavefronts run in passes
    pass_lanes: int = 1 << 21
    # checkpoint each pass chunk under autograd: the backward re-runs the
    # chunk's forward instead of keeping its intermediates. "auto" = on
    # when the wavefront has more than remat_lanes lanes
    remat_passes: bool | str = "auto"
    remat_lanes: int = 1 << 23
    stratify_primary: bool = True
    # "sobol" (XOR-scrambled (0,2)-sequence over subpixel + first NEE/BSDF
    # dims) | "stratified" | "independent"
    sampler: str = "sobol"
    # camera-hit prior: a detached pixel-center pre-trace records each
    # pixel's hit triangle, and every camera ray's closest-hit query is
    # bounded by its hit on that candidate. Exact; off by default, as in
    # the JAX package. "auto" = on when spp >= 4
    camera_hit_prior: bool | str = False

    def resolve_remat(self, count: int) -> bool:
        if self.remat_passes == "auto":
            return count > self.remat_lanes
        return bool(self.remat_passes)

    def resolve_camera_prior(self, spp: int) -> bool:
        if self.camera_hit_prior == "auto":
            return spp >= 4
        return bool(self.camera_hit_prior)

    @property
    def num_pixels(self) -> int:
        return self.width * self.height
