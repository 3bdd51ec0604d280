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


@dataclass(frozen=True)
class RenderOptions:
    """Render configuration; field names and defaults as in the JAX
    package. ``log_level`` is carried for the same name and has no effect.
    ``sppe``, ``sppse`` and ``primary_edge_vis_check`` wait for the boundary
    terms (slice 2, second part): ``Scene.build`` raises on ``sppe``/``sppse``
    > 0."""
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
