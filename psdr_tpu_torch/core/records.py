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
    package. ``log_level``, ``remat_passes`` and ``remat_lanes`` are carried
    for the same names and have no effect on a forward render. ``sppe``,
    ``sppse``, ``primary_edge_vis_check`` and ``camera_hit_prior`` wait for
    slice 2 (boundary terms and the backward): ``Scene.build`` raises on
    ``sppe``/``sppse`` > 0 and ``render_interior`` on the prior."""
    width: int = 64
    height: int = 64
    spp: int = 1
    sppe: int = 0
    sppse: int = 0
    log_level: int = 0
    primary_edge_vis_check: bool = False
    # max lanes materialized at once; larger wavefronts run in passes
    pass_lanes: int = 1 << 21
    remat_passes: bool | str = "auto"
    remat_lanes: int = 1 << 23
    stratify_primary: bool = True
    # "sobol" (XOR-scrambled (0,2)-sequence over subpixel + first NEE/BSDF
    # dims) | "stratified" | "independent"
    sampler: str = "sobol"
    camera_hit_prior: bool | str = False

    @property
    def num_pixels(self) -> int:
        return self.width * self.height
