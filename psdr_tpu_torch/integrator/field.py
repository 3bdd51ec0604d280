"""AOV (field-extraction) integrator: silhouette, position, depth,
geoNormal, shNormal, uv at the camera hit. Counterpart of
``psdr_tpu/integrator/field.py``."""
from __future__ import annotations

import torch

from ..scene.scene import ray_intersect_with_prior
from .base import Integrator

_FIELDS = ("silhouette", "position", "depth", "geoNormal", "shNormal", "uv")


class FieldExtractionIntegrator(Integrator):
    def __init__(self, field: str):
        if field not in _FIELDS:
            raise ValueError(f"Unsupported field: {field}")
        self.field = field

    def Li(self, scene, flat, rng, ray, active, prior=None):
        its = ray_intersect_with_prior(flat, ray, active, prior)
        f = self.field
        if f == "silhouette":
            result = torch.ones_like(its.p)
        elif f == "position":
            result = its.p
        elif f == "depth":
            result = its.t[..., None].expand(its.p.shape)
        elif f == "geoNormal":
            result = its.n
        elif f == "shNormal":
            result = its.sh_frame.n
        else:  # uv
            result = torch.cat([its.uv, torch.zeros_like(its.uv[..., :1])],
                               dim=-1)
        mask = active & its.valid
        return torch.where(mask[..., None], result, 0.0)
