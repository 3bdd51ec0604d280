"""Lambertian BSDF. Counterpart of ``psdr_tpu/bsdf/diffuse.py``: eval
includes the outgoing cosine; pdf uses detached directions."""
from __future__ import annotations

import torch

from ..core import warp
from ..core.bitmap import Bitmap, constant, eval_bitmap
from ..core.constants import InvPi
from ..core.frame import cos_theta
from ..core.records import BSDFSample, Intersection


class Diffuse:
    kind = "diffuse"

    def __init__(self, reflectance, bsdf_id: str = ""):
        if not isinstance(reflectance, Bitmap):
            reflectance = constant(reflectance, 3)
        self.reflectance = reflectance
        self.id = bsdf_id

    def params(self) -> dict:
        return {"reflectance": self.reflectance.data}

    def set_params(self, p: dict) -> None:
        self.reflectance = Bitmap(p["reflectance"])

    def __repr__(self):
        return f"Diffuse[id={self.id}]"


def eval_diffuse(params: dict, its: Intersection, wo: torch.Tensor,
                 active: torch.Tensor) -> torch.Tensor:
    cti = cos_theta(its.wi)
    cto = cos_theta(wo)
    active = active & (cti > 0.0) & (cto > 0.0)
    value = (eval_bitmap(Bitmap(params["reflectance"]), its.uv)
             * (InvPi * cto)[..., None])
    return torch.where(active[..., None], value, torch.zeros_like(value))


def sample_diffuse(params: dict, its: Intersection, sample3: torch.Tensor,
                   active: torch.Tensor) -> BSDFSample:
    cti = cos_theta(its.wi)
    # dims 0:2, so the first-bounce stratification applies to every bsdf
    wo = warp.square_to_cosine_hemisphere(sample3[..., 0:2])
    pdf = warp.square_to_cosine_hemisphere_pdf(wo)
    return BSDFSample(valid=active & (cti > 0.0), pdf=pdf, wo=wo)


def pdf_diffuse(params: dict, its: Intersection, wo: torch.Tensor,
                active: torch.Tensor) -> torch.Tensor:
    cti = cos_theta(its.wi).detach()
    cto = cos_theta(wo).detach()
    active = active & (cti > 0.0) & (cto > 0.0)
    return torch.where(active, InvPi * cto, torch.zeros_like(cto))
