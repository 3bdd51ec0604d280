"""Textured rough-conductor (microfacet) BSDF with complex-IOR Fresnel.
Counterpart of ``psdr_tpu/bsdf/roughconductor.py``: eval = D * G * F /
(4 cos_theta_i) * specular_reflectance, visible-normal sampling and mirror
reflection, pdf = D * G1 / (4 cos_theta_i) (not detached, unlike
Diffuse's). Quotients whose divisor vanishes on masked lanes divide by 1
there: the values are the JAX package's, and a reverse-mode gradient stays
finite (a zero cotangent times an infinite slope is NaN)."""
from __future__ import annotations

import torch

from ..core.bitmap import Bitmap, constant, eval_bitmap
from ..core.frame import cos_theta
from ..core.math import dot, fresnel_conductor, normalize
from ..core.records import BSDFSample, Intersection
from .ggx import ggx_eval, ggx_G, ggx_sample, ggx_smith_g1


class RoughConductor:
    kind = "roughconductor"
    anisotropic = True

    def __init__(self, alpha_u=0.1, alpha_v=0.1,
                 eta=(0.2004, 0.9240, 1.1022),       # Au-ish defaults
                 k=(3.9129, 2.4528, 2.1421),
                 specular_reflectance=(1.0, 1.0, 1.0),
                 bsdf_id: str = ""):
        def tex(value, channels):
            return (value if isinstance(value, Bitmap)
                    else constant(value, channels))

        self.alpha_u = tex(alpha_u, 1)
        self.alpha_v = tex(alpha_v, 1)
        self.eta = tex(eta, 3)
        self.k = tex(k, 3)
        self.specular_reflectance = tex(specular_reflectance, 3)
        self.id = bsdf_id

    def params(self) -> dict:
        return {"alpha_u": self.alpha_u.data, "alpha_v": self.alpha_v.data,
                "eta": self.eta.data, "k": self.k.data,
                "specular_reflectance": self.specular_reflectance.data}

    def set_params(self, p: dict) -> None:
        self.alpha_u = Bitmap(p["alpha_u"])
        self.alpha_v = Bitmap(p["alpha_v"])
        self.eta = Bitmap(p["eta"])
        self.k = Bitmap(p["k"])
        self.specular_reflectance = Bitmap(p["specular_reflectance"])

    def __repr__(self):
        return f"RoughConductor[id={self.id}]"


def _tex(params: dict, name: str, its: Intersection, active: torch.Tensor):
    return eval_bitmap(Bitmap(params[name]), its.uv, active=active)


def _alphas(params: dict, its: Intersection, active: torch.Tensor):
    return (_tex(params, "alpha_u", its, active)[..., 0],
            _tex(params, "alpha_v", its, active)[..., 0])


def eval_roughconductor(params: dict, its: Intersection, wo: torch.Tensor,
                        active: torch.Tensor) -> torch.Tensor:
    lanes = active            # the dispatch's mask: who keeps a texel read
    cti = cos_theta(its.wi)
    cto = cos_theta(wo)
    active = active & (cti > 0.0) & (cto > 0.0)
    au, av = _alphas(params, its, lanes)
    H = normalize(wo + its.wi)
    D = ggx_eval(au, av, H)
    active = active & (D != 0.0)
    G = ggx_G(au, av, its.wi, wo, H)
    # the divisor is forced to 1 off the active lanes (cti <= 0 among
    # them), whose value the last select discards
    result = (D * G / torch.where(active, 4.0 * cti, 1.0))[..., None]
    F = fresnel_conductor(_tex(params, "eta", its, lanes),
                          _tex(params, "k", its, lanes), dot(its.wi, H))
    spec = _tex(params, "specular_reflectance", its, lanes)
    return torch.where(active[..., None], F * result * spec, 0.0)


def pdf_roughconductor(params: dict, its: Intersection, wo: torch.Tensor,
                       active: torch.Tensor) -> torch.Tensor:
    cti = cos_theta(its.wi)
    cto = cos_theta(wo)
    m = normalize(wo + its.wi)
    au, av = _alphas(params, its, active)
    active = (active & (cti > 0.0) & (cto > 0.0)
              & (dot(its.wi, m) > 0.0) & (dot(wo, m) > 0.0))
    result = (ggx_eval(au, av, m) * ggx_smith_g1(au, av, its.wi, m)
              / torch.where(active, 4.0 * cti, 1.0))
    return torch.where(active, result, 0.0)


def sample_roughconductor(params: dict, its: Intersection,
                          sample3: torch.Tensor,
                          active: torch.Tensor) -> BSDFSample:
    cti = cos_theta(its.wi)
    au, av = _alphas(params, its, active)
    m = ggx_sample(au, av, its.wi, sample3[..., :2])
    wo = m * (2.0 * dot(its.wi, m))[..., None] - its.wi
    pdf = pdf_roughconductor(params, its, wo, active)
    valid = active & (cti > 0.0) & (pdf != 0.0) & (cos_theta(wo) > 0.0)
    return BSDFSample(valid=valid, pdf=pdf, wo=wo)
