"""BSDF models and the integer-tagged dispatch: per-lane ``bsdf_id``
selects among the scene's static BSDF list; each model runs on all lanes
and results blend by the id mask. Counterpart of
``psdr_tpu/bsdf/__init__.py``; ``roughconductor`` waits for slice 4."""
from __future__ import annotations

import torch

from ..core.records import BSDFSample, Intersection
from .diffuse import Diffuse, eval_diffuse, pdf_diffuse, sample_diffuse

_EVAL = {"diffuse": eval_diffuse}
_SAMPLE = {"diffuse": sample_diffuse}
_PDF = {"diffuse": pdf_diffuse}

# A kind is "reflective one-sided" when eval/pdf are exactly zero whenever
# wi or wo is at or below the shading horizon. The NEE side gate may skip
# the shadow trace on below-horizon lanes only when every scene BSDF has
# this property; kinds missing here report False.
_REFLECTIVE_ONE_SIDED = {"diffuse": True}


def check_kinds(kinds) -> None:
    for k in kinds:
        if k not in _EVAL:
            raise NotImplementedError(
                f"BSDF kind {k!r} waits for slice 4 (materials)")


def all_reflective_one_sided(kinds) -> bool:
    """True iff the NEE below-horizon side gate is exact for this set."""
    return all(_REFLECTIVE_ONE_SIDED.get(k, False) for k in kinds)


def eval_bsdf(kinds, params_list, its: Intersection, wo: torch.Tensor,
              active: torch.Tensor) -> torch.Tensor:
    result = torch.zeros(wo.shape[:-1] + (3,), dtype=wo.dtype,
                         device=wo.device)
    for i, (kind, params) in enumerate(zip(kinds, params_list)):
        mask = active & (its.bsdf_id == i)
        v = _EVAL[kind](params, its, wo, mask)
        result = result + torch.where(mask[..., None], v, torch.zeros_like(v))
    return result


def pdf_bsdf(kinds, params_list, its: Intersection, wo: torch.Tensor,
             active: torch.Tensor) -> torch.Tensor:
    result = torch.zeros(wo.shape[:-1], dtype=wo.dtype, device=wo.device)
    for i, (kind, params) in enumerate(zip(kinds, params_list)):
        mask = active & (its.bsdf_id == i)
        v = _PDF[kind](params, its, wo, mask)
        result = result + torch.where(mask, v, torch.zeros_like(v))
    return result


def sample_bsdf(kinds, params_list, its: Intersection, sample3: torch.Tensor,
                active: torch.Tensor) -> BSDFSample:
    n = sample3.shape[:-1]
    dev = sample3.device
    out = BSDFSample(valid=torch.zeros(n, dtype=torch.bool, device=dev),
                     pdf=torch.zeros(n, dtype=torch.float32, device=dev),
                     wo=torch.zeros(n + (3,), dtype=torch.float32, device=dev))
    for i, (kind, params) in enumerate(zip(kinds, params_list)):
        mask = active & (its.bsdf_id == i)
        bs = _SAMPLE[kind](params, its, sample3, mask)
        out = BSDFSample(
            valid=torch.where(mask, bs.valid, out.valid),
            pdf=torch.where(mask, bs.pdf, out.pdf),
            wo=torch.where(mask[..., None], bs.wo, out.wo),
        )
    return out


__all__ = ["Diffuse", "all_reflective_one_sided", "check_kinds",
           "eval_bsdf", "pdf_bsdf", "sample_bsdf"]
