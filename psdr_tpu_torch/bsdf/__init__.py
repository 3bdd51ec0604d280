"""BSDF models and the integer-tagged dispatch: per-lane ``bsdf_id``
selects among the scene's static BSDF list (a hit on the environment map's
bounding mesh has ``bsdf_id`` -1 and matches none). Counterpart of
``psdr_tpu/bsdf/__init__.py``.

Each entry point (``eval_bsdf``, ``pdf_bsdf``, ``sample_bsdf``) decides
from what it is given: lanes on the card that autograd need not record
(no input carrying a forward-mode tangent, and grad disabled or no input
requiring grad: every call of a render program) take the materials
kernel, ``csrc/bsdf.cu`` (``bsdf/kernel.py``), one launch a call, each
lane running its own BSDF alone; every other call takes the tensor code
(``*_plain``), differentiable, where each model runs on all lanes and the
results blend by the id mask. The two are bit-equal
on the card. A call on the card that takes the tensor code counts
``bsdf.plain``; a launch counts ``launches.bsdf``."""
from __future__ import annotations

import torch

from .. import profiling
from ..core.records import (BSDFSample, Intersection, any_requires_grad,
                            any_tangent)
from . import kernel
from .diffuse import Diffuse, eval_diffuse, pdf_diffuse, sample_diffuse
from .roughconductor import (RoughConductor, eval_roughconductor,
                             pdf_roughconductor, sample_roughconductor)

_EVAL = {"diffuse": eval_diffuse, "roughconductor": eval_roughconductor}
_SAMPLE = {"diffuse": sample_diffuse,
           "roughconductor": sample_roughconductor}
_PDF = {"diffuse": pdf_diffuse, "roughconductor": pdf_roughconductor}

# A kind is "reflective one-sided" when eval/pdf are exactly zero whenever
# wi or wo is at or below the shading horizon. The NEE side gate may skip
# the shadow trace on below-horizon lanes only when every scene BSDF has
# this property; kinds missing here report False.
_REFLECTIVE_ONE_SIDED = {"diffuse": True, "roughconductor": True}


def check_kinds(kinds) -> None:
    for k in kinds:
        if k not in _EVAL:
            raise NotImplementedError(f"BSDF kind {k!r} is not ported")


def all_reflective_one_sided(kinds) -> bool:
    """True iff the NEE below-horizon side gate is exact for this set."""
    return all(_REFLECTIVE_ONE_SIDED.get(k, False) for k in kinds)


def recorded(params_list, its: Intersection, x: torch.Tensor) -> bool:
    """Whether autograd records a call: an input requires grad with grad
    enabled, or carries a forward-mode tangent (under ``no_grad`` too)."""
    inputs = (params_list, its.wi, its.uv, x)
    return ((torch.is_grad_enabled() and any_requires_grad(inputs))
            or any_tangent(inputs))


def _on_kernel(params_list, its: Intersection, x: torch.Tensor) -> bool:
    """Whether a call launches the materials kernel: its lanes lie on the
    card and autograd need not record it. A call on the card that autograd
    records counts ``bsdf.plain``."""
    if not x.is_cuda:
        return False
    if recorded(params_list, its, x):
        from ..accel import intersect
        intersect.BSDF_PLAIN["plain"] += 1
        return False
    return True


@profiling.span("bsdf")
def eval_bsdf(kinds, params_list, its: Intersection, wo: torch.Tensor,
              active: torch.Tensor) -> torch.Tensor:
    """The value f(wi, wo) * cos(wo) of each lane's BSDF, (..., 3)."""
    if _on_kernel(params_list, its, wo):
        return kernel.launch(kernel.EVAL, kinds, params_list, its, wo, active)
    return eval_bsdf_plain(kinds, params_list, its, wo, active)


def eval_bsdf_plain(kinds, params_list, its: Intersection, wo: torch.Tensor,
                    active: torch.Tensor) -> torch.Tensor:
    """``eval_bsdf``'s tensor code, on any device."""
    result = torch.zeros(wo.shape[:-1] + (3,), dtype=wo.dtype,
                         device=wo.device)
    for i, (kind, params) in enumerate(zip(kinds, params_list)):
        mask = active & (its.bsdf_id == i)
        v = _EVAL[kind](params, its, wo, mask)
        result = result + torch.where(mask[..., None], v, torch.zeros_like(v))
    return result


@profiling.span("bsdf")
def pdf_bsdf(kinds, params_list, its: Intersection, wo: torch.Tensor,
             active: torch.Tensor) -> torch.Tensor:
    """The solid-angle pdf of sampling wo at each lane, (...)."""
    if _on_kernel(params_list, its, wo):
        return kernel.launch(kernel.PDF, kinds, params_list, its, wo, active)
    return pdf_bsdf_plain(kinds, params_list, its, wo, active)


def pdf_bsdf_plain(kinds, params_list, its: Intersection, wo: torch.Tensor,
                   active: torch.Tensor) -> torch.Tensor:
    """``pdf_bsdf``'s tensor code, on any device."""
    result = torch.zeros(wo.shape[:-1], dtype=wo.dtype, device=wo.device)
    for i, (kind, params) in enumerate(zip(kinds, params_list)):
        mask = active & (its.bsdf_id == i)
        v = _PDF[kind](params, its, wo, mask)
        result = result + torch.where(mask, v, torch.zeros_like(v))
    return result


@profiling.span("bsdf")
def sample_bsdf(kinds, params_list, its: Intersection, sample3: torch.Tensor,
                active: torch.Tensor) -> BSDFSample:
    """A direction wo drawn from each lane's BSDF with the sample's first
    two numbers, its pdf and whether it is valid."""
    if _on_kernel(params_list, its, sample3):
        return kernel.launch(kernel.SAMPLE, kinds, params_list, its, sample3,
                             active)
    return sample_bsdf_plain(kinds, params_list, its, sample3, active)


def sample_bsdf_plain(kinds, params_list, its: Intersection,
                      sample3: torch.Tensor,
                      active: torch.Tensor) -> BSDFSample:
    """``sample_bsdf``'s tensor code, on any device."""
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


__all__ = ["Diffuse", "RoughConductor", "all_reflective_one_sided",
           "check_kinds", "eval_bsdf", "eval_bsdf_plain", "pdf_bsdf",
           "pdf_bsdf_plain", "sample_bsdf", "sample_bsdf_plain"]
