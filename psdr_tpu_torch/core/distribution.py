"""Discrete sampling distribution. Counterpart of the ``Discrete`` part of
``psdr_tpu/core/distribution.py``; the alias, hierarchical and hypercube
distributions wait for slices 2 and 4."""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class Discrete(NamedTuple):
    """Unnormalized pmf + inclusive cmf."""
    pmf: torch.Tensor    # (n,)
    cmf: torch.Tensor    # (n,) inclusive prefix sum
    total: torch.Tensor  # scalar = cmf[-1]

    @property
    def size(self) -> int:
        return self.pmf.shape[0]


def discrete_init(pmf: torch.Tensor) -> Discrete:
    pmf = pmf.detach()
    # a parallel cumsum need not be monotone at f32 rounding level; the
    # running max keeps the searches below well defined
    cmf = torch.cummax(torch.cumsum(pmf, dim=0), dim=0).values
    return Discrete(pmf=pmf, cmf=cmf, total=cmf[-1])


def discrete_sample_reuse(d: Discrete, samples: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sample indices proportional to pmf and remap the used samples back to
    [0, 1). Returns (idx, pdf_normalized, samples_remapped).

    Tables of up to 32 entries count cmf entries below the sample and select
    cmf[idx-1] / pmf[idx] by index, as the JAX package does; larger tables
    use ``torch.searchsorted``, which selects the same entries as the JAX
    package's blocked search."""
    s = samples * d.total
    if d.size <= 32:
        lt = d.cmf[None, :] < s[..., None]                   # (N, L)
        idx = torch.clamp(lt.sum(dim=-1, dtype=torch.int32), 0, d.size - 1)
        prev = torch.zeros_like(s)
        pmf_i = d.pmf[0].expand(idx.shape)
        for i in range(1, d.size):
            prev = torch.where(idx == i, d.cmf[i - 1], prev)
            pmf_i = torch.where(idx == i, d.pmf[i], pmf_i)
    else:
        # first index i with cmf[i] >= s
        idx = torch.clamp(torch.searchsorted(d.cmf, s, side="left"),
                          0, d.size - 1).to(torch.int32)
        prev = torch.where(idx > 0, d.cmf[torch.clamp(idx - 1, min=0)],
                           torch.zeros_like(s))
        pmf_i = d.pmf[idx]
    residual = s - prev
    remapped = torch.clamp(
        torch.where(pmf_i > 0.0, residual / pmf_i, residual), 0.0, 1.0)
    return idx, pmf_i / d.total, remapped


def discrete_pdf(d: Discrete, idx: torch.Tensor) -> torch.Tensor:
    return d.pmf[idx] / d.total
