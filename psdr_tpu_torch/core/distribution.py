"""Discrete and hypercube sampling distributions. Counterpart of the
``Discrete`` and ``HyperCube`` parts of ``psdr_tpu/core/distribution.py``;
the alias table and the hierarchical 2D warp (and with them the ``alias``
and ``hier`` fields and branches of ``HyperCube``), opt-ins of the
environment map, are not ported (ROADMAP item 15). The environment map's
frozen table is a ``HyperCube`` whose ``cells`` placeholder is empty."""
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
    cmf[idx-1] / pmf[idx] by index, as the JAX package does. Larger tables
    use ``torch.searchsorted``: on one cmf it returns the count of entries
    below the sample, which is what the JAX package's blocked search (block
    ends, then a row of 128) adds up, so both select the same entries. The
    two packages' ``cmf`` themselves may differ in the last bit (a parallel
    scan against a running sum), and then a sample within an ulp of an
    entry may land one entry apart."""
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


class HyperCube(NamedTuple):
    """Piecewise-constant distribution over a regular n-D grid. ``cells``
    holds each flat cell's integer grid coordinates (row-major, the last
    dimension fastest); ``unit`` = 1 / resolution. ``resolution`` is a
    tuple of ints, so the cell decode costs no transfer from the card."""
    distrb: Discrete
    cells: torch.Tensor    # (num_cells, ndim) int32
    resolution: tuple      # (ndim,) ints
    unit: torch.Tensor     # (ndim,) float32

    @property
    def num_cells(self) -> int:
        return self.distrb.pmf.shape[0]

    @property
    def ndim(self) -> int:
        return len(self.resolution)


def hypercube_cells(resolution, device="cuda") -> torch.Tensor:
    """Flat-index -> grid-coordinate table, row-major."""
    grids = torch.meshgrid(*[torch.arange(int(r), dtype=torch.int32,
                                          device=device)
                             for r in resolution], indexing="ij")
    return torch.stack([g.reshape(-1) for g in grids], dim=-1)


def hypercube_init(resolution, mass: torch.Tensor | None = None,
                   device="cuda") -> HyperCube:
    """A uniform hypercube, or one of the given cell ``mass`` (then on the
    mass's device)."""
    reso = tuple(int(r) for r in resolution)
    if mass is not None:
        device = mass.device
    cells = hypercube_cells(reso, device)
    n = cells.shape[0]
    if mass is None:
        mass = torch.ones((n,), device=device)
    if mass.shape[0] != n:
        raise ValueError(f"mass has {mass.shape[0]} cells, the grid {n}")
    return HyperCube(distrb=discrete_init(mass), cells=cells,
                     resolution=reso,
                     unit=1.0 / torch.tensor(reso, dtype=torch.float32,
                                             device=device))


def hypercube_set_mass(hc: HyperCube, mass: torch.Tensor) -> HyperCube:
    # an all-zero mass table (a guiding preprocess that found no valid
    # boundary segment) degrades to uniform sampling, not to a zero-pdf
    # distribution that kills every guided sample
    mass = torch.where(torch.sum(mass) > 0.0, mass, torch.ones_like(mass))
    return hc._replace(distrb=discrete_init(mass))


def hypercube_sample_reuse(hc: HyperCube, samples: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """samples (..., ndim) in [0,1)^ndim -> (warped samples, pdf). Picks a
    cell with the last component, then maps the remainder uniformly inside
    the cell."""
    idx, pdf, last = discrete_sample_reuse(hc.distrb, samples[..., -1])
    samples = torch.cat([samples[..., :-1], last[..., None]], dim=-1)
    # arithmetic flat-index -> grid-coordinate decode instead of a gather
    # into the (num_cells, ndim) table
    coords = []
    rem = idx
    for r in reversed(hc.resolution):
        coords.append(rem % r)
        rem = rem // r
    cell = torch.stack(coords[::-1], dim=-1)
    return (samples + cell.to(samples.dtype)) * hc.unit, pdf * hc.num_cells


def hypercube_pdf(hc: HyperCube, p: torch.Tensor) -> torch.Tensor:
    """Density at points p (..., ndim) in [0,1)^ndim."""
    reso = torch.tensor(hc.resolution, dtype=torch.int32, device=p.device)
    ip = torch.floor(p * reso.to(p.dtype)).to(torch.int32)
    valid = torch.all((ip >= 0) & (ip < reso), dim=-1)
    idx = ip[..., 0]
    for i in range(1, hc.ndim):
        idx = idx * hc.resolution[i] + ip[..., i]
    idx = torch.clamp(idx, 0, hc.num_cells - 1).long()
    pdf_norm = hc.distrb.pmf[idx] / hc.distrb.total
    return torch.where(valid, pdf_norm * hc.num_cells, 0.0)
