"""Discrete and hypercube sampling distributions. Counterpart of
``psdr_tpu/core/distribution.py``: the cmf-searched ``Discrete``, and the
environment map's two opt-in tables, the alias table (O(1) sampling) and
the hierarchical 2D warp (a descent of at most 8 x 8 children a level,
monotone in both sample axes). Both are built on the host in float64 numpy
(``alias_table_host``, ``hier2d_host``), as the JAX package builds them,
and sampled in tensor code. A ``HyperCube`` with one of them (``alias`` or
``hier``) samples it instead of its cmf; the environment map's frozen
tables are ``HyperCube``s whose ``cells`` placeholder is empty."""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .hoist import const


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


class AliasTable(NamedTuple):
    """O(1) alias-method sampler (Walker / Vose). One (N, 4) float32 row a
    cell: [q, pmf_self, pmf_alias, alias index bitcast to float32], so a
    sample is one narrow row gather and a few selects. ``pmf`` is the
    effective per-cell mass the table samples, recomputed from (q, alias)
    after the build, so the pdf always describes what sampling does."""
    packed: object    # (N, 4) float32: numpy on the host, a tensor on use
    pmf: object       # (N,) effective pmf (input-mass scale)
    total: object     # scalar

    @property
    def size(self) -> int:
        return self.pmf.shape[0]


def alias_table_host(mass) -> AliasTable:
    """Host-side (numpy, float64) alias-table build, O(N log N).

    A vectorized prefix-sum form of Vose's two-pointer build: lights
    (w < 1) and heavies (w >= 1) are each kept in index order; with D_i the
    prefix deficits over lights and E_j the prefix excesses over heavies,
    light i's alias is heavy j where #{E < D_{i-1}} = j - 1, and heavy j
    flips with probability 1 - (G_j - E_j), G_j the first D > E_j, aliased
    to heavy j + 1. The effective pmf is recomputed from the built table so
    float32 rounding can never bias sampling."""
    mass = np.asarray(mass, np.float64).reshape(-1)
    n = mass.size
    total = mass.sum()
    if not np.isfinite(total) or total <= 0.0:
        mass = np.ones(n, np.float64)
        total = float(n)
    w = mass * (n / total)
    q = np.ones(n, np.float64)
    alias = np.arange(n, dtype=np.int64)
    li = np.nonzero(w < 1.0)[0]
    hi = np.nonzero(w >= 1.0)[0]
    if li.size and hi.size:
        d = 1.0 - w[li]
        D = np.cumsum(d)
        E = np.cumsum(w[hi] - 1.0)
        # lights: alias = the heavy active when this light is processed
        k = np.searchsorted(E, D - d, side="left")
        alias[li] = hi[np.minimum(k, hi.size - 1)]
        q[li] = w[li]
        # heavies: flip iff some light deficit crosses their excess prefix
        m = np.searchsorted(D, E, side="right")
        flips = m < li.size
        G = D[np.minimum(m, li.size - 1)]
        q[hi] = np.where(flips, np.clip(1.0 - (G - E), 0.0, 1.0), 1.0)
        nxt = hi[np.minimum(np.arange(hi.size) + 1, hi.size - 1)]
        alias[hi] = np.where(flips, nxt, hi)
    # effective pmf: q_i + the sum over cells aliased here of (1 - q)
    eff = q.copy()
    np.add.at(eff, alias, 1.0 - q)
    pmf_eff = (eff * (total / n)).astype(np.float32)
    packed = np.empty((n, 4), np.float32)
    packed[:, 0] = q
    packed[:, 1] = pmf_eff
    packed[:, 2] = pmf_eff[alias]
    packed[:, 3] = alias.astype(np.int32).view(np.float32)
    return AliasTable(packed=packed, pmf=pmf_eff,
                      total=np.float32(pmf_eff.sum()))


def alias_sample_reuse(at: AliasTable, samples: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The contract of ``discrete_sample_reuse``: (idx, pdf_normalized,
    samples_remapped), one uniform consumed and its remainder recycled.

    The cell is exact fixed-point int32 arithmetic, not floor(u * n), whose
    float32 product quantizes to steps of n / 2^24 cells: with k =
    floor(u * 2^24) (exact, a power-of-two scale) the cell is
    floor(k n / 2^24), computed without overflow by 12-bit splits of both
    factors. The alias index is the row's last float32 read back as int32."""
    n = at.size
    if n >= 1 << 24:
        raise ValueError("alias tables support up to 2^24 cells")
    u = torch.clamp(samples, 0.0, 1.0 - 1e-7)
    ks = u * float(1 << 24)
    k = ks.to(torch.int32)                         # exact: 2^24 scale
    u_res = ks - k.to(ks.dtype)                    # sub-quantum residual
    k_hi, k_lo = k >> 12, k & 0xFFF
    n_hi, n_lo = n >> 12, n & 0xFFF
    L = k_lo * n_lo                                # < 2^24
    M = k_hi * n_lo + k_lo * n_hi + (L >> 12)      # < 2^26
    c = torch.clamp(k_hi * n_hi + (M >> 12), 0, n - 1)
    mod24 = ((M & 0xFFF) << 12) | (L & 0xFFF)      # (k n) mod 2^24
    frac = (mod24.to(torch.float32) + u_res) * (1.0 / (1 << 24))
    row = at.packed[c.long()]                      # one (N, 4) row gather
    q = row[..., 0]
    al = row[..., 3].contiguous().view(torch.int32)
    take_self = frac < q
    idx = torch.where(take_self, c, al)
    pmf_i = torch.where(take_self, row[..., 1], row[..., 2])
    denom = torch.where(take_self, q, 1.0 - q)
    num = torch.where(take_self, frac, frac - q)
    remapped = torch.clamp(num / torch.clamp(denom, min=1e-12), 0.0, 1.0)
    return idx, pmf_i / at.total, remapped


class Hier2D(NamedTuple):
    """Hierarchical 2D sample warp over a regular (gw, gh) grid, padded to
    powers of two per axis and factored into descent steps of up to 8 x 8
    children. Each step stores, per node, its children's subtree masses as
    one (ax, ay) row: a step is one narrow row gather and two tiny inverse
    CDFs (the x marginal with u0, then the chosen column's conditional with
    u1). Both per-axis maps are nested inverse CDFs, hence monotone in u0
    and u1, so stratified and low-discrepancy point sets keep their 2D
    structure through the warp. The finest entries are float32 casts of the
    same float64 sums as ``pmf``: the reported pdf is ``pmf[cell] /
    total`` bit for bit."""
    levels: tuple     # per step: (n_nodes, ax, ay) float32 child masses
    pmf: object       # (gw * gh,) float32, the real grid, x-major
    total: object     # scalar float32 (float64 host sum, cast once)

    @property
    def size(self) -> int:
        return self.pmf.shape[0]


def _hier_split_plan(pw: int, ph: int):
    """Factor the powers of two (pw, ph) into aligned per-step (ax, ay)
    splits of at most 8 each, coarse to fine; the shorter axis pads with 1s
    at the coarse end."""
    def plan(p):
        out = []
        while p > 1:
            f = min(8, p)
            out.append(f)
            p //= f
        return out
    px, py = plan(pw), plan(ph)
    steps = max(len(px), len(py), 1)
    px = [1] * (steps - len(px)) + px
    py = [1] * (steps - len(py)) + py
    return list(zip(px, py))


def hier2d_host(mass, gw: int, gh: int) -> Hier2D:
    """Host-side (numpy, float64) build of the hierarchical warp, O(N)."""
    m = np.asarray(mass, np.float64).reshape(gw, gh)
    total = m.sum()
    if not np.isfinite(total) or total <= 0.0:
        m = np.ones((gw, gh), np.float64)
        total = float(gw * gh)
    pw = 1 << max(0, int(gw - 1).bit_length())
    ph = 1 << max(0, int(gh - 1).bit_length())
    if max(pw, ph) > 4096:
        raise ValueError("hier2d supports up to 4096 cells per axis "
                         "(float32 cell + fraction sums)")
    M = np.zeros((pw, ph), np.float64)
    M[:gw, :gh] = m
    tabs = []
    S = M
    for ax, ay in reversed(_hier_split_plan(pw, ph)):
        nx, ny = S.shape
        nnx, nny = nx // ax, ny // ay
        t = S.reshape(nnx, ax, nny, ay).transpose(0, 2, 1, 3)
        tabs.append(t.reshape(nnx * nny, ax, ay).astype(np.float32))
        S = t.sum(axis=(2, 3))
    return Hier2D(levels=tuple(tabs[::-1]),
                  pmf=M[:gw, :gh].reshape(-1).astype(np.float32),
                  total=np.float32(total))


def _invcdf_small(m: torch.Tensor, u: torch.Tensor):
    """Inverse CDF over a tiny (..., K) mass row -> (bin, remapped u, bin
    mass). The strict ``cmf < s`` count skips zero-width bins; the selects
    are by index. As in the JAX package, a row whose float32 entries are
    all zero under a parent whose float32 mass is a nonzero subnormal gives
    a bin mass, hence a pdf, of 0 for a lane it did sample; the port keeps
    that (vanishingly rare) behaviour rather than differ."""
    K = m.shape[-1]
    if K == 1:
        return (torch.zeros(u.shape, dtype=torch.int32, device=u.device), u,
                m[..., 0])
    # a running sum, left to right, as XLA's cumsum of a row this short
    # adds (torch.cumsum rounds differently on three rows in four)
    c = [m[..., 0]]
    for i in range(1, K):
        c.append(c[-1] + m[..., i])
    c = torch.stack(c, dim=-1)
    s = u * c[..., -1]
    k = torch.clamp((c < s[..., None]).sum(dim=-1, dtype=torch.int32),
                    0, K - 1)
    iota = torch.arange(K, dtype=torch.int32, device=u.device)
    mk = torch.where(iota == k[..., None], m, 0.0).sum(dim=-1)
    prev = torch.where(iota == (k - 1)[..., None], c, 0.0).sum(dim=-1)
    res = s - prev
    u2 = torch.clamp(torch.where(mk > 0.0, res / mk, res), 0.0, 1.0 - 1e-7)
    return k, u2, mk


def hier2d_sample_reuse(h: Hier2D, samples: torch.Tensor, resolution):
    """samples (..., 2) in [0,1)^2 -> (warped (..., 2) in real-grid uv,
    normalized cell pdf): per level one narrow row gather and two tiny
    inverse CDFs; u0 warps the x axis, u1 the y axis."""
    u0 = torch.clamp(samples[..., 0], 0.0, 1.0 - 1e-7)
    u1 = torch.clamp(samples[..., 1], 0.0, 1.0 - 1e-7)
    ix = torch.zeros(u0.shape, dtype=torch.int32, device=u0.device)
    iy = torch.zeros_like(ix)
    ny_nodes = 1
    mk = h.total
    for tab in h.levels:
        n_nodes, ax, ay = tab.shape
        # the root level has one node: no gather
        row = tab[0] if n_nodes == 1 else tab[(ix * ny_nodes + iy).long()]
        i, u0, _ = _invcdf_small(row.sum(dim=-1), u0)
        iota = torch.arange(ax, dtype=torch.int32, device=u0.device)
        cond = torch.where((iota == i[..., None])[..., None], row,
                           0.0).sum(dim=-2)                  # (..., ay)
        j, u1, mk = _invcdf_small(cond, u1)
        ix = ix * ax + i
        iy = iy * ay + j
        ny_nodes = ny_nodes * ay
    reso = const(tuple(resolution), torch.float32, u0.device)
    # cap the in-cell fractions at 1 - 2^-10 so that cell + frac cannot
    # round up across the cell border in float32 (hier2d_host allows at
    # most 4096 cells an axis). As in the JAX package, the cap puts the top
    # 2^-10 of each cell's interior on one point
    cap = 1.0 - 1.0 / 1024.0
    warped = torch.stack(
        [(ix.to(torch.float32) + torch.clamp(u0, max=cap)) / reso[0],
         (iy.to(torch.float32) + torch.clamp(u1, max=cap)) / reso[1]],
        dim=-1)
    # mk, the finest chosen child mass, is pmf[ix * gh + iy] bit for bit
    return warped, mk / h.total


class HyperCube(NamedTuple):
    """Piecewise-constant distribution over a regular n-D grid. ``cells``
    holds each flat cell's integer grid coordinates (row-major, the last
    dimension fastest); ``unit`` = 1 / resolution. ``resolution`` is a
    tuple of ints, so the cell decode costs no transfer from the card.
    Where ``alias`` or ``hier`` is given, it replaces the cmf search
    (``distrb`` is then None and ``cells`` an empty placeholder)."""
    distrb: Discrete | None
    cells: torch.Tensor    # (num_cells, ndim) int32 (may be (0, ndim))
    resolution: tuple      # (ndim,) ints
    unit: torch.Tensor     # (ndim,) float32
    alias: AliasTable | None = None
    hier: Hier2D | None = None

    @property
    def num_cells(self) -> int:
        if self.distrb is not None:
            return self.distrb.pmf.shape[0]
        if self.alias is not None:
            return self.alias.size
        return self.hier.size

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
                     unit=1.0 / const(reso, torch.float32, device))


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
    the cell. A ``hier`` table warps both components at once."""
    if hc.hier is not None:
        warped, pdf_norm = hier2d_sample_reuse(hc.hier, samples,
                                               hc.resolution)
        return warped, pdf_norm * hc.num_cells
    if hc.alias is not None:
        idx, pdf, last = alias_sample_reuse(hc.alias, samples[..., -1])
    else:
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
    reso = const(hc.resolution, torch.int32, p.device)
    ip = torch.floor(p * reso.to(p.dtype)).to(torch.int32)
    valid = torch.all((ip >= 0) & (ip < reso), dim=-1)
    idx = ip[..., 0]
    for i in range(1, hc.ndim):
        idx = idx * hc.resolution[i] + ip[..., i]
    idx = torch.clamp(idx, 0, hc.num_cells - 1).long()
    table = hc.alias or hc.hier or hc.distrb
    pdf_norm = table.pmf[idx] / table.total
    return torch.where(valid, pdf_norm * hc.num_cells, 0.0)
