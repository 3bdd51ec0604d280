"""Lat-long environment-map emitter with grid importance sampling.
Counterpart of ``psdr_tpu/emitter/envmap.py``:

* ``configure_envmap`` builds a 2D hypercube distribution over a
  (2 (W - 1), 2 (H - 1)) grid with sin-theta weighting;
* ``envmap_eval_direction`` maps a world direction to lat-long uv;
* position sampling turns a sampled direction into a pseudo area sample on
  the scene AABB with a G-converted pdf.

The scene adds an 8-vertex, 12-face bounding mesh that carries this
emitter, so environment hits look like surface hits.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from ..core import transform as xform
from ..core.bitmap import Bitmap, eval_bitmap, from_array
from ..core.constants import Epsilon, InvPi, InvTwoPi, Pi, TwoPi
from ..core.hoist import const, hold
from ..core.distribution import (Discrete, HyperCube, alias_table_host,
                                 hier2d_host,
                                 hypercube_init, hypercube_pdf,
                                 hypercube_sample_reuse)
from ..core.math import (dot, ray_intersect_scene_aabb, rgb2luminance,
                         safe_acos, safe_rsqrt, safe_sqrt, sphdir, sqr,
                         squared_norm)
from ..core.records import PositionSample


class EnvironmentMap:
    kind = "env"

    def __init__(self, radiance, scale=1.0, to_world=None,
                 emitter_id: str = ""):
        if not isinstance(radiance, Bitmap):
            radiance = from_array(radiance)
        self.radiance = radiance
        self.scale = np.float32(scale)
        self.to_world = (np.eye(4, dtype=np.float32) if to_world is None
                         else np.asarray(to_world, np.float32))
        self.id = emitter_id

    def params(self) -> dict:
        return {"radiance": self.radiance.data, "scale": self.scale,
                "to_world": self.to_world}

    def set_params(self, p: dict) -> None:
        self.radiance = Bitmap(p["radiance"])
        self.scale = p["scale"]
        self.to_world = p["to_world"]

    def __repr__(self):
        return "EnvironmentMap"


class EnvmapState(NamedTuple):
    """Differentiable runtime state built by the scene."""
    data: torch.Tensor        # (H, W, 3)
    scale: torch.Tensor
    to_world: torch.Tensor    # (4, 4)
    from_world: torch.Tensor  # (4, 4)
    cell_distrb: HyperCube
    lower: torch.Tensor       # scene AABB (3,)
    upper: torch.Tensor


def _host_mass_grid(radiance, gw, gh, gw_f, gh_f):
    """Float64 numpy build of the cell masses (bilinear fine-grid taps with
    sin-theta weighting, max-pooled into the coarse grid when divided), run
    on the host from the scene's radiance snapshot, so a render carries the
    finished table instead of rebuilding the distribution every frame."""
    h, w, _ = radiance.shape
    lum = (radiance[..., 0] * 0.2126 + radiance[..., 1] * 0.7152
           + radiance[..., 2] * 0.0722).astype(np.float64)
    # fine-grid cell centers, bilinear like core/bitmap.py (scale reso-1)
    u = (np.arange(gw_f, dtype=np.float64) + 0.5) / gw_f
    v = (np.arange(gh_f, dtype=np.float64) + 0.5) / gh_f
    x = u * (w - 1)
    y = v * (h - 1)
    x0 = np.minimum(np.floor(x).astype(np.int64), w - 2)
    y0 = np.minimum(np.floor(y).astype(np.int64), h - 2)
    wx1 = x - x0
    wy1 = y - y0
    # (gw_f, gh_f): x-major to match hypercube flat order (x = i // gh)
    l00 = lum[y0[None, :], x0[:, None]]
    l10 = lum[y0[None, :], x0[:, None] + 1]
    l01 = lum[y0[None, :] + 1, x0[:, None]]
    l11 = lum[y0[None, :] + 1, x0[:, None] + 1]
    val = ((1 - wx1)[:, None] * ((1 - wy1)[None, :] * l00 + wy1[None, :] * l01)
           + wx1[:, None] * ((1 - wy1)[None, :] * l10 + wy1[None, :] * l11))
    m_fine = val * np.sin((np.arange(gh_f) + 0.5) * (float(Pi) / gh_f))[None, :]
    if (gw, gh) == (gw_f, gh_f):
        return m_fine.reshape(-1)
    # coarse: max-pool footprints (see configure_envmap's divided grid)
    cx = (np.arange(gw_f) * gw) // gw_f
    cy = (np.arange(gh_f) * gh) // gh_f
    pooled = np.zeros((gw, gh), np.float64)
    np.maximum.at(pooled, (cx[:, None], cy[None, :]), m_fine)
    return pooled.reshape(-1)


# keyed by (id(radiance), shape, grid, kind): the radiance snapshot lives
# on the host Scene object and is replaced (not mutated) on param updates.
# Each entry (table, snapshot, {device: table there}) holds its snapshot, so
# an id cannot be reused under it.
_FROZEN_CACHE: dict = {}


def _frozen_tables(host_radiance, gw, gh, gw_f, gh_f, kind: str):
    """Host-side (float64 numpy) importance table, built once per radiance
    snapshot. ``kind="cmf"``: a ``Discrete`` whose monotone inverse-CDF
    search keeps the (0,2)-sequence's stratification (the default);
    ``"alias"``: an ``AliasTable``, O(1) sampling but a non-monotone map
    from u to cell, which loses that stratification; ``"hier"``: a
    ``Hier2D``, monotone in both sample axes."""
    return _frozen_entry(host_radiance, gw, gh, gw_f, gh_f, kind)[0]


def _frozen_on_device(host_radiance, gw, gh, gw_f, gh_f, kind: str, dev):
    """``_frozen_tables``' table with its arrays on ``dev``, uploaded once a
    table and device: the scene build of a captured program reads it
    here, filled by the program's warm-up call. The cache may drop the
    entry (above 8 snapshots) while a program's graph still reads it, so
    the table goes out through ``hoist.hold``: the program keeps it."""
    entry = _frozen_entry(host_radiance, gw, gh, gw_f, gh_f, kind)
    dev = torch.device(dev)
    if dev not in entry[2]:
        def up(x):
            if isinstance(x, tuple):
                return tuple(up(v) for v in x)
            return torch.as_tensor(x, device=dev)
        entry[2][dev] = type(entry[0])(*(up(v) for v in entry[0]))
    return hold(entry[2][dev])


def _frozen_entry(host_radiance, gw, gh, gw_f, gh_f, kind: str):
    key = (id(host_radiance), tuple(host_radiance.shape), gw, gh, kind)
    hit = _FROZEN_CACHE.get(key)
    if hit is None:
        rad = host_radiance
        if isinstance(rad, torch.Tensor):
            rad = rad.detach().cpu().numpy()
        mass = _host_mass_grid(np.asarray(rad), gw, gh, gw_f, gh_f)
        if kind == "alias":
            table = alias_table_host(mass)
        elif kind == "hier":
            table = hier2d_host(mass, gw, gh)
        else:
            total = mass.sum()
            if not np.isfinite(total) or total <= 0.0:
                mass = np.ones_like(mass)
            pmf = mass.astype(np.float32)
            cmf = np.maximum.accumulate(np.cumsum(mass).astype(np.float32))
            table = Discrete(pmf=pmf, cmf=cmf, total=cmf[-1])
        hit = (table, host_radiance, {})
        if len(_FROZEN_CACHE) > 8:
            _FROZEN_CACHE.clear()
        _FROZEN_CACHE[key] = hit
    return hit


def _segment_max(x: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """Row-wise maximum of ``x`` (R, C) over the segments ``seg`` (R,) ->
    (n, C); every segment is non-empty here."""
    out = torch.zeros((n,) + x.shape[1:], dtype=x.dtype, device=x.device)
    return out.scatter_reduce(0, seg[:, None].expand_as(x), x, "amax",
                              include_self=False)


def _grid_mass(data: torch.Tensor, gw: int, gh: int) -> torch.Tensor:
    """One bilinear tap per cell center of a (gw, gh) grid, weighted by
    sin theta -> (gw * gh,), x-major."""
    hc = hypercube_init((gw, gh), device=data.device)
    uv = (hc.cells.float() + 0.5) * hc.unit
    val = eval_bitmap(Bitmap(data), uv)
    theta = ((torch.arange(gw * gh, device=data.device) % gh).float()
             + 0.5) * (Pi / gh)
    return rgb2luminance(val) * torch.sin(theta)


def configure_envmap(params: dict, lower: torch.Tensor, upper: torch.Tensor,
                     host_radiance=None) -> EnvmapState:
    """The importance grid is a choice of variance, not of correctness: the
    pdf reads the same distribution that is sampled, so any resolution is
    unbiased provided every direction of nonzero radiance keeps nonzero
    mass. The reference-parity grid has (2 (W - 1)) x (2 (H - 1)) cells;
    above 2^18 cells it is divided by ``PSDR_TPU_ENV_RESO_DIV`` (default
    4; 1 restores the parity grid). Above 2^15 cells, with a host radiance
    snapshot, the table is frozen: built once on the host
    (``_frozen_tables``) and not again every frame
    (``PSDR_TPU_ENV_FROZEN=0`` turns that off). Two opt-in frozen tables
    replace the cmf there: ``PSDR_TPU_ENV_ALIAS=1`` (the alias table) and
    ``PSDR_TPU_ENV_HIER=1`` (the hierarchical warp, up to 4096 cells an
    axis); their sampling cost does not grow with the grid, so either
    takes the parity grid (a default divisor of 1)."""
    data = params["radiance"]
    dev = data.device
    h, w = data.shape[0], data.shape[1]
    gw_f, gh_f = (w - 1) * 2, (h - 1) * 2
    big = host_radiance is not None and gw_f * gh_f > (1 << 15)
    use_alias = big and os.environ.get("PSDR_TPU_ENV_ALIAS", "0") == "1"
    use_hier = (big and not use_alias and max(gw_f, gh_f) <= 4096
                and os.environ.get("PSDR_TPU_ENV_HIER", "0") == "1")
    use_frozen_cmf = (big and not use_alias and not use_hier
                      and os.environ.get("PSDR_TPU_ENV_FROZEN", "1") == "1")
    div = max(1, int(os.environ.get(
        "PSDR_TPU_ENV_RESO_DIV", "1" if use_alias or use_hier else "4")))
    gw, gh = gw_f, gh_f
    if div > 1 and gw_f * gh_f > (1 << 18):
        gw, gh = max(128, gw_f // div), max(64, gh_f // div)
    placeholder = dict(
        cells=torch.zeros((0, 2), dtype=torch.int32, device=dev),
        resolution=(gw, gh),
        unit=1.0 / const((gw, gh), torch.float32, dev))
    if use_alias:
        at = _frozen_on_device(host_radiance, gw, gh, gw_f, gh_f, "alias",
                               dev)
        hc = HyperCube(distrb=None, alias=at, **placeholder)
    elif use_hier:
        ht = _frozen_on_device(host_radiance, gw, gh, gw_f, gh_f, "hier",
                               dev)
        hc = HyperCube(distrb=None, hier=ht, **placeholder)
    elif use_frozen_cmf:
        d = _frozen_on_device(host_radiance, gw, gh, gw_f, gh_f, "cmf", dev)
        hc = HyperCube(distrb=d._replace(total=d.cmf[-1]), **placeholder)
    elif (gw, gh) == (gw_f, gh_f):
        # reference-parity grid: one bilinear tap per (half-texel) cell
        hc = hypercube_init((gw, gh), _grid_mass(data.detach(), gw, gh))
    else:
        # Divided grid: a single center tap at div-texel spacing can miss a
        # small bright feature (a sun disk) entirely, and zero mass means a
        # zero NEE pdf, which is biased for light-sampling-only estimators.
        # Pool the fine grid with MAX over each coarse cell's footprint:
        # every direction with nonzero fine-grid mass keeps nonzero coarse
        # mass (over-weighting moves variance, never the mean).
        m_fine = _grid_mass(data.detach(), gw_f, gh_f).reshape(gw_f, gh_f)
        cx = (torch.arange(gw_f, device=dev) * gw) // gw_f
        cy = (torch.arange(gh_f, device=dev) * gh) // gh_f
        pooled = _segment_max(m_fine, cx, gw)                    # (gw, gh_f)
        pooled = _segment_max(pooled.T.contiguous(), cy, gh).T   # (gw, gh)
        hc = hypercube_init((gw, gh), pooled.reshape(gw * gh))
    to_world = params["to_world"]
    return EnvmapState(data=data, scale=params["scale"], to_world=to_world,
                       from_world=torch.linalg.inv_ex(to_world).inverse,
                       cell_distrb=hc, lower=lower, upper=upper)


def _direction_uv(v: torch.Tensor) -> torch.Tensor:
    """Lat-long uv in [0, 1)^2 of an envmap-space direction."""
    uv = torch.stack([torch.atan2(v[..., 0], -v[..., 2]) * InvTwoPi,
                      safe_acos(v[..., 1]) * InvPi], dim=-1)
    return uv - torch.floor(uv)


def envmap_eval_direction(st: EnvmapState, wi: torch.Tensor,
                          active: torch.Tensor) -> torch.Tensor:
    """Radiance arriving *from* direction wi."""
    v = xform.transform_dir(st.from_world, wi)
    val = eval_bitmap(Bitmap(st.data), _direction_uv(v)) * st.scale
    return torch.where(active[..., None], val, 0.0)


def envmap_sample_direction(st: EnvmapState, sample2: torch.Tensor):
    """(direction, pdf in solid angle)."""
    uv, pdf = hypercube_sample_reuse(st.cell_distrb, sample2)
    theta = uv[..., 1] * Pi
    phi = uv[..., 0] * TwoPi
    d = sphdir(theta, phi)
    d = torch.stack([d[..., 1], d[..., 2], -d[..., 0]], dim=-1)
    inv_sin_theta = safe_rsqrt(torch.clamp(sqr(d[..., 0]) + sqr(d[..., 2]),
                                           min=sqr(Epsilon)))
    pdf = torch.where(pdf > Epsilon, pdf * inv_sin_theta * (0.5 / sqr(Pi)),
                      pdf)
    d = xform.transform_dir(st.to_world.detach(), d)
    return d, pdf


def envmap_sample_position(st: EnvmapState, ref_p: torch.Tensor,
                           sample2: torch.Tensor,
                           active: torch.Tensor) -> PositionSample:
    """Direction sample -> pseudo area sample on the scene AABB. Nothing
    here carries a gradient: the reference point, the sample and
    ``to_world`` are read detached."""
    o = ref_p.detach()
    d, pdf = envmap_sample_direction(st, sample2.detach())
    t, n, G = ray_intersect_scene_aabb(o, d, st.lower, st.upper)
    return PositionSample(valid=active, pdf=pdf * G, p=o + d * t[..., None],
                          n=n, J=torch.ones_like(pdf),
                          emitter=torch.full(pdf.shape, -1, dtype=torch.int32,
                                             device=pdf.device))


def envmap_position_pdf(st: EnvmapState, ref_p: torch.Tensor,
                        its_p: torch.Tensor, its_n: torch.Tensor,
                        active: torch.Tensor) -> torch.Tensor:
    """Area-measure pdf of a bounding-mesh hit (detached)."""
    d = its_p.detach() - ref_p.detach()
    dist2 = squared_norm(d)
    d = d / safe_sqrt(dist2)[..., None]
    G = torch.abs(dot(d, its_n.detach())) / dist2
    d = xform.transform_dir(st.from_world.detach(), d)
    factor = G * safe_rsqrt(torch.clamp(sqr(d[..., 0]) + sqr(d[..., 2]),
                                        min=sqr(Epsilon))) * (0.5 / sqr(Pi))
    pdf = hypercube_pdf(st.cell_distrb, _direction_uv(d))
    return torch.where(active, pdf * factor, 0.0)
