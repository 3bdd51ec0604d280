"""One-bounce direct-illumination integrator with MIS and the secondary-edge
boundary term. Counterpart of ``psdr_tpu/integrator/direct.py``, in the
forward render and under autograd:

* ``Li``: m BSDF samples + n light samples, power-2 MIS; BSDF-sampled hits
  go to area measure with a detached geometry factor;
* ``render_secondary_edges`` + ``eval_secondary_edge``: the direct boundary
  integral. A boundary segment (p0 on a silhouette edge, p2 on an emitter),
  three detached traces and one differentiable recompute at the camera-side
  point, the geometric factor (t / dist)(sin phi / sin phi2) cos2, and the
  normal-velocity term dot(n, u2) as ``result - result.detach()``. Sparse
  valid lanes are compacted (``_compact_boundary_lanes``) before the tail;
* ``preprocess_secondary_edges``: Monte-Carlo cell masses for the 3D
  hypercube that guides the edge samples (``self.warpper``), serially or
  over the ranks of a ``parallel.DeviceMesh``.

All masked divisions route through ``_mdiv`` so masked-out lanes never
divide by zero, nor carry 0 * inf = NaN into a gradient.
"""
from __future__ import annotations

import os

import torch

from ..accel.bruteforce import HitRecord
from ..bsdf import all_reflective_one_sided, eval_bsdf, pdf_bsdf, sample_bsdf
from ..core import threefry
from ..core.constants import Epsilon, ShadowEpsilon
from ..core.distribution import (hypercube_init, hypercube_sample_reuse,
                                 hypercube_set_mass)
from ..core.frame import to_local, to_world
from ..core.gather import select_rows
from ..core.hoist import const
from ..core.math import (bilinear, cross, dot, norm, normalize,
                         ray_intersect_triangle, scrub_nonfinite, sqr,
                         squared_norm)
from ..core.records import Ray, detach_tree
from ..core.segsum import segment_sum_sorted
from ..core.sampler import RngStream, ld_2d
from ..program import Program
from ..emitter.envmap import envmap_eval_direction
from ..scene.scene import (FlatScene, Scene, _ray_test_sparse, detach_flat,
                           emitter_position_pdf, ray_intersect,
                           ray_intersect_emitter_first,
                           ray_intersect_with_prior, ray_test,
                           sample_boundary_segment_direct,
                           sample_emitter_position, scene_le)
from ..sensor.perspective import sample_direct, sample_primary_ray
from .base import (Integrator, accumulate_image, scan_lane_chunks,
                   shard_lane_range)


def _stratify2(u2: torch.Tensor, rng: RngStream, which: int) -> torch.Tensor:
    """Improve a uniform 2D sample with the pixel's sample-index structure
    where the interior render attached it (``which`` 0: the NEE pair, 1:
    the BSDF pair, so the consumers decorrelate):

    * ``rng.ld`` (sampler="sobol"): REPLACE u2 by the pixel's scrambled
      (0,2)-sequence point;
    * ``rng.strata`` (sampler="stratified"): warp u2 onto the spp strata
      under a per-pixel rotation; strata = (s_idx, spp, (a, b), rot_nee,
      rot_bsdf). Marginally still uniform.

    Otherwise (the boundary estimators' streams) return u2."""
    if rng.ld is not None:
        s_idx, nee_x, nee_y, bsdf_x, bsdf_y = rng.ld
        if which == 0:
            return ld_2d(s_idx, nee_x, nee_y)
        return ld_2d(s_idx, bsdf_x, bsdf_y)
    if rng.strata is None:
        return u2
    s_idx, spp, (a, b), rot_nee, rot_bsdf = rng.strata
    s = (s_idx + (rot_nee if which == 0 else rot_bsdf)) % spp
    cell = torch.stack([(s % a).float(), (s // a).float()], dim=-1)
    return (cell + u2) / const((a, b), torch.float32, u2.device)


def _mdiv(a, b, mask):
    """a / b with the divisor forced to 1 on masked-out lanes."""
    b = torch.where(mask, b, 1.0)
    return a / b[..., None] if a.ndim > b.ndim else a / b


def _compact_eligibility(m: int, guided: bool = False):
    """(segment, keep) sizes for the compaction of a boundary pass, or None
    when the wavefront does not factor, is too small, or compaction is off
    (``PSDR_TPU_SSE_COMPACT=0``, read at call time).

    Unguided samples pass the validity test rarely (a few percent), so a
    full 32k segment keeps s / 16 lanes; guided streams concentrate on
    valid regions and keep the conservative s / 4, as do the smaller
    segments of small wavefronts. ``PSDR_TPU_SSE_COMPACT_SHIFT`` overrides
    both."""
    s = min(1 << 15, m)
    shift = int(os.environ.get(
        "PSDR_TPU_SSE_COMPACT_SHIFT",
        "4" if (not guided and s == (1 << 15)) else "2"))
    ks = s >> shift
    if (m % s or ks < 256
            or os.environ.get("PSDR_TPU_SSE_COMPACT", "1") != "1"):
        return None
    return s, ks


def _compact_boundary_lanes(valid_eff, edge_coord, u_sel, s: int, ks: int):
    """Keep the first ``ks`` lanes of each ``s``-lane segment after sorting
    valid lanes first by the uniform key ``u_sel`` (a uniformly random
    subset when a segment overflows), then restore edge coherence by
    sorting the kept lanes by ``edge_coord``. Both sorts are stable, as the
    JAX package's: every dead lane carries the key 2.0, and which of them
    fill a segment's tail must not depend on the sort.

    Returns ``(idx, weight, live)``: gather indices into the full wavefront
    (m // s * ks,), the per-lane weight max(1, count / ks) that keeps the
    estimator unbiased (1 when the segment's valid lanes all fit: then the
    compacted estimator is exact), and the kept lanes' liveness."""
    m = valid_eff.shape[0]
    dev = valid_eff.device
    key2 = torch.where(valid_eff, u_sel.detach(), 2.0)
    local = torch.argsort(key2.reshape(m // s, s), dim=1,
                          stable=True)[:, :ks]
    sel = (local + (torch.arange(m // s, device=dev) * s)[:, None]
           ).reshape(-1)
    counts = valid_eff.reshape(m // s, s).sum(dim=1)
    weight = torch.repeat_interleave(
        torch.clamp(counts.float() / ks, min=1.0), ks)
    live_c = valid_eff[sel]
    key3 = torch.where(live_c, edge_coord.detach()[sel], 2.0)
    local2 = torch.argsort(key3.reshape(m // s, ks), dim=1, stable=True)
    sel2 = (local2 + (torch.arange(m // s, device=dev) * ks)[:, None]
            ).reshape(-1)
    # weight is constant over a segment, so the re-sort leaves it in place
    return sel[sel2], weight, live_c[sel2]


def _emitter_meta(scene: Scene):
    meta = [("area", e.mesh_index) if e.kind == "area" else ("env", -1)
            for e in scene.emitters]
    return tuple(meta) if meta else (("area", 0),)


def _sampled_radiance(flat: FlatScene, ps, wo, active):
    """Radiance of a light sample ``ps`` seen along ``wo``: its area
    light's, or the environment map's where the sample's ``emitter`` is
    -1."""
    le = torch.where((ps.emitter >= 0)[..., None],
                     select_rows(flat.emitter_radiance,
                                 torch.clamp(ps.emitter, min=0)), 0.0)
    if flat.envmap is not None:
        is_env = ps.emitter < 0
        le = torch.where(is_env[..., None],
                         envmap_eval_direction(flat.envmap, wo,
                                               active & is_env), le)
    return le


def _emitter_segment_valid(scene: Scene, flat: FlatScene):
    """The detached validity pre-pass of emitter-sampled boundary lanes:
    ``f(sample3, live) -> (m,) bool``."""
    flat_det = detach_flat(flat)
    emeta = _emitter_meta(scene)

    def prepass_valid(sample3, live):
        return sample_boundary_segment_direct(
            flat_det, scene.face_offset, emeta, sample3, live).valid
    return prepass_valid


def _boundary_pass(scene: Scene, key: torch.Tensor, salt: int, warp,
                   prepass_valid, tail, shard=None) -> torch.Tensor:
    """One secondary boundary pass over ``num_pixels * sppse`` lanes ->
    (num_pixels, 3), the frame every edge-sampled estimator shares.

    Per chunk: a stream under ``salt`` draws the (m, 3) samples, sorted by
    the edge-selecting coordinate (iid lanes: the sort preserves the measure
    and groups the lanes of one edge into coherent ray blocks; stable, as
    jnp.argsort) and warped by the guiding table ``warp`` if there is one.
    ``tail(sample3, rng) -> [(pixel_idx, value), ...]`` is the estimator;
    each splat is scrubbed, divided by the guiding pdf above ``Epsilon``
    (1 without a table), weighted, divided by ``sppse`` and summed into the
    image (each lane finds its own pixel).

    Boundary segments are sparse: few unguided samples pass the silhouette
    or emitter validity, yet the estimator's traces would run at full
    width. Where the wavefront factors (``_compact_eligibility``) the cheap
    detached pre-pass ``prepass_valid(sample3, live) -> (m,) bool`` finds
    the valid lanes and the tail runs on the compacted wavefront. A segment
    that holds more than ks valid lanes keeps a uniformly random ks of
    them, weighted by count / ks (on the value, so that the guiding-pdf
    gate keeps its own threshold): unbiased still; below that every valid
    lane is kept once with weight 1 and the pass is exact. The stream's
    order is part of the contract: the samples, then the compaction keys,
    then whatever the tail draws. ``shard=(rank, n_ranks)`` runs only that
    rank's slice of the lanes (``shard_lane_range``)."""
    opts = scene.opts
    num_pixels = opts.num_pixels
    dev = scene.device
    n = num_pixels * opts.sppse

    def eval_tail(sample3_t, pdf0_t, live_t, rng, weight_t=None):
        img = torch.zeros((num_pixels, 3), device=dev)
        for pix, value in tail(sample3_t, rng):
            value = scrub_nonfinite(value)
            guided = pdf0_t > Epsilon
            value = torch.where(
                guided[..., None],
                value / torch.where(guided, pdf0_t, 1.0)[..., None], value)
            if weight_t is not None:
                value = value * weight_t[..., None]
            if opts.sppse > 1:
                value = value / opts.sppse
            img = img + accumulate_image(
                torch.where(live_t[..., None], value, 0.0),
                torch.where(live_t, pix, -1), num_pixels)
        return img

    def run_lanes(lane, key_c):
        rng = RngStream(key_c, salt=salt, device=dev)
        m = lane.shape[0]
        sample3 = rng.next_3d(m)
        sample3 = sample3[torch.argsort(sample3[:, 0], stable=True)]
        if warp is not None:
            sample3, pdf0 = hypercube_sample_reuse(warp, sample3)
        else:
            pdf0 = torch.ones((m,), device=dev)
        live = lane < n
        elig = _compact_eligibility(m, guided=warp is not None)
        if elig is None:
            return eval_tail(sample3, pdf0, live, rng)
        s, ks = elig
        with torch.no_grad():
            v = prepass_valid(sample3, live)
        idx, weight, live_c = _compact_boundary_lanes(
            v & live, sample3[:, 0], rng.next_1d(m), s, ks)
        return eval_tail(sample3[idx], pdf0[idx], live_c, rng,
                         weight_t=weight)

    lane_range = shard_lane_range(n, shard)
    return scan_lane_chunks(run_lanes, n, num_pixels, key, opts.pass_lanes,
                            dev, lane_range=lane_range,
                            remat=opts.resolve_remat(lane_range[1]))


def guiding_programs(integ) -> dict:
    """The integrator's cache of guiding-build programs
    (``_guiding_table``)."""
    return integ.__dict__.setdefault("_guiding_jits", {})


def _guiding_table(scene: Scene, reso, nrounds: int, seed: int, mesh,
                   eval_value, cache: dict, kind, rank_streams: bool = False):
    """Monte-Carlo cell masses of a boundary estimator's guiding hypercube:
    ``reso`` = (r0, r1, r2, samples per cell); each of ``nrounds`` rounds
    puts every cell's samples through ``eval_value(flat_det, sample3, rng)
    -> (n, 3)`` magnitudes and adds the per-cell sums of their largest
    channel. The rounds are a loop without a graph and the per-cell sum a
    fixed-order one (``core.segsum.segment_sum_sorted``: the lanes come in
    cell order).

    All rounds run as one ``Program`` over the key (``PRNGKey(seed)`` on
    the scene's device; the JAX package's jitted ``lax.scan``), kept in
    ``cache`` (a dict, ``guiding_programs(integrator)``) under ``kind``
    (what ``eval_value`` evaluates), the scene, its flat scene and opts,
    the table's size and the rank: a build again with another seed
    replays it. The program's body holds the flat scene, so its identity
    is not reused while the entry lives (a scene rebuilt after
    ``set_params`` or ``maybe_rebuild_accel`` gets a new program). The
    cache is cleared when it holds more than 16.

    ``mesh`` (a ``parallel.DeviceMesh``) splits the cell x sample lanes into
    one contiguous slice a rank, and the per-cell masses are summed over
    the ranks, so every rank holds the same table. Each rank draws the
    whole domain's uniforms and keeps its slice: a lane sees the serial
    build's uniform and the table equals the serial one up to the order of
    the sums. With ``rank_streams`` (an estimator that draws more per lane,
    the indirect one) each rank's lanes draw from ``fold_in(key, rank)``
    instead: the table is the serial one in distribution only."""
    if nrounds <= 0:
        raise ValueError("nrounds must be positive")
    reso = tuple(int(r) for r in reso)
    dev = scene.device
    hc = hypercube_init(reso[:3], device=dev)
    num_cells = hc.num_cells
    spp_cell = reso[3]
    n = num_cells * spp_cell
    # a rank's slice; the last one's lanes past n add to an overflow cell
    start, count = shard_lane_range(
        n, None if mesh is None else (mesh.rank, mesh.size))
    flat = scene.flat
    k = (kind, id(scene), id(flat), scene.opts, reso, nrounds,
         None if mesh is None else (mesh.rank, mesh.size))
    prog = cache.get(k)
    if prog is None:
        if len(cache) > 16:
            cache.clear()
        lanes = start + torch.arange(count, device=dev)
        idx = torch.where(lanes < n, lanes // spp_cell, num_cells)
        base = hc.cells[torch.clamp(idx, max=num_cells - 1)].float()
        # the lanes' cells ascend (the overflow cell last): sorted keys of a
        # fixed-order sum, which then needs no sort
        cell_keys = idx.to(torch.int32)

        def masses(key):
            """Every round's cell masses, summed (rank ``mesh.rank``'s
            share)."""
            flat_det = detach_flat(flat)
            mass = torch.zeros((num_cells + 1,), device=dev)
            keys = threefry.split(key, nrounds)
            for r in range(nrounds):
                if rank_streams and mesh is not None:
                    rng = RngStream(threefry.fold_in(keys[r], mesh.rank),
                                    device=dev)
                    u3 = rng.next_3d(count)
                else:
                    rng = RngStream(keys[r], device=dev)
                    u3 = rng.next_3d(max(n, start + count))[
                        start:start + count]
                value0 = scrub_nonfinite(eval_value(
                    flat_det, (base + u3) * hc.unit, rng))
                if spp_cell > 1:
                    value0 = value0 / spp_cell
                mass = mass + segment_sum_sorted(
                    cell_keys, value0.amax(dim=-1)[:, None].contiguous(),
                    num_cells + 1).reshape(-1)
            return mass[:num_cells]

        prog = cache[k] = Program(masses, f"guiding table ({kind})")
    mass = prog(threefry.PRNGKey(seed, device=dev))
    with torch.no_grad():
        if mesh is not None:
            mesh.all_reduce(mass)
        if nrounds > 1:
            mass = mass / nrounds
    return hypercube_set_mass(hc, mass)


class DirectIntegrator(Integrator):
    def __init__(self, bsdf_samples: int = 1, light_samples: int = 1,
                 hide_emitters: bool = False):
        if bsdf_samples < 0 or light_samples < 0:
            raise ValueError("sample counts must be non-negative")
        if bsdf_samples + light_samples == 0:
            raise ValueError("DirectIntegrator needs a BSDF or light sample")
        self.bsdf_samples = bsdf_samples
        self.light_samples = light_samples
        self.hide_emitters = hide_emitters
        self.warpper: dict = {}   # per-sensor guiding HyperCube

    def Li(self, scene: Scene, flat: FlatScene, rng: RngStream, ray: Ray,
           active: torch.Tensor, prior=None) -> torch.Tensor:
        kinds = scene.bsdf_kinds
        emeta = _emitter_meta(scene)
        offsets = scene.face_offset
        n = ray.o.shape[0]
        dev = ray.o.device

        # solid-angle formulation, tmax-bounded under the camera-hit prior
        its = ray_intersect_with_prior(flat, ray, active, prior)
        active = active & its.valid

        result = (torch.zeros((n, 3), device=dev) if self.hide_emitters
                  else scene_le(flat, its, active))
        if flat.envmap is not None:
            # no reflectance on hits of the env bounding mesh
            active = active & (its.bsdf_id >= 0)

        for k in range(self.bsdf_samples):
            u3 = rng.next_3d(n)
            if k == 0:
                u3 = torch.cat([_stratify2(u3[:, 0:2], rng, which=1),
                                u3[:, 2:]], dim=1)
            bs = sample_bsdf(kinds, flat.bsdfs, its, u3, active)
            active1 = active & bs.valid

            ray1 = Ray(its.p, to_world(its.sh_frame, bs.wo))
            # the bounce hit only matters where it lands on an emitter, so
            # the full-scene closest hit reduces to emitter-hit + occlusion
            if flat.em_tri_idx is not None:
                its1 = ray_intersect_emitter_first(flat, ray1, active1)
            else:
                its1 = ray_intersect(flat, ray1, active1, path_space=True,
                                     sort_rays=True)
            active1 = active1 & its1.valid & its1.is_emitter()

            # area-measure conversion with detached G
            wo = _mdiv(its1.p - its.p, its1.t, active1)
            bsdf_val = eval_bsdf(kinds, flat.bsdfs, its,
                                 to_local(its.sh_frame, wo), active1)
            cos_val = dot(its1.n, -wo)
            G_val = _mdiv(torch.abs(cos_val), sqr(its1.t), active1)
            pdf0 = bs.pdf * G_val.detach()
            bsdf_val = bsdf_val * _mdiv(G_val * its1.J, pdf0,
                                        active1)[..., None]

            weight = torch.full((n,), 1.0 / self.bsdf_samples, device=dev)
            if self.light_samples > 0:
                pdf_nee = emitter_position_pdf(flat, emeta, its.p, its1,
                                               active1)
                w_num = sqr(pdf0)
                w_den = w_num + sqr(pdf_nee)
                weight = weight * _mdiv(w_num, w_den, active1 & (w_den > 0.0))
            contrib = scene_le(flat, its1, active1) * bsdf_val * weight[..., None]
            result = result + torch.where(active1[..., None], contrib, 0.0)

        for k in range(self.light_samples):
            u2 = rng.next_2d(n)
            if k == 0:
                u2 = _stratify2(u2, rng, which=0)
            ps = sample_emitter_position(flat, offsets, emeta, its.p, u2,
                                         active)
            active1 = active & ps.valid

            wo = ps.p - its.p
            dist_sqr = squared_norm(wo)
            dist = torch.sqrt(torch.clamp(dist_sqr, min=1e-20))
            wo = wo / dist[..., None]

            # Side gate: a light sample behind the emitter (cos <= 0), or
            # below the shading horizon when every BSDF is reflective
            # one-sided, contributes zero whether occluded or not, so it
            # need not trace. Exact.
            cos_val = dot(ps.n, -wo)
            is_env = ps.emitter < 0
            side_ok = is_env | (cos_val > 0.0)
            if all_reflective_one_sided(kinds):
                side_ok = (side_ok
                           & (to_local(its.sh_frame, wo).detach()[..., 2] > 0.0)
                           & (its.wi.detach()[..., 2] > 0.0))
            active1 = active1 & side_ok

            vis = self._nee_visibility(flat, rng, its.p, wo, dist, active1, n)
            if vis is None:
                occluded = ray_test(flat, Ray(its.p, wo), dist, active1,
                                    sort_rays=flat.envmap is not None)
                active1 = active1 & ~occluded
            else:
                active1 = active1 & (vis != 0.0)

            le = _sampled_radiance(flat, ps, wo, active1)

            G_val = _mdiv(torch.abs(cos_val), dist_sqr, active1)
            wo_local = to_local(its.sh_frame, wo)
            bsdf_val = eval_bsdf(kinds, flat.bsdfs, its, wo_local, active1)
            pdf1 = pdf_bsdf(kinds, flat.bsdfs, its, wo_local, active1)
            bsdf_val = bsdf_val * _mdiv(G_val * ps.J, ps.pdf,
                                        active1)[..., None]
            pdf1 = pdf1 * G_val.detach()

            weight = torch.full((n,), 1.0 / self.light_samples, device=dev)
            if self.bsdf_samples > 0:
                w_num = sqr(ps.pdf)
                w_den = w_num + sqr(pdf1)
                weight = weight * _mdiv(w_num, w_den, active1 & (w_den > 0.0))
            contrib = le * bsdf_val * weight[..., None]
            if vis is not None:
                contrib = contrib * vis[..., None]
            result = result + torch.where(active1[..., None], contrib, 0.0)

        return result

    @staticmethod
    def _sparse_or_plain_test(flat, p, wo, dist, active, frac_shift: int):
        """``ray_test`` with the compaction's cap at ``s >> frac_shift``
        lanes of a segment (``ray_test``'s own is an eighth) under K1,
        else a plain sweep."""
        if flat.accel is not None and flat.accel_kind == "pallas":
            occ = _ray_test_sparse(flat, Ray(p, wo),
                                   dist.detach() - ShadowEpsilon, active,
                                   frac_shift=frac_shift)
            if occ is not None:
                return occ & active
        return ray_test(flat, Ray(p, wo), dist, active)

    def _nee_visibility(self, flat, rng, p, wo, dist, active1, n):
        return DirectIntegrator._nee_visibility_impl(
            flat, rng, p, wo, dist, active1, n,
            light_samples=self.light_samples)

    @staticmethod
    def _nee_visibility_impl(flat, rng, p, wo, dist, active1, n,
                             light_samples):
        """Unbiased NEE visibility reuse across a pixel's spp strata.
        Control variate: a reference visibility V_ref per pixel, and a
        traced subset of the other strata with k-weighted corrections
            V_hat_i = V_ref + (V_i - V_ref) * B_i * k
        (E[V_hat_i] = V_i for any V_ref).

        Modes (``PSDR_TPU_VIS_REUSE``, read at call time; ``..._Q`` sets q,
        ``..._KPEN`` the penumbra stride):
        * "edge" (default): strata {0, spp/2} probe every pixel; probe
          disagreement or a +-1/+-2 chunk-order neighbour with another probe
          result marks penumbra; the other strata are subsampled every
          k-th from a per-pixel random offset, k = k_pen (4) in penumbra
          and round(1/q) (32) elsewhere.
        * "bern": stratum 0 traces, every other stratum with probability q.
        * "off" (or no pixel structure): None -> the caller traces all.
        Returns per-lane float visibility, or None."""
        mode = os.environ.get("PSDR_TPU_VIS_REUSE", "edge")
        q = float(os.environ.get("PSDR_TPU_VIS_REUSE_Q", "0"))
        if q > 0.0 and "PSDR_TPU_VIS_REUSE" not in os.environ:
            mode = "bern"     # Q alone selects the q-only mode
        spp = rng.vis_spp
        if (mode not in ("bern", "edge") or not spp or spp <= 1 or n % spp
                or light_samples != 1):
            return None
        if flat.envmap is not None and mode != "edge":
            # bern needs V_i ~ V_ref, which envmap NEE (per-stratum
            # directions spread over the sphere) lacks
            return None
        if mode == "bern" and q <= 0.0:
            return None
        dev = p.device
        npix = n // spp
        s_idx = torch.arange(n, device=dev) % spp
        first = s_idx == 0
        zero = torch.zeros((), device=dev)
        if mode == "bern":
            bern = rng.next_1d(n) < q
            do_trace = active1 & (first | bern)
            occ = ray_test(flat, Ray(p, wo), dist, do_trace, sparse=True)
            V = torch.where(do_trace, 1.0 - occ.float(), zero)
            V_ref = torch.repeat_interleave(V.reshape(npix, spp)[:, 0], spp)
            corr = torch.where(bern, (V - V_ref) * (1.0 / q), zero)
            return torch.where(first, V, V_ref + corr)

        # --- edge mode ---------------------------------------------------
        k_smooth = max(2, int(round(1.0 / q)) if q > 0.0 else 32)
        k_pen = max(1, int(os.environ.get("PSDR_TPU_VIS_REUSE_KPEN", "4")))
        h = spp // 2
        probe = first | (s_idx == h)
        act0 = active1 & probe
        occ0 = ray_test(flat, Ray(p, wo), dist, act0, sparse=True)
        V0 = torch.where(act0, 1.0 - occ0.float(), zero)
        Vrows = V0.reshape(npix, spp)
        Arows = act0.reshape(npix, spp)
        W = Vrows[:, 0] + Vrows[:, h]                   # 0 / 1 / 2
        Aok = Arows[:, 0] & Arows[:, h]
        smooth = Aok & (W != 1.0)
        for off in (1, 2, -1, -2):
            smooth = (smooth & (torch.roll(W, off) == W)
                      & torch.roll(Aok, off))
        # reference = mean of the two probes
        V_ref = torch.repeat_interleave(0.5 * W, spp)
        u_pix = rng.next_1d(n).reshape(npix, spp)[:, 0]
        k_lane = torch.repeat_interleave(
            torch.where(~smooth, k_pen, k_smooth), spp)
        r_lane = torch.repeat_interleave(
            (u_pix * k_pen * k_smooth).to(torch.int32), spp)
        B = (s_idx % k_lane) == (r_lane % k_lane)
        trace2 = active1 & ~probe & B
        # penumbra lanes cluster in the same sort segments: a quarter-size
        # cap, not ray_test's eighth
        occ2 = DirectIntegrator._sparse_or_plain_test(flat, p, wo, dist,
                                                      trace2, frac_shift=2)
        V2 = torch.where(trace2, 1.0 - occ2.float(), zero)
        corr = torch.where(B, (V2 - V_ref) * k_lane.float(), zero)
        return torch.where(probe, V0, V_ref + corr)

    # -- secondary boundary ------------------------------------------------------
    def render_secondary_edges(self, scene: Scene, flat: FlatScene,
                               sensor_id: int, key: torch.Tensor,
                               shard=None) -> torch.Tensor:
        """The secondary-edge (shadow) boundary term -> (num_pixels, 3),
        zero in the primal."""
        def tail(sample3_t, rng):
            # the emitter-first trace, the opposite closest hit, the camera
            # any-hit, the BSDF and the AD term
            return [self.eval_secondary_edge(scene, flat, sensor_id,
                                             sample3_t, ad=True)]

        return _boundary_pass(scene, key, 2, self.warpper.get(sensor_id),
                              _emitter_segment_valid(scene, flat), tail,
                              shard)

    def eval_secondary_edge(self, scene: Scene, flat: FlatScene,
                            sensor_id: int, sample3: torch.Tensor, ad: bool):
        """Returns (pixel_idx, value). ``ad=False`` is the guiding variant:
        the value's magnitude without the normal-velocity factor, and
        pixel_idx all -1."""
        kinds = scene.bsdf_kinds
        emeta = _emitter_meta(scene)
        offsets = scene.face_offset
        sensor = flat.sensors[sensor_id]
        dev = sample3.device

        bss = sample_boundary_segment_direct(
            flat, offsets, emeta, sample3,
            torch.ones(sample3.shape[:-1], dtype=torch.bool, device=dev))
        valid = bss.valid

        _p0 = bss.p0.detach()
        _p2 = bss.p2  # already detached
        _dir = normalize(_p2 - _p0)

        # visibility p0 -> p2, with the differentiable TriangleInfo of the
        # hit. The segment is valid only when the closest hit IS the emitter
        # point p2, so the emitter-first query (a tiny emitter closest hit +
        # an occlusion sweep) replaces the full-scene closest hit exactly
        if flat.em_tri_idx is not None:
            its2_full, tri_info = ray_intersect_emitter_first(
                flat, Ray(_p0, _dir), valid, want_tri_info=True)
        else:  # more than 8192 emitter faces: the dense sweep loses
            its2_full, tri_info = ray_intersect(
                flat, Ray(_p0, _dir), valid, path_space=True,
                want_tri_info=True)
        _its2 = detach_tree(its2_full)
        valid = valid & _its2.valid & (norm(_its2.p - _p2) < ShadowEpsilon)

        # the opposite trace completes the boundary segment (p1, p2); the
        # lanes are edge-sorted already
        with torch.no_grad():
            _its1 = detach_tree(ray_intersect(flat, Ray(_p0, -_dir), valid,
                                              path_space=True))
        valid = valid & _its1.valid
        _p1 = _its1.p

        # project p1 to the image plane
        sds = sample_direct(sensor, _p1)
        valid = valid & sds.valid

        # differentiable camera ray toward p1 (sds.q itself is detached;
        # gradients enter through the sensor matrices). The camera trace
        # only needs "is p1 visible" and a differentiable recompute at p1,
        # whose triangle the opposite trace has found: a tmax-bounded
        # any-hit and a known-triangle recompute replace a full closest
        # hit; the epsilon check below keeps the same accept set
        cam_sensor = sensor if ad else detach_tree(sensor)
        camera_ray = sample_primary_ray(cam_sensor, sds.q)
        t_cam = norm(_p1 - camera_ray.o.detach())
        occluded = ray_test(flat, camera_ray, t_cam, valid, sparse=True)
        vis = valid & ~occluded
        known = HitRecord(valid=vis,
                          tri_id=torch.where(vis, _its1.tri_id, -1),
                          uv=torch.zeros(vis.shape + (2,), device=dev),
                          t=t_cam)
        its1 = ray_intersect(flat, camera_ray, vis, path_space=False,
                             hit=known)
        valid = vis & its1.valid & (norm(its1.p.detach() - _p1)
                                    < ShadowEpsilon)

        # geometric base value
        dist = norm(_p2 - _p1)
        cos2 = torch.abs(dot(bss.n, -_dir))
        e = cross(bss.edge, _dir)
        sinphi = norm(e)
        proj = normalize(cross(e, bss.n))
        sinphi2 = norm(cross(_dir, proj))
        base_v = (_mdiv(_its1.t, dist, valid) * _mdiv(sinphi, sinphi2, valid)
                  * cos2)
        valid = valid & (sinphi > Epsilon) & (sinphi2 > Epsilon)

        # detached BSDF at p1
        bsdfs_det = detach_tree(flat.bsdfs)
        d0 = -camera_ray.d.detach()
        d0_local = to_local(_its1.sh_frame, d0)
        bsdf_val = eval_bsdf(kinds, bsdfs_det, _its1, d0_local, valid)
        corr_num = _its1.wi[..., 2] * dot(d0, _its1.n)
        corr_den = d0_local[..., 2] * dot(_dir, _its1.n)
        correction = torch.abs(_mdiv(corr_num, corr_den,
                                     valid & (corr_den != 0.0)))
        bsdf_val = bsdf_val * correction[..., None]

        le = scene_le(flat, _its2, valid).detach()
        value0 = bsdf_val * le * (base_v * sds.sensor_val)[..., None]
        value0 = _mdiv(value0, bss.pdf, valid & (bss.pdf > 0.0))
        value0 = torch.where(valid[..., None], value0, 0.0)

        if not ad:
            return (torch.full(valid.shape, -1, dtype=torch.int32,
                               device=dev), value0)

        # AD normal-velocity term
        nrm = normalize(cross(bss.n, proj))
        value0 = value0 * (torch.sign(dot(e, bss.edge2))
                           * torch.sign(dot(e, nrm)))[..., None]

        v0, e1, e2 = tri_info.p0, tri_info.e1, tri_info.e2
        sh_dir = normalize(bss.p0 - its1.p)
        uv, _ = ray_intersect_triangle(v0, e1, e2, its1.p, sh_dir)
        u2 = bilinear(v0.detach(), e1.detach(), e2.detach(), uv)

        result = value0.detach() * dot(nrm.detach(), u2)[..., None]
        result = torch.where(valid[..., None], result, 0.0)
        pix = torch.where(valid, sds.pixel_idx, -1)
        return pix, result - result.detach()

    # -- guiding -------------------------------------------------------------------
    def preprocess_secondary_edges(self, scene: Scene, sensor_id: int,
                                   reso, nrounds: int = 1, seed: int = 0,
                                   mesh=None) -> None:
        """Build the secondary-edge guiding hypercube of ``sensor_id`` into
        ``self.warpper`` from ``eval_secondary_edge(ad=False)``
        (``_guiding_table``); with ``mesh`` (a ``parallel.DeviceMesh``) the
        lanes are split over its ranks and the masses summed, equal to the
        serial build's."""
        def eval_value(flat, sample3, rng):
            return self.eval_secondary_edge(scene, flat, sensor_id, sample3,
                                            ad=False)[1]

        self.warpper[sensor_id] = _guiding_table(
            scene, reso, nrounds, seed, mesh, eval_value,
            guiding_programs(self), ("secondary", sensor_id,
                                     self.bsdf_samples, self.light_samples,
                                     self.hide_emitters))
