"""Depth-N path tracer with next-event estimation and MIS, and its boundary
estimators. Counterpart of ``psdr_tpu/integrator/path.py``.

* ``Li``: per bounce one light sample and one BSDF continuation sample under
  the power-2 MIS heuristic, with a path throughput. BSDF-sampled hits go to
  area measure with a detached geometry factor and are multiplied by the
  reparameterization Jacobian J of each hit, so interior gradients of vertex
  positions flow through the differentiable hit recompute at every bounce.
  Every lane stays live under masks; dead lanes carry zero throughput.
* The direct boundary estimator (emitter-sampled far side) applies as it is.
  ``eval_secondary_edge_indirect`` samples a direction at the edge instead
  of an emitter point, finds the far-side surface and reads a detached
  multi-bounce radiance estimate without that surface's own emission.
  ``eval_secondary_edge_camera`` sees the receiver point through up to
  ``camera_depth - 1`` extra bounces: a detached importance walk from it
  with one camera connection a walk depth. ``_render_boundary_fused`` runs
  both on one sample stream per far-side kind.
* ``preprocess_indirect_edges``: the guiding table of the indirect term
  (``self.ind_warpper``).

The depth loop is a Python loop (``scan_depths`` is taken for the JAX
package's call sites and changes nothing: every depth draws from
``fold_in(depth_base, depth)``).
"""
from __future__ import annotations

import math
import os
from typing import NamedTuple

import torch

from ..accel.bruteforce import HitRecord
from ..bsdf import all_reflective_one_sided, eval_bsdf, pdf_bsdf, sample_bsdf
from ..core import threefry
from ..core.constants import EdgeEpsilon, Epsilon, ShadowEpsilon
from ..core.distribution import discrete_sample_reuse, hypercube_set_mass
from ..core.frame import to_local, to_world
from ..core.math import (bilinear, cross, dot, norm, normalize,
                         ray_intersect_triangle, sign_eps, sqr, squared_norm)
from ..core.records import Ray, detach_tree
from ..core.sampler import RngStream
from ..core.warp import square_to_uniform_sphere
from ..scene.scene import (FlatScene, Scene, detach_flat,
                           emitter_position_pdf, ray_intersect,
                           ray_intersect_emitter_first,
                           ray_intersect_with_prior, ray_test,
                           sample_boundary_segment_direct,
                           sample_emitter_position, scene_le, sec_edge_rows)
from ..sensor.perspective import sample_direct, sample_primary_ray
from .base import Integrator
from .direct import (DirectIntegrator, _boundary_pass, _emitter_meta,
                     _emitter_segment_valid, _guiding_table, _mdiv,
                     _sampled_radiance, _stratify2, guiding_programs)


def _silhouette(info, ok, d):
    """Whether direction ``d`` sees each sampled edge as a silhouette: a
    boundary edge from off its face's plane, an interior edge from between
    its two faces' planes."""
    s0 = sign_eps(dot(info.n0, d), EdgeEpsilon)
    s1 = sign_eps(dot(info.n1, d), EdgeEpsilon)
    return ok & torch.where(info.is_boundary, s0 != 0, s0 * s1 < 0)


def _direction_segment_valid(flat_det: FlatScene, sample3: torch.Tensor
                             ) -> torch.Tensor:
    """Detached silhouette validity of direction-sampled boundary lanes: the
    sampling pre-pass twin of ``_sample_edge_direction``. It must stay in
    lockstep with that function's edge and direction draws; it reads the
    detached columns of the edge table only."""
    edge_idx, _, _ = discrete_sample_reuse(flat_det.sec_distrb,
                                           sample3[..., 0])
    info, ok = sec_edge_rows(flat_det, edge_idx, with_ends=False)
    return _silhouette(info, ok,
                       square_to_uniform_sphere(sample3[..., 1:3]))


class _EdgeDirSample(NamedTuple):
    """A direction-sampled boundary segment's near end."""
    valid: torch.Tensor
    p0: torch.Tensor     # edge point, differentiable
    edge: torch.Tensor   # normalized edge direction (detached)
    edge2: torch.Tensor  # opposite vertex minus first endpoint (detached)
    d: torch.Tensor      # the sampled direction
    pdf: torch.Tensor    # edge point (per length) x direction (solid angle)


def _sample_edge_direction(flat: FlatScene, sample3: torch.Tensor
                           ) -> _EdgeDirSample:
    """An edge point (differentiable in p0) and a uniform direction on the
    sphere; valid where the direction sees the edge as a silhouette. The
    columns that carry the gradient are gathered apart from the detached
    rest (``sec_edge_rows``)."""
    edge_idx, pdf0, s1 = discrete_sample_reuse(flat.sec_distrb,
                                               sample3[..., 0])
    info, ok = sec_edge_rows(flat, edge_idx)
    p0 = info.p0 + info.e1 * s1[..., None]
    e1_det = info.e1.detach()
    pdf0 = pdf0 / torch.clamp(norm(e1_det), min=1e-20)
    d = square_to_uniform_sphere(sample3[..., 1:3])
    return _EdgeDirSample(valid=_silhouette(info, ok, d), p0=p0,
                          edge=normalize(e1_det),
                          edge2=info.p2 - info.p0.detach(), d=d,
                          pdf=pdf0 / (4.0 * math.pi))


def _adjoint_bsdf(kinds, bsdfs_det, its, wo_world, active):
    """f * cos(wo) with the adjoint shading-normal correction, at a vertex
    of the sensor subpath."""
    wo_local = to_local(its.sh_frame, wo_world)
    f = eval_bsdf(kinds, bsdfs_det, its, wo_local, active)
    inc_world = to_world(its.sh_frame, its.wi)
    num = its.wi[..., 2] * dot(wo_world, its.n)
    den = wo_local[..., 2] * dot(inc_world, its.n)
    corr = torch.abs(_mdiv(num, den, active & (den != 0.0)))
    return f * corr[..., None]


def _trace_detached(flat: FlatScene, ray: Ray, active: torch.Tensor):
    """A path-space closest hit read detached (no graph, no tangent)."""
    with torch.no_grad():
        return detach_tree(ray_intersect(flat, ray, active, path_space=True))


def _connect_camera(flat: FlatScene, sensor, its, active):
    """Camera connection at the detached vertex ``its``: the target triangle
    is known, so a tmax-bounded any-hit and a known-triangle recompute
    replace a full closest hit; the epsilon check keeps the same accept
    set. Returns (valid, SensorDirectSample, the differentiable camera ray,
    the differentiable hit at the vertex)."""
    sds = sample_direct(sensor, its.p)
    valid = active & sds.valid
    camera_ray = sample_primary_ray(sensor, sds.q)
    t_cam = norm(its.p - camera_ray.o.detach())
    occluded = ray_test(flat, camera_ray, t_cam, valid, sparse=True)
    vis = valid & ~occluded
    known = HitRecord(valid=vis, tri_id=torch.where(vis, its.tri_id, -1),
                      uv=torch.zeros(vis.shape + (2,), device=its.p.device),
                      t=t_cam)
    itsc = ray_intersect(flat, camera_ray, vis, path_space=False, hit=known)
    valid = vis & itsc.valid & (norm(itsc.p.detach() - its.p) < ShadowEpsilon)
    return valid, sds, camera_ray, itsc


def _normal_velocity(tri_info, p0, p, nrm):
    """dot(n, u2): the far-side point's velocity along the boundary normal,
    u2 being the point where the line from ``p`` through the moving edge
    point ``p0`` meets the far triangle, held at the triangle's detached
    position."""
    v0, e1, e2 = tri_info.p0, tri_info.e1, tri_info.e2
    uv, _ = ray_intersect_triangle(v0, e1, e2, p, normalize(p0 - p))
    u2 = bilinear(v0.detach(), e1.detach(), e2.detach(), uv)
    return dot(nrm.detach(), u2)


class PathTracer(Integrator):
    """Unidirectional path tracer: NEE + BSDF sampling with MIS per bounce.

    ``max_depth`` counts segments: 1 reproduces DirectIntegrator's
    estimator (camera hit + one bounce of lighting). ``camera_depth`` >= 2
    adds the camera-side boundary estimators: discontinuities whose
    receiver point is seen through up to camera_depth - 1 extra bounces.
    ``scan_depths`` is accepted and ignored (see the module docstring)."""

    def __init__(self, max_depth: int = 3, hide_emitters: bool = False,
                 camera_depth: int = 1, scan_depths: bool | None = None):
        if max_depth < 1 or camera_depth < 1:
            raise ValueError("max_depth and camera_depth must be positive")
        self.max_depth = max_depth
        self.hide_emitters = hide_emitters
        self.camera_depth = camera_depth
        self.scan_depths = scan_depths
        self.warpper: dict = {}       # per-sensor guiding HyperCube, direct
        self.ind_warpper: dict = {}   # ... and of the indirect term

    def Li(self, scene: Scene, flat: FlatScene, rng: RngStream, ray: Ray,
           active: torch.Tensor, prior=None) -> torch.Tensor:
        kinds = scene.bsdf_kinds
        emeta = _emitter_meta(scene)
        offsets = scene.face_offset
        n = ray.o.shape[0]
        dev = ray.o.device
        one_sided = all_reflective_one_sided(kinds)

        its = ray_intersect_with_prior(flat, ray, active, prior)
        active = active & its.valid

        result = (torch.zeros((n, 3), device=dev) if self.hide_emitters
                  else scene_le(flat, its, active))
        beta = torch.ones((n, 3), device=dev)  # path throughput
        if flat.envmap is not None:
            active = active & (its.bsdf_id >= 0)

        # every draw of a depth folds (depth, draw id) from one subkey; row
        # i of split(k, n) is fold_in(k, i), so each level of keys is one
        # hash (one vectorised hash in the tensor-word mode)
        D = self.max_depth
        depth_keys = threefry.split(rng._subkey(), D)

        def depth_body(state, kd, first: bool, last: bool):
            its, beta, active, result = state
            kd = threefry.split(kd, 2)
            # --- NEE via an occlusion test ---
            if first and rng.ld is not None:
                # the first bounce's samples ride the pixel's scrambled
                # sequence; the uniform draw they replace has a key of its
                # own, so leaving it out moves no other draw
                u2 = _stratify2(None, rng, which=0)
            else:
                u2 = threefry.uniform(kd[0], (n, 2), dev)
                if first:
                    u2 = _stratify2(u2, rng, which=0)
            ps = sample_emitter_position(flat, offsets, emeta, its.p, u2,
                                         active)
            active_l = active & ps.valid

            wo = ps.p - its.p
            dist_sqr = squared_norm(wo)
            dist = torch.sqrt(torch.clamp(dist_sqr, min=1e-20))
            wo = wo / dist[..., None]

            # zero-contribution side gates before the occlusion trace (see
            # DirectIntegrator.Li). Exact.
            cos_l = dot(ps.n, -wo)
            active_l = active_l & ((ps.emitter < 0) | (cos_l > 0.0))
            if one_sided:
                active_l = (active_l
                            & (to_local(its.sh_frame, wo).detach()[..., 2] > 0.0)
                            & (its.wi.detach()[..., 2] > 0.0))
            # visibility reuse at the first bounce (camera hits are pixel-
            # coherent; later bounces decorrelate), else the plain sweep
            vis = None
            if first:
                vis = DirectIntegrator._nee_visibility_impl(
                    flat, rng, its.p, wo, dist, active_l, n, light_samples=1)
            if vis is None:
                occluded = ray_test(flat, Ray(its.p, wo), dist, active_l,
                                    sort_rays=flat.envmap is not None)
                active_l = active_l & ~occluded
            else:
                active_l = active_l & (vis != 0.0)

            le = _sampled_radiance(flat, ps, wo, active_l)

            G_l = _mdiv(torch.abs(cos_l), dist_sqr, active_l)
            wo_local = to_local(its.sh_frame, wo)
            f_l = eval_bsdf(kinds, flat.bsdfs, its, wo_local, active_l)
            pdf_b = pdf_bsdf(kinds, flat.bsdfs, its, wo_local, active_l)
            f_l = f_l * _mdiv(G_l * ps.J, ps.pdf, active_l)[..., None]
            pdf_b_area = pdf_b * G_l.detach()

            w_den = sqr(ps.pdf) + sqr(pdf_b_area)
            w_l = _mdiv(sqr(ps.pdf), w_den, active_l & (w_den > 0.0))
            contrib = le * f_l * w_l[..., None]
            if vis is not None:
                contrib = contrib * vis[..., None]
            result = result + torch.where(active_l[..., None],
                                          beta * contrib, 0.0)

            # --- BSDF continuation ---
            u3 = threefry.uniform(kd[1], (n, 3), dev)
            if first:
                u3 = torch.cat([_stratify2(u3[:, 0:2], rng, which=1),
                                u3[:, 2:]], dim=1)
            bs = sample_bsdf(kinds, flat.bsdfs, its, u3, active)
            active_b = active & bs.valid

            ray_b = Ray(its.p, to_world(its.sh_frame, bs.wo))
            if last and flat.em_tri_idx is not None:
                # the final bounce has no continuation: only the MIS-
                # weighted emitter hit reads its_b, so the full-scene
                # closest hit reduces to emitter hit + occlusion
                its_b = ray_intersect_emitter_first(flat, ray_b, active_b)
            else:
                its_b = ray_intersect(flat, ray_b, active_b, path_space=True,
                                      sort_rays=True)
            hit_b = active_b & its_b.valid

            wo_b = _mdiv(its_b.p - its.p, its_b.t, hit_b)
            f_b = eval_bsdf(kinds, flat.bsdfs, its,
                            to_local(its.sh_frame, wo_b), hit_b)
            cos_b = dot(its_b.n, -wo_b)
            G_b = _mdiv(torch.abs(cos_b), sqr(its_b.t), hit_b)
            pdf0 = bs.pdf * G_b.detach()
            # throughput update: f * G * J / pdf (area measure)
            w_path = _mdiv(G_b * its_b.J, pdf0, hit_b & (pdf0 > 0.0))
            f_over_pdf = f_b * w_path[..., None]

            # emitter hit along the BSDF ray -> MIS-weighted emission
            hit_em = hit_b & its_b.is_emitter()
            pdf_nee = emitter_position_pdf(flat, emeta, its.p, its_b, hit_em)
            w_den_b = sqr(pdf0) + sqr(pdf_nee)
            w_b = _mdiv(sqr(pdf0), w_den_b, hit_em & (w_den_b > 0.0))
            contrib_b = (scene_le(flat, its_b, hit_em) * f_over_pdf
                         * w_b[..., None])
            result = result + torch.where(hit_em[..., None],
                                          beta * contrib_b, 0.0)

            # advance the path (dead on the last bounce; with emitter-first
            # its_b is then valid on emitter lanes only and must not feed a
            # continuation)
            if not last:
                beta = torch.where(hit_b[..., None], beta * f_over_pdf, 0.0)
                active = (hit_b & (its_b.bsdf_id >= 0)
                          & (beta.detach() > 0.0).any(dim=-1))
                its = its_b
            return its, beta, active, result

        state = (its, beta, active, result)
        for d in range(D):
            state = depth_body(state, depth_keys[d], first=(d == 0),
                               last=(d == D - 1))
        return state[3]

    # -- boundary terms ------------------------------------------------------
    def render_secondary_edges(self, scene: Scene, flat: FlatScene,
                               sensor_id: int, key: torch.Tensor,
                               shard=None) -> torch.Tensor:
        """The secondary boundary terms -> (num_pixels, 3), zero in the
        primal. With the camera-side estimators on, each far-side kind runs
        ONE pass in which the s = 1 and s >= 2 estimators share the sample
        stream, the validity pre-pass, the compaction, the far trace (and
        the detached far-side radiance), the anchor trace and the edge-local
        kernel: sharing samples correlates the terms and leaves their sum
        unbiased. The separate per-estimator passes run when a sub-pass is
        replaced on the instance (a test seam) or under
        ``PSDR_TPU_FUSED_BOUNDARY=0`` (read at call time)."""
        fused = (self.camera_depth > 1
                 and "render_camera_edges" not in self.__dict__
                 and "render_indirect_edges" not in self.__dict__
                 and os.environ.get("PSDR_TPU_FUSED_BOUNDARY", "1") == "1")
        if fused:
            img = self._render_boundary_fused(scene, flat, sensor_id, key,
                                              "emitter", shard)
            if self.max_depth > 1:
                img = img + self._render_boundary_fused(
                    scene, flat, sensor_id, threefry.fold_in(key, 7),
                    "direction", shard)
            return img
        helper = DirectIntegrator(1, 1)
        helper.warpper = self.warpper
        img = helper.render_secondary_edges(scene, flat, sensor_id, key,
                                            shard)
        if self.max_depth > 1:
            img = img + self.render_indirect_edges(
                scene, flat, sensor_id, threefry.fold_in(key, 7), shard)
        if self.camera_depth > 1:
            # sensor-subpath estimators: (s >= 2, t = 1) and (s >= 2, t >= 2)
            img = img + self.render_camera_edges(
                scene, flat, sensor_id, threefry.fold_in(key, 11), "emitter",
                shard)
            if self.max_depth > 1:
                img = img + self.render_camera_edges(
                    scene, flat, sensor_id, threefry.fold_in(key, 13),
                    "direction", shard)
        return img

    @staticmethod
    def _prepass_valid(scene: Scene, flat: FlatScene, far: str):
        """The detached validity pre-pass of a far-side kind. Both are
        sparse (a few percent of lanes): the emitter side is gated by the
        boundary segment's validity, the direction side by the silhouette
        condition."""
        if far == "emitter":
            return _emitter_segment_valid(scene, flat)
        flat_det = detach_flat(flat)
        return lambda sample3, live: _direction_segment_valid(flat_det,
                                                              sample3)

    def _render_boundary_fused(self, scene: Scene, flat: FlatScene,
                               sensor_id: int, key: torch.Tensor, far: str,
                               shard=None) -> torch.Tensor:
        """One pass per far-side kind covering BOTH the s = 1 estimator
        (direct secondary / indirect) and the s >= 2 camera-side walk.

        The s = 1 guiding table also warps the shared stream. Cells whose
        s = 1 |value| mass is zero can still carry s >= 2 contributions (a
        receiver hidden from the camera is exactly the camera-side term's
        signal), so the warp gets a uniform floor: any density > 0 on the
        integrand's support keeps both terms unbiased, and the floor only
        dilutes the s = 1 guiding slightly."""
        warp = (self.warpper if far == "emitter" else self.ind_warpper).get(
            sensor_id)
        if warp is not None:
            pmf = warp.distrb.pmf
            warp = hypercube_set_mass(warp, pmf + 0.1 * torch.mean(pmf))

        def tail(sample3_t, rng):
            return self.eval_secondary_edge_camera(
                scene, flat, sensor_id, sample3_t, rng, far, include_s1=True)

        return _boundary_pass(scene, key, 2 if far == "emitter" else 3, warp,
                              self._prepass_valid(scene, flat, far), tail,
                              shard)

    def render_camera_edges(self, scene: Scene, flat: FlatScene,
                            sensor_id: int, key: torch.Tensor, far: str,
                            shard=None) -> torch.Tensor:
        """Boundary contributions whose receiver is seen through >= 1 extra
        bounce (sensor subpath length 2..camera_depth); each walk depth
        splats its own camera connection. Unguided."""

        def tail(sample3_t, rng):
            return self.eval_secondary_edge_camera(scene, flat, sensor_id,
                                                   sample3_t, rng, far)

        return _boundary_pass(scene, key, 5 if far == "emitter" else 6, None,
                              self._prepass_valid(scene, flat, far), tail,
                              shard)

    def eval_secondary_edge_camera(self, scene: Scene, flat: FlatScene,
                                   sensor_id: int, sample3: torch.Tensor,
                                   rng: RngStream, far: str,
                                   include_s1: bool = False):
        """Sensor-subpath boundary estimator (s >= 2).

        The boundary segment's geometry is ``eval_secondary_edge``'s, but
        the receiver point p1 need not be visible from the camera: a
        *detached* importance walk starts at p1 (BSDF-sampled continuations
        with the adjoint shading-normal correction) and tries a camera
        connection at each walk vertex q_k, k = 2..camera_depth, which
        covers discontinuities seen through reflections. Depth-1
        connections belong to the s = 1 estimators; ``include_s1`` adds
        theirs on the shared segment (the fused pass).

        ``far`` selects the light side: "emitter" = emitter-sampled p2 with
        full emission (t = 1); "direction" = a uniform direction with a
        detached reflected-only radiance estimate (t >= 2), as
        ``eval_secondary_edge_indirect``.

        Returns a list of (pixel_idx, value) splats, one a walk depth."""
        if far not in ("emitter", "direction"):
            raise ValueError(f"far={far!r} is neither emitter nor direction")
        kinds = scene.bsdf_kinds
        sensor = flat.sensors[sensor_id]
        bsdfs_det = detach_tree(flat.bsdfs)
        m = sample3.shape[0]
        dev = sample3.device

        if far == "emitter":
            bss = sample_boundary_segment_direct(
                flat, scene.face_offset, _emitter_meta(scene), sample3,
                torch.ones((m,), dtype=torch.bool, device=dev))
            valid = bss.valid
            p0, edge, edge2, pdf = bss.p0, bss.edge, bss.edge2, bss.pdf
            _p0 = p0.detach()
            _dir = normalize(bss.p2 - _p0)
            # visibility p0 -> p2 + the differentiable far triangle; the hit
            # must BE the emitter point p2, so the emitter-first query
            # replaces the full-scene closest hit exactly
            if flat.em_tri_idx is not None:
                its2_full, tri_info = ray_intersect_emitter_first(
                    flat, Ray(_p0, _dir), valid, want_tri_info=True)
            else:
                its2_full, tri_info = ray_intersect(
                    flat, Ray(_p0, _dir), valid, path_space=True,
                    want_tri_info=True)
            _its2 = detach_tree(its2_full)
            valid = (valid & _its2.valid
                     & (norm(_its2.p - bss.p2) < ShadowEpsilon))
            L = scene_le(flat, _its2, valid).detach()
            far_n = bss.n
        else:
            eds = _sample_edge_direction(flat, sample3)
            valid = eds.valid
            p0, edge, edge2, pdf, _dir = (eds.p0, eds.edge, eds.edge2,
                                          eds.pdf, eds.d)
            _p0 = p0.detach()
            its2_full, tri_info = ray_intersect(
                flat, Ray(_p0, _dir), valid, path_space=True,
                want_tri_info=True)
            _its2 = detach_tree(its2_full)
            valid = valid & _its2.valid
            far_n = _its2.n
            L = self._far_side_radiance(scene, flat, rng, Ray(_p0, _dir),
                                        valid)

        # sensor-side anchor p1
        _its1 = _trace_detached(flat, Ray(_p0, -_dir), valid)
        valid = valid & _its1.valid & (_its1.bsdf_id >= 0)
        _p1 = _its1.p
        _p2 = _its2.p

        # edge-local geometric kernel: its t is _its1.t = |p0 - p1|, the
        # edge-to-receiver distance, a property of the boundary segment
        # alone, whatever the sensor subpath
        dist = norm(_p2 - _p1)
        cos2 = torch.abs(dot(far_n, -_dir))
        e = cross(edge, _dir)
        sinphi = norm(e)
        proj = normalize(cross(e, far_n))
        sinphi2 = norm(cross(_dir, proj))
        valid = valid & (sinphi > Epsilon) & (sinphi2 > Epsilon)
        kernel = _mdiv(sinphi, sinphi2, valid) * cos2
        kernel = _mdiv(kernel, pdf, valid & (pdf > 0.0))

        # AD normal-velocity factor, anchored at the detached p1
        nrm = normalize(cross(far_n, proj))
        sign_f = torch.sign(dot(e, edge2)) * torch.sign(dot(e, nrm))
        ad_term = _normal_velocity(tri_info, p0, _p1, nrm)

        kernel = kernel * _mdiv(_its1.t, dist, valid)

        splats = []
        if include_s1:
            # the s = 1 estimator on the SHARED boundary segment: the tail
            # of eval_secondary_edge / eval_secondary_edge_indirect, whose
            # differentiable camera recompute at p1 anchors the AD term
            v1, sds1, cam_ray1, its1d = _connect_camera(flat, sensor, _its1,
                                                        valid)
            f1 = _adjoint_bsdf(kinds, bsdfs_det, _its1, -cam_ray1.d.detach(),
                               v1)
            value0_1 = f1 * L * (kernel * sds1.sensor_val * sign_f)[..., None]
            value0_1 = torch.where(v1[..., None], value0_1, 0.0)
            res1 = (value0_1.detach()
                    * _normal_velocity(tri_info, p0, its1d.p, nrm)[..., None])
            res1 = torch.where(v1[..., None], res1, 0.0)
            splats.append((torch.where(v1, sds1.pixel_idx, -1),
                           res1 - res1.detach()))
        its_cur = _its1
        thr = torch.ones((m, 3), device=dev)
        walk_valid = valid
        for _ in range(2, self.camera_depth + 1):
            bs = sample_bsdf(kinds, bsdfs_det, its_cur, rng.next_3d(m),
                             walk_valid)
            walk_valid = walk_valid & bs.valid & (bs.pdf > 0.0)
            wo_world = to_world(its_cur.sh_frame, bs.wo)
            f_step = _adjoint_bsdf(kinds, bsdfs_det, its_cur, wo_world,
                                   walk_valid)
            thr = thr * _mdiv(f_step, bs.pdf[..., None],
                              (walk_valid & (bs.pdf > 0.0))[..., None])
            its_next = _trace_detached(flat, Ray(its_cur.p, wo_world),
                                       walk_valid)
            walk_valid = walk_valid & its_next.valid & (its_next.bsdf_id >= 0)
            its_cur = its_next

            con_valid, sds, camera_ray, _ = _connect_camera(
                flat, sensor, its_cur, walk_valid)
            f_cam = _adjoint_bsdf(kinds, bsdfs_det, its_cur,
                                  -camera_ray.d.detach(), con_valid)
            value0 = (thr * f_cam * L
                      * (kernel * sds.sensor_val * sign_f)[..., None])
            value0 = torch.where(con_valid[..., None], value0, 0.0)
            result = value0.detach() * ad_term[..., None]
            result = torch.where(con_valid[..., None], result, 0.0)
            splats.append((torch.where(con_valid, sds.pixel_idx, -1),
                           result - result.detach()))
        return splats

    def _far_side_radiance(self, scene, flat, rng, ray, valid):
        """Detached reflected-only radiance arriving along ``ray``: a
        (max_depth - 1)-bounce estimate without the first hit's own
        emission, which the emitter-sampled estimators cover."""
        helper = PathTracer(max_depth=max(1, self.max_depth - 1),
                            hide_emitters=True)
        with torch.no_grad():
            return helper.Li(scene, detach_flat(flat), rng, ray,
                             valid).detach()

    def render_indirect_edges(self, scene: Scene, flat: FlatScene,
                              sensor_id: int, key: torch.Tensor,
                              shard=None) -> torch.Tensor:
        """The direction-sampled (indirect) secondary boundary term."""

        def tail(sample3_t, rng):
            return [self.eval_secondary_edge_indirect(scene, flat, sensor_id,
                                                      sample3_t, rng)]

        return _boundary_pass(scene, key, 3, self.ind_warpper.get(sensor_id),
                              self._prepass_valid(scene, flat, "direction"),
                              tail, shard)

    def eval_secondary_edge_indirect(self, scene: Scene, flat: FlatScene,
                                     sensor_id: int, sample3: torch.Tensor,
                                     rng: RngStream, ad: bool = True):
        """Direction-sampled boundary segment with a path-traced far side.

        As ``DirectIntegrator.eval_secondary_edge`` with three changes: (1)
        the far endpoint is the first hit along a uniformly sampled
        direction (its pdf is in solid angle already); (2) its radiance is a
        detached (max_depth - 1)-bounce estimate without the far surface's
        own emission; (3) no emitter-orientation validity test. ``ad=False``
        is the guiding variant: the value's magnitude, pixel_idx all -1."""
        kinds = scene.bsdf_kinds
        sensor = flat.sensors[sensor_id]
        dev = sample3.device

        eds = _sample_edge_direction(flat, sample3)
        valid, p0, _dir = eds.valid, eds.p0, eds.d
        _p0 = p0.detach()
        # far side: the first hit is the moving shadow caster's background
        its2_full, tri_info = ray_intersect(flat, Ray(_p0, _dir), valid,
                                            path_space=True,
                                            want_tri_info=True)
        _its2 = detach_tree(its2_full)
        valid = valid & _its2.valid
        _p2 = _its2.p
        far_n = _its2.n

        L = self._far_side_radiance(scene, flat, rng, Ray(_p0, _dir), valid)

        # camera side (the direct estimator's from here on)
        _its1 = _trace_detached(flat, Ray(_p0, -_dir), valid)
        valid = valid & _its1.valid
        _p1 = _its1.p
        valid, sds, camera_ray, its1 = _connect_camera(flat, sensor, _its1,
                                                       valid)

        dist = norm(_p2 - _p1)
        cos2 = torch.abs(dot(far_n, -_dir))
        e = cross(eds.edge, _dir)
        sinphi = norm(e)
        proj = normalize(cross(e, far_n))
        sinphi2 = norm(cross(_dir, proj))
        base_v = (_mdiv(_its1.t, dist, valid)
                  * _mdiv(sinphi, sinphi2, valid) * cos2)
        valid = valid & (sinphi > Epsilon) & (sinphi2 > Epsilon)

        bsdfs_det = detach_tree(flat.bsdfs)
        d0 = -camera_ray.d.detach()
        d0_local = to_local(_its1.sh_frame, d0)
        bsdf_val = eval_bsdf(kinds, bsdfs_det, _its1, d0_local, valid)
        corr_num = _its1.wi[..., 2] * dot(d0, _its1.n)
        corr_den = d0_local[..., 2] * dot(_dir, _its1.n)
        correction = torch.abs(_mdiv(corr_num, corr_den,
                                     valid & (corr_den != 0.0)))
        bsdf_val = bsdf_val * correction[..., None]

        value0 = bsdf_val * L * (base_v * sds.sensor_val)[..., None]
        value0 = _mdiv(value0, eds.pdf, valid & (eds.pdf > 0.0))
        value0 = torch.where(valid[..., None], value0, 0.0)

        if not ad:
            return (torch.full(valid.shape, -1, dtype=torch.int32,
                               device=dev), torch.abs(value0).detach())

        nrm = normalize(cross(far_n, proj))
        value0 = value0 * (torch.sign(dot(e, eds.edge2))
                           * torch.sign(dot(e, nrm)))[..., None]
        result = (value0.detach()
                  * _normal_velocity(tri_info, p0, its1.p, nrm)[..., None])
        result = torch.where(valid[..., None], result, 0.0)
        pix = torch.where(valid, sds.pixel_idx, -1)
        return pix, result - result.detach()

    # -- guiding -------------------------------------------------------------
    def preprocess_secondary_edges(self, scene: Scene, sensor_id: int, reso,
                                   nrounds: int = 1, seed: int = 0,
                                   mesh=None) -> None:
        """The direct term's guiding table, as ``DirectIntegrator`` builds
        it, into ``self.warpper``."""
        helper = DirectIntegrator(1, 1)
        helper.warpper = self.warpper
        helper._guiding_jits = guiding_programs(self)
        helper.preprocess_secondary_edges(scene, sensor_id, reso, nrounds,
                                          seed, mesh=mesh)
        self.warpper = helper.warpper

    def preprocess_indirect_edges(self, scene: Scene, sensor_id: int, reso,
                                  nrounds: int = 1, seed: int = 0,
                                  mesh=None) -> None:
        """Guiding table for the indirect boundary term into
        ``self.ind_warpper``: Monte-Carlo cell masses of |value| over the
        (edge, direction) cube, from
        ``eval_secondary_edge_indirect(ad=False)`` (``_guiding_table``).
        With ``mesh`` (a ``parallel.DeviceMesh``) the lanes are split over
        its ranks and the masses summed; the estimator draws per lane in
        its far-side walk, so each rank's lanes draw from ``fold_in(key,
        rank)``, and the table equals the serial one in distribution, not
        bit for bit."""
        def eval_value(flat, sample3, rng):
            return self.eval_secondary_edge_indirect(
                scene, flat, sensor_id, sample3, rng, ad=False)[1]

        self.ind_warpper[sensor_id] = _guiding_table(
            scene, reso, nrounds, seed, mesh, eval_value,
            guiding_programs(self), ("indirect", sensor_id, self.max_depth,
                                     self.camera_depth, self.hide_emitters),
            rank_streams=True)
