"""One-bounce direct-illumination integrator with MIS. Counterpart of the
interior half of ``psdr_tpu/integrator/direct.py``, in the forward render
and under autograd; the secondary-edge boundary estimator and its guiding
wait for slice 2, second part.

All masked divisions route through ``_mdiv`` so masked-out lanes never
divide by zero (and, once gradients arrive, never carry 0 * inf = NaN).
"""
from __future__ import annotations

import os

import torch

from ..bsdf import all_reflective_one_sided, eval_bsdf, pdf_bsdf, sample_bsdf
from ..core.frame import to_local, to_world
from ..core.gather import select_rows
from ..core.math import dot, sqr, squared_norm
from ..core.records import Ray
from ..core.sampler import RngStream, ld_2d
from ..scene.scene import (FlatScene, Scene, emitter_position_pdf,
                           ray_intersect, ray_intersect_emitter_first,
                           ray_intersect_with_prior, ray_test,
                           sample_emitter_position, scene_le)
from .base import Integrator


def _stratify2(u2: torch.Tensor, rng: RngStream, which: int) -> torch.Tensor:
    """With the (0,2)-sequence attached by the interior render, REPLACE u2
    by the pixel's scrambled point (``which`` 0: NEE pair, 1: BSDF pair);
    otherwise return u2."""
    if rng.ld is None:
        return u2
    s_idx, nee_x, nee_y, bsdf_x, bsdf_y = rng.ld
    if which == 0:
        return ld_2d(s_idx, nee_x, nee_y)
    return ld_2d(s_idx, bsdf_x, bsdf_y)


def _mdiv(a, b, mask):
    """a / b with the divisor forced to 1 on masked-out lanes."""
    b = torch.where(mask, b, 1.0)
    return a / b[..., None] if a.ndim > b.ndim else a / b


def _emitter_meta(scene: Scene):
    meta = [("area", e.mesh_index) if e.kind == "area" else ("env", -1)
            for e in scene.emitters]
    return tuple(meta) if meta else (("area", 0),)


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
                its1 = ray_intersect(flat, ray1, active1, path_space=True)
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
            side_ok = (ps.emitter < 0) | (cos_val > 0.0)
            if all_reflective_one_sided(kinds):
                side_ok = (side_ok
                           & (to_local(its.sh_frame, wo).detach()[..., 2] > 0.0)
                           & (its.wi.detach()[..., 2] > 0.0))
            active1 = active1 & side_ok

            vis = self._nee_visibility(flat, rng, its.p, wo, dist, active1, n)
            if vis is None:
                occluded = ray_test(flat, Ray(its.p, wo), dist, active1)
                active1 = active1 & ~occluded
            else:
                active1 = active1 & (vis != 0.0)

            le = torch.where((ps.emitter >= 0)[..., None],
                             select_rows(flat.emitter_radiance,
                                         torch.clamp(ps.emitter, min=0)),
                             0.0)

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
        occ2 = ray_test(flat, Ray(p, wo), dist, trace2)
        V2 = torch.where(trace2, 1.0 - occ2.float(), zero)
        corr = torch.where(B, (V2 - V_ref) * k_lane.float(), zero)
        return torch.where(probe, V0, V_ref + corr)
