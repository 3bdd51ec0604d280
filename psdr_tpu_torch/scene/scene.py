"""Scene container: the host-side object graph, and ``build``, which
produces the flat device scene every render consumes.

Counterpart of ``psdr_tpu/scene/scene.py`` for the detached forward render.
Every tensor of a build is made on ``Scene.device``. Left for later slices:
the differentiable hit recompute and the boundary-edge tables (slice 2),
environment maps (slice 4). ``ray_test`` takes the JAX package's
``sort_rays``/``sparse`` flags and ignores them: they ordered and compacted
lanes for the TPU kernel's block cull and change no result.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..accel.bruteforce import HitRecord, ray_intersect_brute
from ..accel.bvh import BVH, BVHTopology, build_bvh_topology, refit_bvh
from ..accel.intersect import ray_intersect_k1
from ..bsdf import check_kinds
from ..core.constants import ShadowEpsilon
from ..core.distribution import Discrete, discrete_init, discrete_sample_reuse
from ..core.frame import make_frame, to_local
from ..core.math import bilinear, normalize, rgb2luminance
from ..core.records import Intersection, PositionSample, Ray, RenderOptions
from ..emitter.area import AreaLight
from ..sensor.perspective import PerspectiveCamera, configure_sensor
from ..shape.mesh import (Mesh, TriangleInfo, compute_triangle_info,
                          sample_position)

BVH_LEAF_SIZE = 4   # triangles per BVH leaf


class FlatScene(NamedTuple):
    """Flattened scene state (one tree of tensors)."""
    tri: TriangleInfo              # (F,) world-space SoA
    uv0: torch.Tensor              # (F, 2) per-corner texture uv
    uv1: torch.Tensor
    uv2: torch.Tensor
    face_normal_mask: torch.Tensor  # (F,) bool: use face normals for shading
    mesh_id: torch.Tensor          # (F,) int32
    bsdf_id: torch.Tensor          # (F,) int32, -1 none
    emitter_id: torch.Tensor       # (F,) int32, -1 none
    emitter_radiance: torch.Tensor  # (L, 3)
    emitter_weight: torch.Tensor   # (L,) normalized sampling weights
    emitter_inv_area: torch.Tensor  # (L,)
    emitter_distrb: Discrete
    emitter_face_distrb: tuple     # per-emitter Discrete over its mesh faces
    sensors: tuple                 # SensorState per sensor
    bsdfs: tuple                   # per-bsdf param dicts
    lower: torch.Tensor            # (3,) scene AABB
    upper: torch.Tensor
    accel: Optional[BVH] = None    # refit BVH; None -> brute force
    # (F, 32) per-face row table, one row gather per hit. Columns: p0 e1 e2
    # n0 n1 n2 fn | area | uv0 uv1 uv2 | fmask | mesh_id bsdf_id emitter_id
    # (ids as exact f32)
    face_table: Optional[torch.Tensor] = None
    # (E,) int64 global face ids of all emitter geometry, or None when
    # absent or too large: enables the emitter-first bounce query
    em_tri_idx: Optional[torch.Tensor] = None
    # set by detach_flat(): every tensor is detached, so ray_intersect
    # returns the hit query's own (t, uv) with no recompute
    detached: bool = False


def _map_tensors(fn, x):
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_map_tensors(fn, v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_map_tensors(fn, v) for v in x)
    if isinstance(x, dict):
        return {k: _map_tensors(fn, v) for k, v in x.items()}
    return x


def detach_flat(flat: FlatScene) -> FlatScene:
    """Detach every tensor and mark the scene detached."""
    return _map_tensors(torch.Tensor.detach, flat)._replace(detached=True)


class Scene:
    """Host-side scene: meshes, BSDFs, emitters and sensors, built into a
    ``FlatScene`` on ``device``."""

    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        self.meshes: list[Mesh] = []
        self.bsdfs: list = []
        self.emitters: list = []
        self.sensors: list[PerspectiveCamera] = []
        self._opts = RenderOptions()
        self.param_map: dict = {}
        self._flat_cache = None
        # the BVH and K1 from accel_min_faces faces up, brute force below
        self.accel_min_faces = 512
        self._bvh_topo: BVHTopology | None = None
        self.face_offset = [0]

    def to(self, device) -> "Scene":
        self.device = torch.device(device)
        self._flat_cache = None
        return self

    @property
    def opts(self) -> RenderOptions:
        return self._opts

    @opts.setter
    def opts(self, value: RenderOptions) -> None:
        self._opts = value
        self._flat_cache = None

    # -- construction --------------------------------------------------------
    def add_bsdf(self, bsdf, bsdf_id: str = "") -> int:
        self.bsdfs.append(bsdf)
        key = f"BSDF[id={bsdf_id}]" if bsdf_id else f"BSDF[{len(self.bsdfs)-1}]"
        if bsdf_id:
            bsdf.id = bsdf_id
        self.param_map[key] = bsdf
        return len(self.bsdfs) - 1

    def add_mesh(self, mesh: Mesh) -> int:
        self.meshes.append(mesh)
        self.param_map[f"Mesh[{len(self.meshes)-1}]"] = mesh
        return len(self.meshes) - 1

    def add_emitter(self, emitter) -> int:
        self.emitters.append(emitter)
        self.param_map[f"Emitter[{len(self.emitters)-1}]"] = emitter
        if isinstance(emitter, AreaLight):
            self.meshes[emitter.mesh_index].emitter_id = len(self.emitters) - 1
        return len(self.emitters) - 1

    def add_sensor(self, sensor: PerspectiveCamera) -> int:
        self.sensors.append(sensor)
        self.param_map[f"Sensor[{len(self.sensors)-1}]"] = sensor
        return len(self.sensors) - 1

    # -- parameters -----------------------------------------------------------
    def params(self) -> dict:
        return {
            "meshes": [m.params() for m in self.meshes],
            "bsdfs": [b.params() for b in self.bsdfs],
            "emitters": [e.params() for e in self.emitters],
            "sensors": [s.params() for s in self.sensors],
        }

    def set_params(self, p: dict) -> None:
        for objs, key in ((self.meshes, "meshes"), (self.bsdfs, "bsdfs"),
                          (self.emitters, "emitters"),
                          (self.sensors, "sensors")):
            for o, op in zip(objs, p[key]):
                o.set_params(op)
        self._flat_cache = None

    def _use_bvh(self) -> bool:
        return sum(m.num_faces for m in self.meshes) >= self.accel_min_faces

    def prepare_accel(self) -> None:
        """Build the static BVH topology (triangle Morton order + skip
        links) on the host from the current geometry; later builds only
        refit the AABBs."""
        if self._use_bvh() and self._bvh_topo is None:
            with torch.no_grad():
                tri = self.build(self.params()).tri
            self._bvh_topo = build_bvh_topology(
                tri.p0.cpu().numpy(), tri.e1.cpu().numpy(),
                tri.e2.cpu().numpy(), leaf_size=BVH_LEAF_SIZE)

    def configure(self) -> FlatScene:
        """Build + cache the flat scene at the current parameters."""
        self.prepare_accel()
        self._flat_cache = self.build(self.params())
        return self._flat_cache

    @property
    def flat(self) -> FlatScene:
        if self._flat_cache is None:
            self.configure()
        return self._flat_cache

    @property
    def bsdf_kinds(self):
        return tuple(b.kind for b in self.bsdfs)

    # -- the build ------------------------------------------------------------
    def build(self, params: dict) -> FlatScene:
        if not self.meshes or not self.sensors:
            raise ValueError("a scene needs meshes and a sensor")
        if self.opts.sppe > 0 or self.opts.sppse > 0:
            raise NotImplementedError(
                "boundary terms (sppe/sppse > 0) wait for slice 2")
        for em in self.emitters:
            if getattr(em, "kind", None) != "area":
                raise NotImplementedError(
                    "emitters other than area lights (environment maps) "
                    "wait for slice 4")
        check_kinds(self.bsdf_kinds)
        dev = self.device

        params = {k: [{kk: torch.as_tensor(vv, dtype=torch.float32,
                                          device=dev)
                           for kk, vv in d.items()} for d in v]
                  for k, v in params.items()}

        def full(n, value, dtype):
            return torch.full((n,), value, dtype=dtype, device=dev)

        world_vps, tri_infos, face_offset = [], [], [0]
        for mesh, mp in zip(self.meshes, params["meshes"]):
            vp = mesh.world_positions(mp)
            info, _ = compute_triangle_info(
                vp, torch.as_tensor(mesh.faces, device=dev), mesh.num_vertices)
            world_vps.append(vp)
            tri_infos.append(info)
            face_offset.append(face_offset[-1] + mesh.num_faces)

        # scene AABB over detached vertices + camera positions
        sensor_states = [configure_sensor(s, sp["to_world"],
                                          (self.opts.width, self.opts.height))
                         for s, sp in zip(self.sensors, params["sensors"])]
        lows = [vp.detach().amin(dim=0) for vp in world_vps]
        highs = [vp.detach().amax(dim=0) for vp in world_vps]
        lows += [st.camera_pos.detach() for st in sensor_states]
        highs += [st.camera_pos.detach() for st in sensor_states]
        lower = torch.stack(lows).amin(dim=0)
        upper = torch.stack(highs).amax(dim=0)

        tri = TriangleInfo(*(torch.cat(xs) for xs in zip(*tri_infos)))
        uv0_l, uv1_l, uv2_l, fmask_l, mid_l, bid_l, eid_l = ([] for _ in range(7))
        for i, mesh in enumerate(self.meshes):
            nf = mesh.num_faces
            if mesh.uv is not None:
                uvs = torch.as_tensor(mesh.uv, device=dev)
                uvi = torch.as_tensor(mesh.uv_idx, device=dev).long()
                uv0_l.append(uvs[uvi[:, 0]])
                uv1_l.append(uvs[uvi[:, 1]])
                uv2_l.append(uvs[uvi[:, 2]])
            else:
                z = torch.zeros((nf, 2), device=dev)
                uv0_l.append(z); uv1_l.append(z); uv2_l.append(z)
            fmask_l.append(full(nf, mesh.use_face_normals, torch.bool))
            mid_l.append(full(nf, i, torch.int32))
            bid_l.append(full(nf, mesh.bsdf_id, torch.int32))
            eid_l.append(full(nf, mesh.emitter_id, torch.int32))

        # emitters: radiance, 1/area, sampling weight = area x luminance
        rads, inv_areas, weights, face_distrbs = [], [], [], []
        for i, em in enumerate(self.emitters):
            fa = tri_infos[em.mesh_index].face_area
            total_area = torch.sum(fa)
            rad = params["emitters"][i]["radiance"]
            rads.append(rad)
            inv_areas.append(1.0 / total_area)
            weights.append((total_area * rgb2luminance(rad.detach())).detach())
            face_distrbs.append(discrete_init(fa.detach()))
        if not self.emitters:
            rads.append(torch.zeros((3,), device=dev))
            inv_areas.append(torch.zeros((), device=dev))
            weights.append(torch.ones((), device=dev))
            face_distrbs.append(discrete_init(torch.ones(1, device=dev)))
        radiance, inv_area = torch.stack(rads), torch.stack(inv_areas)
        w = torch.stack(weights)
        emitter_distrb = discrete_init(w)
        emitter_weight = w / torch.clamp(emitter_distrb.total, min=1e-20)

        accel = None
        if (self._bvh_topo is not None
                and self._bvh_topo.num_faces == tri.p0.shape[0]):
            accel = refit_bvh(self._bvh_topo, tri.p0, tri.e1, tri.e2)

        # static emitter-face index set
        em_rows = [np.arange(face_offset[i], face_offset[i + 1])
                   for i, mesh in enumerate(self.meshes)
                   if mesh.emitter_id >= 0]
        em_tri_idx = None
        if em_rows:
            em_cat = np.concatenate(em_rows)
            # past a few thousand faces the full accel path wins again
            if em_cat.shape[0] <= 8192:
                em_tri_idx = torch.as_tensor(em_cat, device=dev)

        if tri.p0.shape[0] >= (1 << 24):
            # face ids ride the f32 face table exactly only below 2^24
            raise ValueError("scenes with >= 2^24 faces are not supported")
        uv0, uv1, uv2 = torch.cat(uv0_l), torch.cat(uv1_l), torch.cat(uv2_l)
        fmask = torch.cat(fmask_l)
        mesh_id, bsdf_id = torch.cat(mid_l), torch.cat(bid_l)
        emitter_id = torch.cat(eid_l)
        face_table = torch.cat([
            tri.p0, tri.e1, tri.e2, tri.n0, tri.n1, tri.n2, tri.face_normal,
            tri.face_area[:, None], uv0, uv1, uv2,
            fmask.float()[:, None], mesh_id.float()[:, None],
            bsdf_id.float()[:, None], emitter_id.float()[:, None]], dim=1)

        self.face_offset = face_offset
        return FlatScene(
            tri=tri, uv0=uv0, uv1=uv1, uv2=uv2, face_normal_mask=fmask,
            mesh_id=mesh_id, bsdf_id=bsdf_id, emitter_id=emitter_id,
            emitter_radiance=radiance, emitter_weight=emitter_weight,
            emitter_inv_area=inv_area, emitter_distrb=emitter_distrb,
            emitter_face_distrb=tuple(face_distrbs),
            sensors=tuple(sensor_states), bsdfs=tuple(params["bsdfs"]),
            lower=lower, upper=upper, accel=accel, face_table=face_table,
            em_tri_idx=em_tri_idx)

    def __repr__(self):
        return ("Scene[\n  # Sensors\n  " + "\n  ".join(map(repr, self.sensors))
                + "\n  # BSDFs\n  " + "\n  ".join(map(repr, self.bsdfs))
                + "\n  # Meshes\n  " + "\n  ".join(map(repr, self.meshes)) + "\n]")


# -- scene queries (functions of a FlatScene) --------------------------------

def _closest_hit(flat: FlatScene, ray: Ray, active: torch.Tensor, tmax=None,
                 any_hit: bool = False) -> HitRecord:
    """Detached hit query: K1 over the BVH, or brute force for scenes
    below ``accel_min_faces``. ``any_hit`` lets K1 stop at the first hit;
    brute force returns the closest, which is also a valid any-hit answer."""
    if flat.accel is not None:
        return ray_intersect_k1(flat.accel, ray.o, ray.d, active, tmax,
                                any_hit=any_hit)
    return ray_intersect_brute(flat.tri.p0, flat.tri.e1, flat.tri.e2,
                               ray.o, ray.d, active, tmax=tmax)


def ray_test(flat: FlatScene, ray: Ray, dist: torch.Tensor,
             active: torch.Tensor, sort_rays: bool = False,
             sparse: bool = False) -> torch.Tensor:
    """Occlusion query: True where some surface lies strictly closer than
    ``dist - ShadowEpsilon``. ``sort_rays``/``sparse`` are accepted for the
    JAX package's call sites and ignored (see the module docstring)."""
    tmax = dist.detach() - ShadowEpsilon
    occ = _closest_hit(flat, ray, active, tmax=tmax, any_hit=True).valid
    return occ & active


def ray_intersect_emitter_first(flat: FlatScene, ray: Ray,
                                active: torch.Tensor,
                                sort_rays: bool = True,
                                want_tri_info: bool = False) -> Intersection:
    """Closest hit restricted to emitter geometry, plus a tmax-bounded
    any-hit occlusion sweep of the full scene. Exact wherever the caller
    reads the hit only on emitter lanes: a bounce ray counts iff its
    nearest emitter hit exists and nothing occludes it."""
    if want_tri_info:
        raise NotImplementedError("the differentiable hit recompute waits "
                                  "for slice 2 (the backward)")
    idxs = flat.em_tri_idx
    hit_e = ray_intersect_brute(flat.tri.p0[idxs], flat.tri.e1[idxs],
                                flat.tri.e2[idxs], ray.o, ray.d, active)
    valid_e = hit_e.valid & active
    occluded = ray_test(flat, ray, torch.where(valid_e, hit_e.t, 0.0),
                        valid_e, sort_rays=sort_rays, sparse=True)
    valid = valid_e & ~occluded
    e_local = torch.clamp(hit_e.tri_id, min=0).long()
    hit = hit_e._replace(
        valid=valid,
        tri_id=torch.where(valid, idxs[e_local].to(torch.int32), -1),
        t=torch.where(valid, hit_e.t, float("inf")))
    rows = select_rows(flat.face_table[idxs], e_local)
    return ray_intersect(flat, ray, active, path_space=True, hit=hit,
                         rows=rows)


def ray_intersect(flat: FlatScene, ray: Ray, active: torch.Tensor,
                  path_space: bool = False, want_tri_info: bool = False,
                  sort_rays: bool = False, hit=None, rows=None
                  ) -> Intersection:
    """Detached closest hit -> ``Intersection``. ``hit``: a precomputed
    HitRecord; ``rows``: the matching (N, 32) face-table rows. On a
    detached scene both formulations give the same record (J = 1)."""
    if not flat.detached or want_tri_info:
        raise NotImplementedError("the differentiable hit recompute waits "
                                  "for slice 2 (the backward)")
    if hit is None:
        hit = _closest_hit(flat, ray, active)
    valid = hit.valid & active
    idx = torch.clamp(hit.tri_id, min=0).long()
    return _intersection_detached(flat, ray, hit, valid, idx, rows)


def _intersection_detached(flat: FlatScene, ray: Ray, hit: HitRecord,
                           valid: torch.Tensor, idx: torch.Tensor,
                           rows=None) -> Intersection:
    """The hit query's own (t, uv) are the answer; only the shading
    columns [9:32] of the face table are read."""
    t = torch.where(valid, hit.t, 1.0)
    uv = torch.where(valid[..., None], hit.uv, 0.0)
    p = ray.at(t)
    sub = rows[:, 9:] if rows is not None else flat.face_table[:, 9:][idx]
    n0, n1, n2 = sub[:, 0:3], sub[:, 3:6], sub[:, 6:9]
    face_n = sub[:, 9:12]
    uv0g, uv1g, uv2g = sub[:, 13:15], sub[:, 15:17], sub[:, 17:19]
    fmask = sub[:, 19] > 0.5
    mesh_id_g = sub[:, 20].to(torch.int32)
    bsdf_id_g = sub[:, 21].to(torch.int32)
    emitter_id_g = sub[:, 22].to(torch.int32)

    sh_n = normalize(bilinear(n0, n1 - n0, n2 - n0, uv))
    sh_n = torch.where(fmask[..., None], face_n, sh_n)
    frame = make_frame(sh_n)
    uv_tex = bilinear(uv0g, uv1g - uv0g, uv2g - uv0g, uv)
    return Intersection(
        valid=valid, t=t, p=p, n=face_n, sh_frame=frame,
        uv=uv_tex, wi=to_local(frame, -ray.d), J=torch.ones_like(t),
        mesh_id=mesh_id_g, tri_id=hit.tri_id,
        bsdf_id=torch.where(valid, bsdf_id_g, -1),
        emitter_id=torch.where(valid, emitter_id_g, -1))


def select_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for a small table: the same entries the JAX package's
    static select chain picks (a gather is cheap on the card)."""
    return table[idx.long()]


def scene_le(flat: FlatScene, its: Intersection,
             active: torch.Tensor) -> torch.Tensor:
    """Emitted radiance toward the viewer at a hit (one-sided)."""
    active = active & its.is_emitter()
    eid = torch.clamp(its.emitter_id, min=0)
    front = its.wi[..., 2] > 0.0
    return torch.where((active & front)[..., None],
                       select_rows(flat.emitter_radiance, eid), 0.0)


def sample_emitter_position(flat: FlatScene, face_offsets, emitter_meta,
                            ref_p: torch.Tensor, sample2: torch.Tensor,
                            active: torch.Tensor) -> PositionSample:
    """Pick an emitter proportional to its weight, then sample its surface.
    ``emitter_meta``: static list of ('area', mesh_index)."""
    n = ref_p.shape[0]
    dev = ref_p.device
    if len(emitter_meta) == 1:
        idx = torch.zeros((n,), dtype=torch.int32, device=dev)
        sel_pdf = torch.ones((n,), device=dev)
        s2 = sample2
    else:
        idx, sel_pdf, sy = discrete_sample_reuse(flat.emitter_distrb,
                                                 sample2[..., 1])
        s2 = torch.stack([sample2[..., 0], sy], dim=-1)

    out = PositionSample(valid=torch.zeros((n,), dtype=torch.bool, device=dev),
                         pdf=torch.zeros((n,), device=dev),
                         p=torch.zeros((n, 3), device=dev),
                         n=torch.zeros((n, 3), device=dev),
                         J=torch.ones((n,), device=dev),
                         emitter=torch.full((n,), -1, dtype=torch.int32,
                                            device=dev))
    for i, (kind, mesh_index) in enumerate(emitter_meta):
        if kind != "area":
            raise NotImplementedError("environment maps wait for slice 4")
        mask = active & (idx == i)
        lo, hi = face_offsets[mesh_index], face_offsets[mesh_index + 1]
        tri_slice = TriangleInfo(*(a[lo:hi] for a in flat.tri))
        ps = sample_position(tri_slice, flat.emitter_face_distrb[i],
                             flat.emitter_inv_area[i], s2)
        m3 = mask[..., None]
        out = PositionSample(
            valid=torch.where(mask, ps.valid, out.valid),
            pdf=torch.where(mask, ps.pdf, out.pdf),
            p=torch.where(m3, ps.p, out.p),
            n=torch.where(m3, ps.n, out.n),
            J=torch.where(mask, ps.J, out.J),
            emitter=torch.where(mask, i, out.emitter))
    return out._replace(pdf=out.pdf * sel_pdf, valid=out.valid & active)


def emitter_position_pdf(flat: FlatScene, emitter_meta, ref_p: torch.Tensor,
                         its: Intersection,
                         active: torch.Tensor) -> torch.Tensor:
    """Area-measure pdf of reaching this emitter point by light sampling,
    with the normalized sampling weights."""
    active = active & its.is_emitter()
    eid = torch.clamp(its.emitter_id, min=0)
    pdf = (select_rows(flat.emitter_weight, eid)
           * select_rows(flat.emitter_inv_area, eid))
    return torch.where(active, pdf, 0.0)
