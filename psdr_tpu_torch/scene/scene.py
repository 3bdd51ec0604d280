"""Scene container: the host-side object graph, and ``build``, which
produces the flat device scene every render consumes.

Counterpart of ``psdr_tpu/scene/scene.py`` for the interior render, the
boundary terms and their gradients. Every tensor of a build is made on
``Scene.device``; gradients reach the params leaves through the build, the
differentiable hit recompute of ``ray_intersect`` and the edge tables
(``sec_edge``, each sensor's ``edges``, built when ``sppe`` or ``sppse`` is
positive), while every hit query stays detached. An environment map adds
its 12-face bounding mesh (``bsdf_id`` -1) to the face tables, so
environment hits look like surface hits.

The hit queries (``_closest_hit``, ``ray_test``) dispatch on
``FlatScene.accel_kind``, which ``Scene.accel_mode`` sets: K1 (``pallas``,
the card's default), K3 (``culled``, the CPU's default, there through
their plain version), the walk (``bvh_walk``), or brute force (K2) below
``accel_min_faces``. ``sort_rays`` orders a batch by direction before the
kernel (``_octant_sort``) and ``sparse`` compacts an occlusion sweep to a
fraction of its lanes (``_ray_test_sparse``), as the JAX package does;
neither changes a result, since each ray's answer does not depend on the
rays beside it.
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import profiling
from ..accel.bruteforce import HitRecord
from ..accel.bvh import (BVH, BVHTopology, build_bvh_topology,
                         ray_intersect_bvh, ray_intersect_culled, refit_bvh)
from ..accel.intersect import ray_intersect_brute, ray_intersect_k1
from ..bsdf import check_kinds
from ..core.constants import EdgeEpsilon, Epsilon, ShadowEpsilon
from ..core.distribution import Discrete, discrete_init, discrete_sample_reuse
from ..core.frame import make_frame, to_local
from ..core.frame import to_world as frame_to_world
from ..core.gather import gather_rows, select_rows
from ..core.hoist import const, forget, memo, upload
from ..core.math import (bilinear, dot, norm, normalize,
                         ray_intersect_triangle, rgb2luminance, safe_sqrt,
                         sign_eps, squared_norm)
from ..core.records import (BoundarySegSample, Intersection, PositionSample,
                            Ray, RenderOptions, detach_tree)
from ..emitter.area import AreaLight
from ..emitter.envmap import (EnvironmentMap, EnvmapState, configure_envmap,
                              envmap_eval_direction, envmap_position_pdf,
                              envmap_sample_position)
from ..sensor.perspective import (PerspectiveCamera, PrimaryEdgeInfo,
                                  build_primary_edges, configure_sensor,
                                  finalize_primary_edges)
from ..shape.mesh import (Mesh, SecondaryEdgeInfo, TriangleInfo, _host,
                          compute_sec_edge_info, compute_triangle_info,
                          sample_position, vertex_corner_table)

BVH_LEAF_SIZE = 4   # triangles per BVH leaf, ``Scene.accel_leaf_size``'s default
ACCEL_MODES = ("auto", "brute", "bvh", "bvh_walk", "culled", "pallas")

# the environment map's bounding mesh: 12 faces over the 8 corners of the
# (enlarged) scene box, corner i taking upper[j] where bit j of i is set
_BOUND_FACES = [
    [0, 1, 3], [0, 3, 2], [1, 5, 7], [1, 7, 3], [2, 3, 7], [2, 7, 6],
    [0, 5, 1], [0, 4, 5], [0, 2, 6], [0, 6, 4], [4, 7, 5], [4, 6, 7],
]
_BOUND_CORNERS = vertex_corner_table(np.asarray(_BOUND_FACES), 8)


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
    sec_edge: SecondaryEdgeInfo    # (E,) stacked over meshes; one invalid
    #                                row where no mesh has edges
    sec_distrb: Discrete           # over edges, by detached length
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
    # the query over ``accel``: "pallas" (K1), "culled" (K3), "bvh_walk"
    # (the walk; K1 on the card)
    accel_kind: str = "culled"
    # (F, 32) per-face row table, one row gather per hit. Columns: p0 e1 e2
    # n0 n1 n2 fn | area | uv0 uv1 uv2 | fmask | mesh_id bsdf_id emitter_id
    # (ids as exact f32)
    face_table: Optional[torch.Tensor] = None
    # (E,) int64 global face ids of all emitter geometry, or None when
    # absent or too large: enables the emitter-first bounce query
    em_tri_idx: Optional[torch.Tensor] = None
    envmap: Optional[EnvmapState] = None
    # set by detach_flat(): every tensor is detached, so ray_intersect
    # returns the hit query's own (t, uv) with no recompute
    detached: bool = False


def detach_flat(flat: FlatScene) -> FlatScene:
    """Detach every tensor, the edge tables included, and mark the scene
    detached."""
    return detach_tree(flat)._replace(detached=True)


class Scene:
    """Host-side scene: meshes, BSDFs, emitters and sensors, built into a
    ``FlatScene`` on ``device``."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self.meshes: list[Mesh] = []
        self.bsdfs: list = []
        self.emitters: list = []
        self.sensors: list[PerspectiveCamera] = []
        self._opts = RenderOptions()
        self.param_map: dict = {}
        self._flat_cache = None
        # the hit query: "auto" (K1, "pallas", on a CUDA scene, K3's
        # "culled" on a CPU scene, as JAX's auto picks its Pallas kernel on
        # a TPU and its block cull elsewhere), "brute", "culled" ("bvh" is
        # its alias), "pallas" or "bvh_walk"; under "auto" the BVH from
        # accel_min_faces faces up, brute force below
        self.accel_mode = "auto"
        self.accel_leaf_size = BVH_LEAF_SIZE
        self.accel_min_faces = 512
        self._bvh_topo: BVHTopology | None = None
        # counts the topology's rebuilds: a captured program whose body
        # builds the scene captures again when it changes
        # (``Program(retrace_on=...)``)
        self.accel_version = 0
        self.face_offset = [0]
        # optional Discrete that replaces the environment map's importance
        # table in every build (``convert.envmap_state_from_numpy``)
        self.envmap_distrb = None

    def to(self, device) -> "Scene":
        """The scene on ``device``, in place; ``accel_mode`` and
        ``accel_leaf_size`` stay, and "auto" resolves anew at the next
        build."""
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
        self._flat_cache = None
        key = f"BSDF[id={bsdf_id}]" if bsdf_id else f"BSDF[{len(self.bsdfs)-1}]"
        if bsdf_id:
            bsdf.id = bsdf_id
        self.param_map[key] = bsdf
        return len(self.bsdfs) - 1

    def add_mesh(self, mesh: Mesh) -> int:
        self.meshes.append(mesh)
        self._flat_cache = None
        self.param_map[f"Mesh[{len(self.meshes)-1}]"] = mesh
        return len(self.meshes) - 1

    def add_emitter(self, emitter) -> int:
        self.emitters.append(emitter)
        self._flat_cache = None
        self.param_map[f"Emitter[{len(self.emitters)-1}]"] = emitter
        if isinstance(emitter, AreaLight):
            self.meshes[emitter.mesh_index].emitter_id = len(self.emitters) - 1
        return len(self.emitters) - 1

    def add_sensor(self, sensor: PerspectiveCamera) -> int:
        self.sensors.append(sensor)
        self._flat_cache = None
        self.param_map[f"Sensor[{len(self.sensors)-1}]"] = sensor
        return len(self.sensors) - 1

    # -- loading ----------------------------------------------------------------
    @staticmethod
    def load_file(fname: str, auto_configure: bool = True,
                  device="cuda") -> "Scene":
        from .loader import load_file
        return load_file(fname, auto_configure, device=device)

    @staticmethod
    def load_string(xml: str, base_dir: str = ".", device="cuda") -> "Scene":
        from .loader import load_string
        return load_string(xml, base_dir, device=device)

    @property
    def envmap_index(self) -> int:
        for i, e in enumerate(self.emitters):
            if isinstance(e, EnvironmentMap):
                return i
        return -1

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

    @property
    def accel_mode(self) -> str:
        return self._accel_mode

    @accel_mode.setter
    def accel_mode(self, value: str) -> None:
        if value not in ACCEL_MODES:
            raise ValueError(f"accel_mode {value!r} not in {ACCEL_MODES}")
        self._accel_mode = value
        self._flat_cache = None

    def _use_bvh(self) -> bool:
        return (self.accel_mode in ("bvh", "bvh_walk", "culled", "pallas")
                or (self.accel_mode == "auto"
                    and sum(m.num_faces for m in self.meshes)
                    >= self.accel_min_faces))

    def _accel_kind(self) -> str:
        if self.accel_mode == "bvh":
            return "culled"
        if self.accel_mode in ("bvh_walk", "pallas", "culled"):
            return self.accel_mode
        return "pallas" if self.device.type == "cuda" else "culled"

    @profiling.span("scene.prepare_accel")
    def prepare_accel(self) -> None:
        """Build the static BVH topology (triangle Morton order + skip
        links) on the host from the current geometry; later builds only
        refit the AABBs."""
        if self._use_bvh() and self._bvh_topo is None:
            with torch.no_grad():
                tri = self.build(self.params()).tri
            self._bvh_topo = build_bvh_topology(
                tri.p0.cpu().numpy(), tri.e1.cpu().numpy(),
                tri.e2.cpu().numpy(), leaf_size=self.accel_leaf_size)

    @staticmethod
    def _leaf_area(perm, leaf_size, p0, e1, e2) -> float:
        """Total surface area of the leaf AABBs that a triangle permutation
        induces: the cull cost of a topology."""
        L = leaf_size
        idx = np.maximum(perm, 0).reshape(-1, L)
        ok = (perm >= 0).reshape(-1, L)[..., None]
        v0 = p0[idx]
        pts = np.stack([v0, v0 + e1[idx], v0 + e2[idx]], axis=2)
        big = np.float32(1e30)
        lo = np.where(ok[:, :, None], pts, big).min(axis=(1, 2))
        hi = np.where(ok[:, :, None], pts, -big).max(axis=(1, 2))
        ext = np.maximum(hi - lo, 0.0)
        any_tri = ok[:, :, 0].any(axis=1)
        area = 2 * (ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2]
                    + ext[:, 2] * ext[:, 0])
        return float(np.where(any_tri, area, 0.0).sum())

    def refit_quality(self, params: dict | None = None) -> float:
        """Ratio (>= ~1) of the current topology's refit leaf-AABB surface
        area to a fresh Morton build's, at ``params`` (default: the scene's
        own). The Morton order frozen by ``prepare_accel`` degrades under
        large deformation; a ratio well above 1 means rays sweep needlessly
        fat leaf boxes. Costs a build and a fresh topology on the host."""
        if self._bvh_topo is None:
            return 1.0
        with torch.no_grad():
            tri = self.build(self.params() if params is None else params).tri
        p0, e1, e2 = (x.cpu().numpy() for x in (tri.p0, tri.e1, tri.e2))
        fresh = build_bvh_topology(p0, e1, e2,
                                   leaf_size=self.accel_leaf_size)
        cur = self._leaf_area(self._bvh_topo.perm, self._bvh_topo.leaf_size,
                              p0, e1, e2)
        ref = self._leaf_area(fresh.perm, fresh.leaf_size, p0, e1, e2)
        return cur / max(ref, 1e-30)

    def maybe_rebuild_accel(self, params: dict | None = None,
                            threshold: float = 1.5) -> bool:
        """Rebuild the Morton topology when ``refit_quality`` has degraded
        past ``threshold``; call between optimizer steps. ``params`` (if
        given) become the scene's own first. Returns True on a rebuild.
        Every later ``build``, including those of a ``render_fn`` made
        before, refits the new topology; ``accel_version`` counts up, so
        every program whose body builds the scene (``retrace_on``) drops
        its graph at its next call and captures the new one. The old
        topology's device copies leave the upload cache: a program that
        does not build the scene but holds a flat scene keeps them alive
        itself."""
        if self._bvh_topo is None:
            return False
        if self.refit_quality(params) <= threshold:
            return False
        if params is not None:
            self.set_params(_host_tree(params))
        forget(self, self._bvh_topo.perm, self._bvh_topo.skip)
        self._bvh_topo = None
        self._flat_cache = None
        self.accel_version += 1
        self.prepare_accel()
        return True

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
    def num_sensors(self) -> int:
        return len(self.sensors)

    @property
    def bsdf_kinds(self):
        return tuple(b.kind for b in self.bsdfs)

    # -- the build ------------------------------------------------------------
    @profiling.span("scene.build")
    def build(self, params: dict) -> FlatScene:
        if not self.meshes or not self.sensors:
            raise ValueError("a scene needs meshes and a sensor")
        for em in self.emitters:
            if not isinstance(em, (AreaLight, EnvironmentMap)):
                raise NotImplementedError(
                    f"emitter {type(em).__name__} is not ported")
        check_kinds(self.bsdf_kinds)
        dev = self.device
        with_edges = self.opts.sppse > 0 or self.opts.sppe > 0

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
                vp, upload(mesh, mesh.faces, dev, torch.int64),
                mesh.num_vertices, mesh.corner_table(dev))
            if mesh.use_vertex_normals:
                # authored normals override the recomputed area-weighted
                # shading normals; geometric normals and edge silhouettes
                # stay position-derived
                n0, n1, n2 = mesh.world_shading_normals(mp)
                info = info._replace(n0=n0, n1=n1, n2=n2)
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

        # envmap + bounding mesh over the enlarged scene box
        env_idx = self.envmap_index
        envmap = None
        if env_idx >= 0:
            margin = torch.min((upper - lower) * 0.05)
            lower = lower - margin
            upper = upper + margin
            # the host radiance snapshot lets configure_envmap freeze a
            # large importance table once; unbiased even when the snapshot
            # lags optimized radiance params, because the stored pdf always
            # equals what the frozen table samples
            envmap = configure_envmap(
                params["emitters"][env_idx], lower, upper,
                host_radiance=self.emitters[env_idx].radiance.data)
            if self.envmap_distrb is not None:
                d = self.envmap_distrb
                if d.size != envmap.cell_distrb.num_cells:
                    raise ValueError(
                        f"envmap_distrb has {d.size} cells, the importance "
                        f"grid {envmap.cell_distrb.num_cells}")
                envmap = envmap._replace(
                    cell_distrb=envmap.cell_distrb._replace(
                        distrb=d, alias=None, hier=None))
            bits = const([[bool(i & (1 << j)) for j in range(3)]
                          for i in range(8)], torch.bool, dev)
            corners = torch.where(bits, upper, lower)
            bound_info, _ = compute_triangle_info(
                corners, const(_BOUND_FACES, torch.int64, dev), 8,
                const(_BOUND_CORNERS, torch.int64, dev))
            tri_infos_all = tri_infos + [bound_info]
        else:
            tri_infos_all = tri_infos

        tri = TriangleInfo(*(torch.cat(xs) for xs in zip(*tri_infos_all)))
        uv0_l, uv1_l, uv2_l, fmask_l, mid_l, bid_l, eid_l = ([] for _ in range(7))
        for i, mesh in enumerate(self.meshes):
            nf = mesh.num_faces
            if mesh.uv is not None:
                uvs = upload(mesh, mesh.uv, dev)
                uvi = upload(mesh, mesh.uv_idx, dev, torch.int64)
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
        if envmap is not None:
            z = torch.zeros((12, 2), device=dev)
            uv0_l.append(z); uv1_l.append(z); uv2_l.append(z)
            fmask_l.append(full(12, True, torch.bool))
            mid_l.append(full(12, len(self.meshes), torch.int32))
            bid_l.append(full(12, -1, torch.int32))
            eid_l.append(full(12, env_idx, torch.int32))

        # secondary-edge arrays, masked not compacted
        sec_list = [compute_sec_edge_info(vp, info, mesh.edge_table(dev))
                    for mesh, vp, info in zip(self.meshes, world_vps,
                                              tri_infos)
                    if mesh.enable_edges and with_edges
                    and mesh.edge_indices.shape[0]]
        if sec_list:
            sec_edge = SecondaryEdgeInfo(*(torch.cat(xs)
                                           for xs in zip(*sec_list)))
        else:
            z3 = torch.zeros((1, 3), device=dev)
            zb = torch.zeros((1,), dtype=torch.bool, device=dev)
            sec_edge = SecondaryEdgeInfo(valid=zb, is_boundary=zb, p0=z3,
                                         e1=z3, n0=z3, n1=z3, p2=z3)
        sec_distrb = discrete_init(torch.where(
            sec_edge.valid, norm(sec_edge.e1.detach()), 0.0))

        # emitters: radiance, 1/area, sampling weight = area x luminance
        rads, inv_areas, weights, face_distrbs = [], [], [], []
        for i, em in enumerate(self.emitters):
            if isinstance(em, EnvironmentMap):
                # its radiance is the bitmap's; sampling weight 1
                rads.append(torch.zeros((3,), device=dev))
                inv_areas.append(torch.zeros((), device=dev))
                weights.append(torch.ones((), device=dev))
                face_distrbs.append(discrete_init(torch.ones(1, device=dev)))
                continue
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

        # sensors: primary-edge tables
        if self.opts.sppe > 0:
            for k, st in enumerate(sensor_states):
                rows = [build_primary_edges(st, vp, info,
                                            mesh.edge_table(dev),
                                            mesh.use_face_normals)
                        for mesh, vp, info in zip(self.meshes, world_vps,
                                                  tri_infos)
                        if mesh.enable_edges and mesh.edge_indices.shape[0]]
                if rows:
                    stacked = PrimaryEdgeInfo(
                        *(torch.cat([getattr(r, f) for r in rows])
                          for f in PrimaryEdgeInfo._fields[:-1]),
                        distrb=rows[0].distrb)
                    sensor_states[k] = st._replace(
                        edges=finalize_primary_edges(stacked))

        accel = None
        if (self._bvh_topo is not None
                and self._bvh_topo.num_faces == tri.p0.shape[0]):
            topo = self._bvh_topo
            topo = topo._replace(perm=upload(self, topo.perm, dev),
                                 skip=upload(self, topo.skip, dev))
            accel = refit_bvh(topo, tri.p0, tri.e1, tri.e2)

        # static emitter-face index set
        em_meshes = tuple(i for i, mesh in enumerate(self.meshes)
                          if mesh.emitter_id >= 0)
        em_tri_idx = memo(self, ("em_tri_idx", str(dev), tuple(face_offset),
                                 em_meshes, envmap is not None),
                          lambda: _emitter_faces(face_offset, em_meshes,
                                                 envmap is not None, dev))

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
            sec_edge=sec_edge, sec_distrb=sec_distrb,
            emitter_radiance=radiance, emitter_weight=emitter_weight,
            emitter_inv_area=inv_area, emitter_distrb=emitter_distrb,
            emitter_face_distrb=tuple(face_distrbs),
            sensors=tuple(sensor_states), bsdfs=tuple(params["bsdfs"]),
            lower=lower, upper=upper, accel=accel,
            accel_kind=self._accel_kind(), face_table=face_table,
            em_tri_idx=em_tri_idx, envmap=envmap)

    def __repr__(self):
        return ("Scene[\n  # Sensors\n  " + "\n  ".join(map(repr, self.sensors))
                + "\n  # BSDFs\n  " + "\n  ".join(map(repr, self.bsdfs))
                + "\n  # Meshes\n  " + "\n  ".join(map(repr, self.meshes)) + "\n]")


def _emitter_faces(face_offset, em_meshes, with_envmap: bool, dev):
    """The global face ids of all emitter geometry as an int64 tensor, or
    None when there is none or more than 8192 faces (past a few thousand
    faces the full accel path wins again)."""
    em_rows = [np.arange(face_offset[i], face_offset[i + 1])
               for i in em_meshes]
    if with_envmap:
        em_rows.append(np.arange(face_offset[-1], face_offset[-1] + 12))
    if not em_rows:
        return None
    em_cat = np.concatenate(em_rows)
    if em_cat.shape[0] > 8192:
        return None
    return torch.as_tensor(em_cat, device=dev)


def _host_tree(tree):
    """A params tree with every leaf as detached float32 numpy."""
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_tree(v) for v in tree)
    return _host(tree)


# -- scene queries (functions of a FlatScene) --------------------------------

# the segmented sort's implementation, by the JAX package's names: its
# "argsort" (a stable sort network) and "counting" (a one-hot running
# count) give one permutation, which one stable segmented sort of 8-bit
# keys gives here for both (a one-hot reads its indices back on the card)
_SORT_IMPLS = ("argsort", "counting")
_SORT_IMPL = os.environ.get("PSDR_TPU_SORT_IMPL", "argsort")


def _octant_sort(ray: Ray, active: torch.Tensor, seg: int = 1 << 15,
                 want_inv: bool = True, impl: str | None = None):
    """Stable reorder within ``seg``-lane segments (4096-lane ones where
    ``seg`` does not divide the lanes, one where the batch is smaller) by
    direction: 64 bins, 4 a component, inactive lanes last in their
    segment, so a sparse batch gathers its active lanes at the front of
    each segment. Returns (permutation, inverse permutation, or None
    without ``want_inv``) as int64, or (None, None) where the lanes do not
    divide into segments. A stable argsort of uint8 keys along each
    segment, then the inverse by a scatter: no host read. ``impl``
    (default ``PSDR_TPU_SORT_IMPL``) names the JAX implementation; both
    give the same permutation."""
    impl = impl or _SORT_IMPL
    if impl not in _SORT_IMPLS:
        raise ValueError(f"sort impl {impl!r} not in {_SORT_IMPLS}")
    d = ray.d.detach()
    n = d.shape[0]
    s = min(seg if n % seg == 0 else 4096, n)
    if s == 0 or n % s:
        return None, None
    dev = d.device
    # the bin of each component: trunc((d + 1) * 2) clipped to [0, 3]
    q = torch.clamp(((d + 1.0) * 2.0).to(torch.int32), 0, 3)
    key = (q * const((16, 4, 1), torch.int32, dev)).sum(dim=1)
    key = torch.where(active.detach(), key, 64).to(torch.uint8)
    local = torch.argsort(key.reshape(n // s, s), dim=1, stable=True)
    perm = (local + torch.arange(0, n, s, device=dev)[:, None]).reshape(n)
    if not want_inv:
        return perm, None
    lanes = torch.arange(n, device=dev)
    return perm, torch.empty_like(perm).scatter_(0, perm, lanes)


def _permuted(perm: torch.Tensor, ray: Ray, active: torch.Tensor, tmax):
    """(o, d, active, tmax) of the lanes ``perm``, each gathered on its
    own (``index_select``), contiguous as the kernels take them (tmax:
    (N,) or None). On the card one gather a field moves fewer bytes than
    packing the fields into rows first, as the JAX package does for the
    TPU."""
    def take(x):
        return torch.index_select(x.detach(), 0, perm)
    return (take(ray.o), take(ray.d), take(active),
            None if tmax is None
            else take(torch.broadcast_to(tmax, active.shape)))


def _unpermuted(hit: HitRecord, perm: torch.Tensor) -> HitRecord:
    """The record of the batch permuted by ``perm`` in the lanes' own
    order, field by field scattered back through ``perm`` (no inverse
    permutation needed)."""
    def back(x):
        return torch.empty_like(x).index_copy_(0, perm, x)
    return HitRecord(
        valid=torch.zeros_like(hit.valid).scatter_(0, perm, hit.valid),
        tri_id=back(hit.tri_id), uv=back(hit.uv), t=back(hit.t))


@profiling.span("intersect")
def _closest_hit(flat: FlatScene, ray: Ray, active: torch.Tensor, tmax=None,
                 sort_rays: bool = False, any_hit: bool = False,
                 test_only: bool = False):
    """Detached hit query, by ``flat.accel_kind``: K1 (``pallas``), K3
    (``culled``: ``accel/bvh.py`` ``ray_intersect_culled``; its plain
    version on the CPU), the walk (``bvh_walk``: ``ray_intersect_bvh``),
    or brute force (K2) without a tree. ``any_hit`` lets K1 stop at the
    first hit; the others return the closest, also a valid any-hit answer.

    ``sort_rays`` (with a tree): the kernel runs on the batch in
    ``_octant_sort``'s order, gathered in and its record scattered back
    through the permutation (``_permuted``, ``_unpermuted``); the JAX
    package's packed row gathers through the permutation and its inverse
    come to the same lanes. ``test_only`` returns only the (N,) hit
    booleans.

    The TPU kernel's block schedule (``ray_block``, ``sub_split``,
    ``front_to_back``) has no counterpart: K1 walks each ray's tree nearest
    child first."""
    perm = None
    q_o, q_d, q_act, q_tmax = ray.o, ray.d, active, tmax
    if sort_rays and flat.accel is not None:
        perm, _ = _octant_sort(ray, active, want_inv=False)
        if perm is not None:
            q_o, q_d, q_act, q_tmax = _permuted(perm, ray, active, tmax)
    if flat.accel is None:
        hit = ray_intersect_brute(flat.tri.p0, flat.tri.e1, flat.tri.e2,
                                  ray.o, ray.d, active, tmax=tmax)
    elif flat.accel_kind == "pallas":
        hit = ray_intersect_k1(flat.accel, q_o, q_d, q_act, q_tmax,
                               any_hit=any_hit)
    elif flat.accel_kind == "bvh_walk":
        hit = ray_intersect_bvh(flat.accel, q_o, q_d, q_act, tmax=q_tmax)
    else:
        hit = ray_intersect_culled(flat.accel, q_o, q_d, q_act, tmax=q_tmax)
    if test_only:
        if perm is None:
            return hit.valid
        return torch.zeros_like(hit.valid).scatter_(0, perm, hit.valid)
    return hit if perm is None else _unpermuted(hit, perm)


@profiling.span("intersect")
def ray_test(flat: FlatScene, ray: Ray, dist: torch.Tensor,
             active: torch.Tensor, sort_rays: bool = False,
             sparse: bool = False) -> torch.Tensor:
    """Occlusion query: True where some surface lies strictly closer than
    ``dist - ShadowEpsilon``. ``sparse`` (under K1, ``accel_kind``
    "pallas"): few lanes are expected active, and the sweep is compacted
    (``_ray_test_sparse``); otherwise one any-hit sweep, sorted with
    ``sort_rays``."""
    tmax = dist.detach() - ShadowEpsilon
    if sparse and flat.accel is not None and flat.accel_kind == "pallas":
        occ = _ray_test_sparse(flat, ray, tmax, active)
        if occ is not None:
            return occ & active
    occ = _closest_hit(flat, ray, active, tmax=tmax, any_hit=True,
                       sort_rays=sort_rays, test_only=True)
    return occ & active


@profiling.span("intersect")
def _ray_test_sparse(flat: FlatScene, ray: Ray, tmax: torch.Tensor,
                     active: torch.Tensor, frac_shift: int = 3,
                     seg: int = 1 << 15):
    """Compacted any-hit sweep under K1: the lanes in ``_octant_sort``'s
    order (``_compacted``), K1 on the first ``s >> frac_shift`` of
    each ``s``-lane segment (where the sort puts a segment's active lanes,
    as many as fit), then K1 once more on the whole sorted batch with only
    the lanes past that cap active (none unless a segment overflows), the
    two ORed and scattered back. Equal to the dense sweep lane for lane,
    with no host read: the JAX package branches to its dense sweep on a
    device value (``lax.cond``) where a segment overflows, which here would
    read that value back. None where the lanes do not divide into segments
    or the cap falls below 128 lanes (the caller sweeps densely)."""
    n = ray.d.shape[0]
    s = min(seg if n % seg == 0 else 4096, n)   # as _octant_sort sizes it
    ks = s >> frac_shift
    if s == 0 or n % s or ks < 128:
        return None
    perm, _ = _octant_sort(ray, active, seg=seg, want_inv=False)
    head, rest = _compacted(perm, ray, tmax, active, s, ks)
    hit_k = ray_intersect_k1(flat.accel, *head, any_hit=True)
    hit_r = ray_intersect_k1(flat.accel, *rest, any_hit=True)
    return _scattered(perm, hit_k.valid & head[2], hit_r.valid, s, ks)


def _compacted(perm, ray: Ray, tmax, active, s: int, ks: int):
    """The lanes in ``perm``'s order (``_permuted``) as two K1 batches,
    each (o, d, active, tmax): the first ``ks`` lanes of each ``s``-lane
    segment, and the whole batch with only the lanes past that cap
    active."""
    o, d, act, tm = _permuted(perm, ray, active, tmax)
    n = o.shape[0]
    cap = (torch.arange(n, device=o.device) % s) < ks

    def head(x):
        return x.reshape((n // s, s) + x.shape[1:])[:, :ks].reshape(
            (-1,) + x.shape[1:])
    return (head(o), head(d), head(act), head(tm)), (o, d, act & ~cap, tm)


def _scattered(perm, occ_head, occ_rest, s: int, ks: int):
    """The occlusion of the two batches of ``_compacted`` in the lanes'
    own order: the head's answers in the first ``ks`` lanes of each
    segment, the rest's after them, scattered through ``perm``."""
    n = occ_rest.shape[0]
    occ = torch.cat([occ_head.reshape(n // s, ks),
                     occ_rest.reshape(n // s, s)[:, ks:]], dim=1)
    return torch.zeros_like(occ_rest).scatter_(0, perm, occ.reshape(n))


@profiling.span("intersect")
def ray_intersect_emitter_first(flat: FlatScene, ray: Ray,
                                active: torch.Tensor,
                                sort_rays: bool = True,
                                want_tri_info: bool = False):
    """Closest hit restricted to emitter geometry, plus a tmax-bounded
    any-hit occlusion sweep of the full scene. Exact wherever the caller
    reads the hit only on emitter lanes: a bounce ray counts iff its
    nearest emitter hit exists and nothing occludes it. The emitter sweep
    is K2's (``ray_intersect_brute``) on the card."""
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
    # the recompute reads only emitter rows here: select them from the
    # compact (E, 32) emitter slice of the face table
    rows = select_rows(gather_rows(flat.face_table, idxs), e_local)
    return ray_intersect(flat, ray, active, path_space=True, hit=hit,
                         rows=rows, want_tri_info=want_tri_info)


@profiling.span("intersect")
def ray_intersect(flat: FlatScene, ray: Ray, active: torch.Tensor,
                  path_space: bool = False, want_tri_info: bool = False,
                  sort_rays: bool = False, hit=None, rows=None):
    """Detached closest hit + differentiable recompute -> ``Intersection``
    (and the hit's ``TriangleInfo`` with ``want_tri_info``). ``hit``: a
    precomputed detached HitRecord; ``rows``: the matching (N, 32)
    face-table rows.

    ``path_space``: the hit point is re-derived from the triangle at the
    query's (detached) barycentrics, so it moves with the geometry, and J
    is the area ratio. Otherwise (solid angle) the ray is re-intersected
    with the hit triangle and J = 1. On a detached scene both give the
    query's own record, read without a recompute."""
    if hit is None:
        hit = _closest_hit(flat, ray, active, sort_rays=sort_rays)
    valid = hit.valid & active
    idx = torch.clamp(hit.tri_id, min=0).long()
    if flat.detached and not want_tri_info:
        return _intersection_detached(flat, ray, hit, valid, idx, rows)

    if rows is None:
        rows = gather_rows(flat.face_table, idx)
    tri = TriangleInfo(
        p0=rows[:, 0:3], e1=rows[:, 3:6], e2=rows[:, 6:9],
        n0=rows[:, 9:12], n1=rows[:, 12:15], n2=rows[:, 15:18],
        face_normal=rows[:, 18:21], face_area=rows[:, 21])
    uv0g, uv1g, uv2g = rows[:, 22:24], rows[:, 24:26], rows[:, 26:28]
    fmask = rows[:, 28] > 0.5
    mesh_id_g = rows[:, 29].to(torch.int32)
    bsdf_id_g = rows[:, 30].to(torch.int32)
    emitter_id_g = rows[:, 31].to(torch.int32)

    if path_space:
        uv = hit.uv.detach()
        p = bilinear(tri.p0, tri.e1, tri.e2, uv)
        # miss lanes read triangle 0; were the ray origin on it, the norm
        # below would have a NaN gradient at 0: park dead lanes at o + d
        p = torch.where(valid[..., None], p, (ray.o + ray.d).detach())
        d = p - ray.o
        # sqrt(max(., eps)): a grazing hit whose barycentric recompute
        # rounds to p == o must not put sqrt's 0/0 gradient on the lane
        t = torch.sqrt(torch.clamp(squared_norm(d), min=1e-16))
        d = d / t[..., None]
        wi_world = -d
        J = tri.face_area / tri.face_area.detach()
    else:
        uv, t = ray_intersect_triangle(tri.p0, tri.e1, tri.e2, ray.o, ray.d)
        # keep the recompute finite on every lane: a caller-provided hit
        # may mark a near-coplanar lane valid, whose unclamped t ~ 1e20
        # would turn into inf/NaN downstream. Real hits lie far inside
        # the clamps, which then pass gradients through.
        t = torch.clamp(t, -1e6, 1e6)
        uv = torch.clamp(uv, -8.0, 8.0)
        # miss lanes recompute against triangle 0: park them at t = 1
        t = torch.where(valid, t, 1.0)
        uv = torch.where(valid[..., None], uv, 0.0)
        p = ray.at(t)
        wi_world = -ray.d
        J = torch.ones_like(t)

    sh_n = normalize(bilinear(tri.n0, tri.n1 - tri.n0, tri.n2 - tri.n0, uv))
    sh_n = torch.where(fmask[..., None], tri.face_normal, sh_n)
    frame = make_frame(sh_n)
    uv_tex = bilinear(uv0g, uv1g - uv0g, uv2g - uv0g, uv)
    its = Intersection(
        valid=valid, t=t, p=p, n=tri.face_normal, sh_frame=frame,
        uv=uv_tex, wi=to_local(frame, wi_world), J=J,
        mesh_id=mesh_id_g, tri_id=hit.tri_id,
        bsdf_id=torch.where(valid, bsdf_id_g, -1),
        emitter_id=torch.where(valid, emitter_id_g, -1))
    if want_tri_info:
        return its, tri
    return its


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


@profiling.span("intersect")
def ray_intersect_with_prior(flat: FlatScene, ray: Ray, active: torch.Tensor,
                             prior=None) -> Intersection:
    """Camera closest hit bounded by the camera-hit prior
    (``RenderOptions.camera_hit_prior``). ``prior`` is the detached tuple
    ``(tmax_bound, cand_tri_id, cand_uv, cand_t, cand_ok)`` from
    ``integrator.base.camera_prior_for_rays``: where a lane's ray hits its
    pixel's candidate triangle at t0, the query runs with tmax about t0
    (a real hit bounds the closest t, so the result is exact); lanes whose
    query rejects the candidate by an ulp and finds nothing else inside
    the bound take the candidate hit itself."""
    if prior is None:
        return ray_intersect(flat, ray, active)
    tmax_b, cand_tri, cand_uv, cand_t, cand_ok = prior
    hit = _closest_hit(flat, ray, active, tmax=tmax_b)
    resc = active & cand_ok & ~hit.valid
    hit = HitRecord(valid=hit.valid | resc,
                    tri_id=torch.where(resc, cand_tri, hit.tri_id),
                    uv=torch.where(resc[..., None], cand_uv, hit.uv),
                    t=torch.where(resc, cand_t, hit.t))
    return ray_intersect(flat, ray, active, hit=hit)


@profiling.span("emitter")
def scene_le(flat: FlatScene, its: Intersection,
             active: torch.Tensor) -> torch.Tensor:
    """Emitted radiance toward the viewer at a hit (one-sided)."""
    active = active & its.is_emitter()
    eid = torch.clamp(its.emitter_id, min=0)
    front = its.wi[..., 2] > 0.0
    le = torch.where((active & front)[..., None],
                     select_rows(flat.emitter_radiance, eid), 0.0)
    if flat.envmap is not None:
        wi_world = frame_to_world(its.sh_frame, its.wi)
        env_mask = active & (its.bsdf_id < 0)
        le = torch.where(env_mask[..., None],
                         envmap_eval_direction(flat.envmap, -wi_world,
                                               env_mask), le)
    return le


@profiling.span("emitter")
def sample_emitter_position(flat: FlatScene, face_offsets, emitter_meta,
                            ref_p: torch.Tensor, sample2: torch.Tensor,
                            active: torch.Tensor) -> PositionSample:
    """Pick an emitter proportional to its weight, then sample its surface.
    ``emitter_meta``: static list of ('area', mesh_index) / ('env', -1); an
    environment sample's ``emitter`` is -1."""
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
        mask = active & (idx == i)
        if kind == "area":
            lo, hi = face_offsets[mesh_index], face_offsets[mesh_index + 1]
            tri_slice = TriangleInfo(*(a[lo:hi] for a in flat.tri))
            ps = sample_position(tri_slice, flat.emitter_face_distrb[i],
                                 flat.emitter_inv_area[i], s2)
        else:
            ps = envmap_sample_position(flat.envmap, ref_p, s2, mask)
        m3 = mask[..., None]
        out = PositionSample(
            valid=torch.where(mask, ps.valid, out.valid),
            pdf=torch.where(mask, ps.pdf, out.pdf),
            p=torch.where(m3, ps.p, out.p),
            n=torch.where(m3, ps.n, out.n),
            J=torch.where(mask, ps.J, out.J),
            emitter=torch.where(mask, i if kind == "area" else -1,
                                out.emitter))
    return out._replace(pdf=out.pdf * sel_pdf, valid=out.valid & active)


@profiling.span("emitter")
def emitter_position_pdf(flat: FlatScene, emitter_meta, ref_p: torch.Tensor,
                         its: Intersection,
                         active: torch.Tensor) -> torch.Tensor:
    """Area-measure pdf of reaching this emitter point by light sampling,
    with the normalized sampling weights."""
    active = active & its.is_emitter()
    eid = torch.clamp(its.emitter_id, min=0)
    env_w = select_rows(flat.emitter_weight, eid)
    pdf = torch.where(active,
                      env_w * select_rows(flat.emitter_inv_area, eid), 0.0)
    if flat.envmap is not None:
        env_mask = active & (its.bsdf_id < 0)
        env_pdf = envmap_position_pdf(flat.envmap, ref_p, its.p, its.n,
                                      env_mask)
        pdf = torch.where(env_mask, env_w * env_pdf, pdf)
    return pdf


def sec_edge_rows(flat: FlatScene, edge_idx: torch.Tensor,
                  with_ends: bool = True):
    """The sampled edges' rows of ``flat.sec_edge`` -> (SecondaryEdgeInfo,
    ok), ``ok`` where the edge is valid and has a positive pmf. Two packed
    row gathers: the endpoint and edge vector, which carry the gradient
    (left out, as None, without ``with_ends``), and the columns that are
    read detached. The lanes are sorted by edge, so equal indices come in
    long runs: gather_rows (backward: a fixed-order segmented sum), not
    table[idx]."""
    se = flat.sec_edge
    p0 = e1 = None
    if with_ends:
        ends = gather_rows(torch.cat([se.p0, se.e1], dim=1), edge_idx)
        p0, e1 = ends[:, 0:3], ends[:, 3:6]
    rest = gather_rows(torch.cat(
        [se.n0, se.n1, se.p2, se.valid.float()[:, None],
         se.is_boundary.float()[:, None], flat.sec_distrb.pmf[:, None]],
        dim=1).detach(), edge_idx)
    info = SecondaryEdgeInfo(
        p0=p0, e1=e1, n0=rest[:, 0:3], n1=rest[:, 3:6],
        p2=rest[:, 6:9], valid=rest[:, 9] > 0.5,
        is_boundary=rest[:, 10] > 0.5)
    return info, info.valid & (rest[:, 11] > 0.0)


def sample_boundary_segment_direct(flat: FlatScene, face_offsets,
                                   emitter_meta, sample3: torch.Tensor,
                                   active: torch.Tensor) -> BoundarySegSample:
    """Sample (edge point p0, emitter point p2) for the direct boundary
    integral. Only ``p0`` carries a gradient."""
    edge_idx, pdf0, s1 = discrete_sample_reuse(flat.sec_distrb,
                                               sample3[..., 0])
    info, ok = sec_edge_rows(flat, edge_idx)

    p0 = info.p0 + info.e1 * s1[..., None]           # differentiable
    e1_det = info.e1.detach()
    edge = normalize(e1_det)
    edge2 = info.p2 - info.p0.detach()
    p0_det = p0.detach()
    pdf0 = pdf0 / torch.clamp(norm(e1_det), min=1e-20)

    # the emitter point is read detached: no graph (reverse mode), and no
    # tangent either (forward mode, which no_grad leaves on)
    with torch.no_grad():
        ps2 = detach_tree(sample_emitter_position(
            flat, face_offsets, emitter_meta, p0_det, sample3[..., 1:3],
            active))

    e = ps2.p - p0_det
    dist_sqr = squared_norm(e)
    e = e / safe_sqrt(dist_sqr)[..., None]
    cos_theta = dot(ps2.n, -e)

    sgn0 = sign_eps(dot(info.n0, e), EdgeEpsilon)
    sgn1 = sign_eps(dot(info.n1, e), EdgeEpsilon)
    valid = (active & ok & ps2.valid & (cos_theta > Epsilon)
             & torch.where(info.is_boundary, sgn0 != 0, sgn0 * sgn1 < 0))
    pdf = torch.where(valid, pdf0 * ps2.pdf * dist_sqr / cos_theta, 0.0)
    return BoundarySegSample(valid=valid, p0=p0, edge=edge, edge2=edge2,
                             p2=ps2.p, n=ps2.n, pdf=pdf)
