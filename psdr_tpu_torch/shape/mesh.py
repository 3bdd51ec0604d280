"""Triangle meshes: host-side topology (OBJ load and dump, the
edge-adjacency table) and the world-space geometry build. Counterpart of
``psdr_tpu/shape/mesh.py``. Authored vertex normals (``normals`` and
``normal_idx``, an OBJ's vn channels) override the area-weighted shading
normals with ``use_vertex_normals``."""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core import transform as xform
from ..core import warp
from ..core.constants import EdgeEpsilon
from ..core.distribution import Discrete, discrete_sample_reuse
from ..core.gather import (gather_rows, segment_sum, segment_table,
                           select_rows)
from ..core.hoist import memo, upload
from ..core.math import bilinear, cross, norm, normalize
from ..core.records import PositionSample


class TriangleInfo(NamedTuple):
    """World-space per-face SoA."""
    p0: torch.Tensor           # (F, 3)
    e1: torch.Tensor           # (F, 3)
    e2: torch.Tensor           # (F, 3)
    n0: torch.Tensor           # (F, 3) vertex normals
    n1: torch.Tensor
    n2: torch.Tensor
    face_normal: torch.Tensor  # (F, 3) unit
    face_area: torch.Tensor    # (F,)


class SecondaryEdgeInfo(NamedTuple):
    """Per-edge silhouette-candidate data. ``valid`` is a mask, not a
    compaction: invalid rows get zero sampling weight."""
    valid: torch.Tensor        # (E,) bool  (dihedral filter & enable_edges)
    is_boundary: torch.Tensor  # (E,) bool  (open edge: one adjacent face)
    p0: torch.Tensor           # (E, 3) first endpoint
    e1: torch.Tensor           # (E, 3) p1 - p0
    n0: torch.Tensor           # (E, 3) adjacent face 0 normal
    n1: torch.Tensor           # (E, 3) adjacent face 1 normal (n0 where open)
    p2: torch.Tensor           # (E, 3) opposite vertex of face 0


def vertex_corner_table(faces, num_vertices: int) -> np.ndarray:
    """``segment_table`` of the face corners by vertex: for each vertex, the
    rows ``i * F + f`` (corner i of face f) that touch it, corner 0 of every
    face first, then corner 1, then corner 2."""
    return segment_table(np.asarray(faces).T, num_vertices)


def compute_triangle_info(vertex_positions: torch.Tensor,
                          faces: torch.Tensor, num_vertices: int,
                          corners: torch.Tensor):
    """Per-face SoA + area-weighted vertex normals. ``corners`` is
    ``vertex_corner_table(faces)`` on the device: each vertex sums its
    corners' face normals in one fixed order (``core.gather.segment_sum``).
    An atomic scatter-add on the card sums in another order on every run,
    and the last bits of a shading normal then move a bounce ray's
    direction from run to run, which discrete tests downstream (hit or
    miss, a boundary sample's validity) amplify."""
    faces = faces.long()
    nf = faces.shape[0]
    # corner i of face f at row i * F + f, as the corner table counts them;
    # row gathers (core.gather), whose backward sums in one fixed order
    corner = faces.t().reshape(-1)
    p0, p1, p2 = gather_rows(vertex_positions, corner).split(nf)
    e1 = p1 - p0
    e2 = p2 - p0

    fn = cross(e1, e2)
    fa = norm(fn)

    vn = segment_sum(torch.cat([fn, fn, fn]), corners)
    vw = segment_sum(torch.cat([fa, fa, fa]), corners)
    vn = normalize(vn / torch.clamp(vw, min=1e-20)[:, None])

    n0, n1, n2 = gather_rows(vn, corner).split(nf)
    info = TriangleInfo(
        p0=p0, e1=e1, e2=e2, n0=n0, n1=n1, n2=n2,
        face_normal=fn / torch.clamp(fa, min=1e-20)[:, None],
        face_area=fa * 0.5,
    )
    return info, vn


def compute_sec_edge_info(vertex_positions: torch.Tensor,
                          tri_info: TriangleInfo,
                          edge_indices) -> SecondaryEdgeInfo:
    """World-space silhouette-candidate edges of one mesh from its
    ``(E, 5)`` edge table (an array, or ``Mesh.edge_table``'s tensor)."""
    ei = torch.as_tensor(edge_indices, device=vertex_positions.device).long()
    is_boundary = ei[:, 3] < 0
    f1 = torch.clamp(ei[:, 3], min=0)
    ne = ei.shape[0]
    p0, p1, p2 = gather_rows(vertex_positions, torch.cat(
        [ei[:, 0], ei[:, 1], ei[:, 4]])).split(ne)
    e1 = p1 - p0
    n0, fn1 = gather_rows(tri_info.face_normal,
                          torch.cat([ei[:, 2], f1])).split(ne)
    n1 = torch.where(is_boundary[:, None], n0, fn1)
    # dihedral filter: drop edges whose adjacent faces are (nearly) coplanar
    keep = (torch.sum(n0 * n1, dim=-1) < 1.0 - EdgeEpsilon) | is_boundary
    return SecondaryEdgeInfo(valid=keep, is_boundary=is_boundary,
                             p0=p0, e1=e1, n0=n0, n1=n1, p2=p2)


class Mesh:
    """Host-side mesh: static topology + parameter leaves.

    * ``vertex_positions``: raw object-space positions (V, 3);
    * ``to_world``: 4x4 object-to-world matrix, composed as
      ``to_world_left @ to_world @ to_world_right`` with two static outer
      factors (``append_transform`` grows the left one);
    * ``vertex_offset`` (with ``enable_vertex_offset``): one scalar per
      vertex, a displacement along the raw area-weighted vertex normals
      applied before the transform, so a shape optimization moves vertices
      along the normal only. ``shift_vertices`` bakes it into the raw
      positions.
    """

    def __init__(self, vertices: np.ndarray, faces: np.ndarray,
                 uv: Optional[np.ndarray] = None,
                 uv_idx: Optional[np.ndarray] = None,
                 use_face_normals: bool = False,
                 enable_edges: bool = True,
                 enable_vertex_offset: bool = False,
                 normals: Optional[np.ndarray] = None,
                 normal_idx: Optional[np.ndarray] = None,
                 use_vertex_normals: bool = False,
                 bsdf_id: int = -1, emitter_id: int = -1,
                 mesh_id: str = ""):
        self.vertices = np.ascontiguousarray(vertices, np.float32)
        self.faces = np.ascontiguousarray(faces, np.int32)
        self.uv = None if uv is None else np.ascontiguousarray(uv, np.float32)
        self.uv_idx = (None if uv_idx is None
                       else np.ascontiguousarray(uv_idx, np.int32))
        self.use_face_normals = bool(use_face_normals)
        # authored normals: (Nn, 3) rows and per-corner (F, 3) indices into
        # them. All or nothing: every face corner must name a normal
        self.normals = (None if normals is None
                        else np.ascontiguousarray(normals, np.float32))
        self.normal_idx = (None if normal_idx is None
                           else np.ascontiguousarray(normal_idx, np.int32))
        self.use_vertex_normals = bool(use_vertex_normals)
        if self.use_vertex_normals and (
                self.normals is None or self.normal_idx is None
                or (self.normal_idx < 0).any()):
            raise ValueError(
                "use_vertex_normals=True requires authored normals on every "
                "face corner (normals and normal_idx)")
        # silhouette edges feed the boundary terms only
        self.enable_edges = bool(enable_edges)
        self.bsdf_id = int(bsdf_id)
        self.emitter_id = int(emitter_id)
        self.id = mesh_id
        self.num_vertices = int(self.vertices.shape[0])
        self.num_faces = int(self.faces.shape[0])
        self.edge_indices = (build_edges(self.faces) if self.enable_edges
                             else np.zeros((0, 5), np.int32))
        self.vertex_positions = self.vertices
        self.enable_vertex_offset = bool(enable_vertex_offset)
        self.vertex_offset = (np.zeros((self.num_vertices,), np.float32)
                              if self.enable_vertex_offset else None)
        self.to_world = np.eye(4, dtype=np.float32)
        self.to_world_left = np.eye(4, dtype=np.float32)
        self.to_world_right = np.eye(4, dtype=np.float32)

    def edge_table(self, device) -> torch.Tensor:
        """``edge_indices`` as int64 on ``device``: static topology, so it is
        uploaded once and again only after ``edge_indices`` is replaced."""
        return upload(self, self.edge_indices, device, torch.int64)

    def params(self) -> dict:
        p = {"vertex_positions": self.vertex_positions,
             "to_world": self.to_world}
        if self.enable_vertex_offset:
            p["vertex_offset"] = self.vertex_offset
        return p

    def set_params(self, p: dict) -> None:
        self.vertex_positions = p["vertex_positions"]
        self.to_world = p["to_world"]
        if self.enable_vertex_offset and "vertex_offset" in p:
            self.vertex_offset = p["vertex_offset"]

    def set_transform(self, mat) -> None:
        self.to_world = np.asarray(mat, np.float32)

    def append_transform(self, mat) -> None:
        self.to_world_left = np.asarray(mat, np.float32) @ self.to_world_left

    def _composite(self, to_world: torch.Tensor) -> torch.Tensor:
        """``to_world_left @ to_world @ to_world_right``."""
        dev = to_world.device
        return (upload(self, self.to_world_left, dev) @ to_world
                @ upload(self, self.to_world_right, dev))

    def corner_table(self, device) -> torch.Tensor:
        """``vertex_corner_table`` of the faces on ``device``, made once
        per faces array and device."""
        faces = self.faces
        return memo(self, ("corner_table", id(faces), str(device)),
                    lambda: (faces, torch.as_tensor(
                        vertex_corner_table(faces, self.num_vertices),
                        device=device)))[1]

    def world_positions(self, params: dict) -> torch.Tensor:
        vp = params["vertex_positions"]
        off = params.get("vertex_offset")
        if off is not None:
            # displace the raw positions along the raw area-weighted
            # normals, themselves a differentiable function of the raw
            # positions, before the world transform
            _, vn = compute_triangle_info(
                vp, upload(self, self.faces, vp.device, torch.int64),
                self.num_vertices, self.corner_table(vp.device))
            vp = vp + off[:, None] * vn
        return xform.transform_pos(self._composite(params["to_world"]), vp)

    def world_shading_normals(self, params: dict):
        """Per-corner world-space shading normals from the authored
        normals: rows transform by the inverse transpose of the composite
        ``to_world``'s linear part (differentiable in ``to_world``; the raw
        normals are authored data, not a function of the positions)."""
        m = self._composite(params["to_world"])
        n = (upload(self, self.normals, m.device)
             @ torch.linalg.inv_ex(m[:3, :3]).inverse)
        n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True),
                            min=1e-20)
        ni = upload(self, self.normal_idx, m.device, torch.int64)
        return n[ni[:, 0]], n[ni[:, 1]], n[ni[:, 2]]

    def shift_vertices(self) -> None:
        """Bake the current (detached) offset into the raw positions and
        reset it to zero: call between optimization epochs to re-anchor the
        offset parameterization."""
        if not self.enable_vertex_offset:
            return
        vp = _host(self.vertex_positions)
        self.vertex_positions = vp + _host(self.vertex_offset)[:, None] * \
            _vertex_normals_np(vp, self.faces)
        self.vertex_offset = np.zeros((self.num_vertices,), np.float32)

    def dump(self, fname: str) -> None:
        """Write the current raw geometry to an OBJ file; a pending vertex
        offset is baked into the written positions."""
        vp = _host(self.vertex_positions)
        if self.enable_vertex_offset:
            vp = vp + _host(self.vertex_offset)[:, None] * \
                _vertex_normals_np(vp, self.faces)
        lines = ["v %.6e %.6e %.6e\n" % tuple(r) for r in vp]
        if self.uv is not None:
            lines += ["vt %.6e %.6e\n" % tuple(r) for r in self.uv]
        f1 = self.faces.astype(np.int64) + 1
        if self.uv_idx is not None:
            t1 = self.uv_idx.astype(np.int64) + 1
            lines += [f"f {a}/{ta} {b}/{tb} {c}/{tc}\n"
                      for (a, b, c), (ta, tb, tc) in zip(f1.tolist(),
                                                         t1.tolist())]
        else:
            lines += [f"f {a} {b} {c}\n" for a, b, c in f1.tolist()]
        with open(fname, "w") as fh:
            fh.writelines(lines)

    def __repr__(self):
        return (f"Mesh[nv={self.num_vertices}, nf={self.num_faces}"
                + (f", id={self.id}" if self.id else "") + "]")


def _host(x) -> np.ndarray:
    """A leaf (numpy array or tensor) as detached float32 numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def _vertex_normals_np(vp: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Host-side area-weighted vertex normals (the numpy twin of
    ``compute_triangle_info``'s normal pass, for baking an offset)."""
    p0, p1, p2 = vp[faces[:, 0]], vp[faces[:, 1]], vp[faces[:, 2]]
    fn = np.cross(p1 - p0, p2 - p0)
    fa = np.linalg.norm(fn, axis=-1)
    vn = np.zeros_like(vp)
    vw = np.zeros((vp.shape[0],), vp.dtype)
    for i in range(3):
        np.add.at(vn, faces[:, i], fn)
        np.add.at(vw, faces[:, i], fa)
    vn = vn / np.maximum(vw, 1e-20)[:, None]
    return vn / np.maximum(np.linalg.norm(vn, axis=-1, keepdims=True), 1e-20)


def build_edges(faces: np.ndarray) -> np.ndarray:
    """Edge-adjacency table (E, 5): [v0, v1, face0, face1|-1, opp_vertex0]
    with v0 < v1. Rows stand in the order in which a walk over the faces
    first meets each edge, and face0 is the adjacent face with the lower
    index: the table of the JAX package's native C++ routine, row for row
    (its numpy grouping yields the same edges in (v0, v1) order, and may
    name the two faces the other way round). Enforces 2-manifoldness: an edge
    shared by more than two faces, or twice by one face, raises."""
    f = faces.astype(np.int64)
    n_faces = f.shape[0]
    # directed half-edges, face-major (half-edge 3 f + k), each with its
    # face and opposite vertex
    a = f.reshape(-1)
    b = f[:, [1, 2, 0]].reshape(-1)
    opp = f[:, [2, 0, 1]].reshape(-1)
    face = np.repeat(np.arange(n_faces), 3)

    lo, hi = np.minimum(a, b), np.maximum(a, b)
    nv = int(f.max()) + 1 if n_faces else 0
    key = lo * nv + hi
    # stable: within an edge, the half-edge of the lower face comes first
    order = np.argsort(key, kind="stable")
    key_s, face_s = key[order], face[order]

    _, start, counts = np.unique(key_s, return_index=True,
                                 return_counts=True)
    if np.any(counts > 2):
        raise ValueError("Non-manifold mesh: edge shared by more than 2 faces")
    first = order[start]                 # each edge's first half-edge
    second = np.where(
        counts == 2, face_s[np.minimum(start + 1, key_s.shape[0] - 1)], -1)
    if np.any((counts == 2) & (face[first] == second)):
        raise ValueError("Duplicated faces sharing an edge")
    rows = np.argsort(first)             # first-met order
    first = first[rows]
    return np.stack([lo[first], hi[first], face[first], second[rows],
                     opp[first]], axis=1).astype(np.int32)


def load_obj(fname: str, **kwargs) -> Mesh:
    """OBJ parser: v / vt / vn lines and faces in the v, v/t, v//n and
    v/t/n forms, negative indices counted from the end, polygons split into
    fans. Faces come in file order, as the JAX package's loaders give them
    (the edge table's row order depends on it). ``kwargs`` go to ``Mesh``."""
    verts, uvs, nrms = [], [], []
    f_v, f_t, f_n = [], [], []
    has_uv_face = has_nrm_face = False
    with open(fname) as fh:
        for line in fh:
            if line.startswith("v "):
                parts = line.split()
                verts.append((float(parts[1]), float(parts[2]),
                              float(parts[3])))
            elif line.startswith("vt "):
                parts = line.split()
                uvs.append((float(parts[1]), float(parts[2])))
            elif line.startswith("vn "):
                parts = line.split()
                nrms.append((float(parts[1]), float(parts[2]),
                             float(parts[3])))
            elif line.startswith("f "):
                idx, tdx, ndx = [], [], []
                for p in line.split()[1:]:
                    comp = p.split("/")
                    v = int(comp[0])
                    idx.append(v - 1 if v > 0 else len(verts) + v)
                    if len(comp) > 1 and comp[1]:
                        t = int(comp[1])
                        tdx.append(t - 1 if t > 0 else len(uvs) + t)
                        has_uv_face = True
                    else:
                        tdx.append(0)
                    if len(comp) > 2 and comp[2]:
                        nn = int(comp[2])
                        ndx.append(nn - 1 if nn > 0 else len(nrms) + nn)
                        has_nrm_face = True
                    else:
                        ndx.append(-1)      # no normal on this corner
                for k in range(1, len(idx) - 1):
                    f_v.append((idx[0], idx[k], idx[k + 1]))
                    f_t.append((tdx[0], tdx[k], tdx[k + 1]))
                    f_n.append((ndx[0], ndx[k], ndx[k + 1]))
    uv = np.asarray(uvs, np.float32) if (uvs and has_uv_face) else None
    use_n = bool(nrms) and has_nrm_face
    return Mesh(np.asarray(verts, np.float32), np.asarray(f_v, np.int32),
                uv=uv, uv_idx=np.asarray(f_t, np.int32) if uv is not None
                else None,
                normals=np.asarray(nrms, np.float32) if use_n else None,
                normal_idx=np.asarray(f_n, np.int32) if use_n else None,
                **kwargs)


def sample_position(tri_info: TriangleInfo, face_distrb: Discrete,
                    inv_total_area: torch.Tensor,
                    sample2: torch.Tensor) -> PositionSample:
    """Uniform area sampling of a mesh with reparam Jacobian J."""
    idx, _, sx = discrete_sample_reuse(face_distrb, sample2[..., 0])
    st = warp.square_to_uniform_triangle(
        torch.stack([sx, sample2[..., 1]], dim=-1))
    packed = select_rows(torch.cat(
        [tri_info.p0, tri_info.e1, tri_info.e2, tri_info.face_normal,
         tri_info.face_area[:, None]], dim=1), idx)
    fa = packed[:, 12]
    p = bilinear(packed[:, 0:3], packed[:, 3:6], packed[:, 6:9], st)
    return PositionSample(
        valid=torch.ones(idx.shape, dtype=torch.bool, device=idx.device),
        pdf=inv_total_area.expand(idx.shape),
        p=p,
        n=packed[:, 9:12],
        J=fa / fa.detach(),
        emitter=torch.full(idx.shape, -1, dtype=torch.int32,
                           device=idx.device),
    )
