"""Triangle meshes: host-side topology and the world-space geometry build.
Counterpart of ``psdr_tpu/shape/mesh.py``. The edge-adjacency table, OBJ
loading, authored vertex normals and the 1D vertex offset wait for later
slices (boundary terms: slice 2; IO: slice 4)."""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core import transform as xform
from ..core import warp
from ..core.distribution import Discrete, discrete_sample_reuse
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


def compute_triangle_info(vertex_positions: torch.Tensor,
                          faces: torch.Tensor, num_vertices: int):
    """Per-face SoA + area-weighted vertex normals."""
    faces = faces.long()
    p0 = vertex_positions[faces[:, 0]]
    p1 = vertex_positions[faces[:, 1]]
    p2 = vertex_positions[faces[:, 2]]
    e1 = p1 - p0
    e2 = p2 - p0

    fn = cross(e1, e2)
    fa = norm(fn)

    vn = torch.zeros((num_vertices, 3), dtype=vertex_positions.dtype,
                     device=vertex_positions.device)
    vw = torch.zeros((num_vertices,), dtype=vertex_positions.dtype,
                     device=vertex_positions.device)
    for i in range(3):
        vn = vn.index_add(0, faces[:, i], fn)
        vw = vw.index_add(0, faces[:, i], fa)
    vn = normalize(vn / torch.clamp(vw, min=1e-20)[:, None])

    info = TriangleInfo(
        p0=p0, e1=e1, e2=e2,
        n0=vn[faces[:, 0]], n1=vn[faces[:, 1]], n2=vn[faces[:, 2]],
        face_normal=fn / torch.clamp(fa, min=1e-20)[:, None],
        face_area=fa * 0.5,
    )
    return info, vn


class Mesh:
    """Host-side mesh: static topology + parameter leaves
    (``vertex_positions``: raw object-space positions (V, 3); ``to_world``:
    4x4 object-to-world matrix)."""

    def __init__(self, vertices: np.ndarray, faces: np.ndarray,
                 uv: Optional[np.ndarray] = None,
                 uv_idx: Optional[np.ndarray] = None,
                 use_face_normals: bool = False,
                 enable_edges: bool = True,
                 enable_vertex_offset: bool = False,
                 use_vertex_normals: bool = False,
                 bsdf_id: int = -1, emitter_id: int = -1,
                 mesh_id: str = ""):
        if enable_vertex_offset:
            raise NotImplementedError("the 1D vertex offset waits for slice 5")
        if use_vertex_normals:
            raise NotImplementedError("authored vertex normals wait for "
                                      "slice 4")
        self.vertices = np.ascontiguousarray(vertices, np.float32)
        self.faces = np.ascontiguousarray(faces, np.int32)
        self.uv = None if uv is None else np.ascontiguousarray(uv, np.float32)
        self.uv_idx = (None if uv_idx is None
                       else np.ascontiguousarray(uv_idx, np.int32))
        self.use_face_normals = bool(use_face_normals)
        # silhouette edges feed the boundary terms only (slice 2)
        self.enable_edges = bool(enable_edges)
        self.bsdf_id = int(bsdf_id)
        self.emitter_id = int(emitter_id)
        self.id = mesh_id
        self.num_vertices = int(self.vertices.shape[0])
        self.num_faces = int(self.faces.shape[0])
        self.vertex_positions = self.vertices
        self.to_world = np.eye(4, dtype=np.float32)

    def params(self) -> dict:
        return {"vertex_positions": self.vertex_positions,
                "to_world": self.to_world}

    def set_params(self, p: dict) -> None:
        self.vertex_positions = p["vertex_positions"]
        self.to_world = p["to_world"]

    def set_transform(self, mat) -> None:
        self.to_world = np.asarray(mat, np.float32)

    def world_positions(self, params: dict) -> torch.Tensor:
        return xform.transform_pos(params["to_world"],
                                   params["vertex_positions"])

    def __repr__(self):
        return (f"Mesh[nv={self.num_vertices}, nf={self.num_faces}"
                + (f", id={self.id}" if self.id else "") + "]")


def sample_position(tri_info: TriangleInfo, face_distrb: Discrete,
                    inv_total_area: torch.Tensor,
                    sample2: torch.Tensor) -> PositionSample:
    """Uniform area sampling of a mesh with reparam Jacobian J."""
    idx, _, sx = discrete_sample_reuse(face_distrb, sample2[..., 0])
    st = warp.square_to_uniform_triangle(
        torch.stack([sx, sample2[..., 1]], dim=-1))
    packed = torch.cat(
        [tri_info.p0, tri_info.e1, tri_info.e2, tri_info.face_normal,
         tri_info.face_area[:, None]], dim=1)[idx.long()]
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
