"""Perspective pinhole camera, with the primary-edge (silhouette) pipeline.
Counterpart of ``psdr_tpu/sensor/perspective.py``: the camera matrices and
rays, the screen-space silhouette table of a sensor (``build_primary_edges``,
``finalize_primary_edges``), ``sample_direct`` and ``sample_primary_edge``.
Every ``stop_gradient`` of the JAX package is a ``.detach()`` in the same
place."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import transform as xform
from ..core.constants import EdgeEpsilon, Epsilon, ShadowEpsilon
from ..core.distribution import Discrete, discrete_init, discrete_sample_reuse
from ..core.gather import gather_rows
from ..core.hoist import const
from ..core.math import dot, norm, normalize
from ..core.records import (PrimaryEdgeSample, Ray, SensorDirectSample,
                            detach_tree)


class PerspectiveCamera:
    kind = "perspective"

    def __init__(self, fov_x: float, near: float = 1e-2, far: float = 1e4,
                 to_world=None):
        self.fov_x = float(fov_x)
        self.near_clip = float(near)
        self.far_clip = float(far)
        self.to_world = (np.eye(4, dtype=np.float32) if to_world is None
                         else np.asarray(to_world, np.float32))

    def params(self) -> dict:
        return {"to_world": self.to_world}

    def set_params(self, p: dict) -> None:
        self.to_world = p["to_world"]

    def set_transform(self, mat) -> None:
        self.to_world = np.asarray(mat, np.float32)

    def __repr__(self):
        return f"PerspectiveCamera[fov={self.fov_x}]"


class PrimaryEdgeInfo(NamedTuple):
    """Screen-space silhouette candidates. Endpoints keep their
    sample-space depth (z), so the visibility-check ray can recover the
    world-space edge point."""
    valid: torch.Tensor        # (E,) bool
    p0: torch.Tensor           # (E, 3) sample-plane coords + depth,
    p1: torch.Tensor           # (E, 3)   both differentiable
    edge_normal: torch.Tensor  # (E, 2) detached
    edge_length: torch.Tensor  # (E,) detached screen-space length
    distrb: Discrete


class SensorState(NamedTuple):
    """Runtime state of a perspective sensor."""
    resolution: tuple       # (W, H)
    to_world: torch.Tensor
    camera_to_sample: torch.Tensor
    sample_to_camera: torch.Tensor
    world_to_sample: torch.Tensor
    sample_to_world: torch.Tensor
    camera_pos: torch.Tensor   # (3,)
    camera_dir: torch.Tensor   # (3,)
    inv_area: torch.Tensor     # scalar importance normalization
    edges: PrimaryEdgeInfo | None = None


def configure_sensor(cam: PerspectiveCamera, to_world: torch.Tensor,
                     resolution) -> SensorState:
    width, height = int(resolution[0]), int(resolution[1])
    aspect = width / height
    dev = to_world.device
    camera_to_sample = const(
        xform.scale(np.array([-0.5, -0.5 * aspect, 1.0]))
        @ xform.translate(np.array([-1.0, -1.0 / aspect, 0.0]))
        @ xform.perspective(cam.fov_x, cam.near_clip, cam.far_clip),
        None, dev)
    # inv_ex: inv's singularity check would read back to the host
    sample_to_camera = torch.linalg.inv_ex(camera_to_sample).inverse
    world_to_sample = (camera_to_sample
                       @ torch.linalg.inv_ex(to_world).inverse)
    sample_to_world = to_world @ sample_to_camera

    def pt(*v):
        return const(v, torch.float32, dev)

    camera_pos = xform.transform_pos(to_world, pt(0.0, 0.0, 0.0))
    camera_dir = xform.transform_dir(to_world, pt(0.0, 0.0, 1.0))

    v00 = xform.transform_pos(sample_to_camera, pt(0.0, 0.0, 0.0))
    v10 = xform.transform_pos(sample_to_camera, pt(1.0, 0.0, 0.0))
    v11 = xform.transform_pos(sample_to_camera, pt(1.0, 1.0, 0.0))
    vc = xform.transform_pos(sample_to_camera, pt(0.5, 0.5, 0.0))
    inv_area = (1.0 / (norm(v00 - v10) * norm(v11 - v10))) * torch.sum(vc * vc)

    return SensorState(resolution=(width, height), to_world=to_world,
                       camera_to_sample=camera_to_sample,
                       sample_to_camera=sample_to_camera,
                       world_to_sample=world_to_sample,
                       sample_to_world=sample_to_world,
                       camera_pos=camera_pos, camera_dir=camera_dir,
                       inv_area=inv_area)


def build_primary_edges(state: SensorState, vertex_positions: torch.Tensor,
                        tri_info, edge_indices,
                        use_face_normals: bool) -> PrimaryEdgeInfo:
    """Silhouette filter + screen projection for one mesh's edge table (an
    array, or ``Mesh.edge_table``'s tensor).
    Returns masked (not compacted) rows; ``tri_info`` is the mesh's
    ``TriangleInfo``."""
    ei = torch.as_tensor(edge_indices, device=vertex_positions.device).long()
    has_two = ei[:, 3] >= 0
    f1 = torch.clamp(ei[:, 3], min=0)

    cam = state.camera_pos.detach()
    p0_f, fn = tri_info.p0.detach(), tri_info.face_normal.detach()
    e0 = normalize(cam - p0_f[ei[:, 2]])
    e1 = normalize(cam - p0_f[f1])
    n0, n1 = fn[ei[:, 2]], fn[f1]

    if use_face_normals:
        keep = ~(has_two
                 & (((dot(e0, n0) < Epsilon) & (dot(e1, n1) < Epsilon))
                    | (dot(n0, n1) > 1.0 - Epsilon)))
    else:
        keep = (~has_two) | ((dot(e0, n0) > Epsilon) ^ (dot(e1, n1) > Epsilon))

    # one row gather (core.gather), whose backward sums in one fixed order
    q0, q1 = xform.transform_pos(state.world_to_sample, gather_rows(
        vertex_positions, torch.cat([ei[:, 0], ei[:, 1]]))).split(
            ei.shape[0])

    e = q1.detach()[..., :2] - q0.detach()[..., :2]
    length = norm(e)
    en = e / torch.clamp(length, min=1e-20)[..., None]
    edge_normal = torch.stack([-en[..., 1], en[..., 0]], dim=-1)
    # a dummy distribution: the scene stacks the per-mesh tables, then
    # finalize_primary_edges initializes it
    return PrimaryEdgeInfo(valid=keep, p0=q0, p1=q1, edge_normal=edge_normal,
                           edge_length=length,
                           distrb=discrete_init(torch.ones(1, device=e.device)))


def finalize_primary_edges(edges: PrimaryEdgeInfo) -> PrimaryEdgeInfo:
    mass = torch.where(edges.valid, edges.edge_length, 0.0)
    return edges._replace(distrb=discrete_init(mass))


def sample_primary_ray(state: SensorState, samples: torch.Tensor) -> Ray:
    """Sample-plane coords (N, 2) in [0,1)^2 -> camera rays."""
    p = torch.cat([samples, torch.zeros(samples.shape[:-1] + (1,),
                                        dtype=samples.dtype,
                                        device=samples.device)], dim=-1)
    d = normalize(xform.transform_pos(state.sample_to_camera, p))
    o = xform.transform_pos(
        state.to_world,
        torch.zeros(3, dtype=torch.float32, device=samples.device))
    return Ray(o=o.expand(d.shape), d=xform.transform_dir(state.to_world, d))


def sample_direct(state: SensorState, p: torch.Tensor) -> SensorDirectSample:
    """Project a world point to a pixel + sensor importance; the sensor is
    read detached throughout."""
    width, height = state.resolution
    q = xform.transform_pos(state.world_to_sample.detach(), p)[..., :2]
    iq = torch.floor(q * const((width, height), q.dtype,
                               q.device)).to(torch.int32)
    valid = ((iq[..., 0] >= 0) & (iq[..., 0] < width)
             & (iq[..., 1] >= 0) & (iq[..., 1] < height))
    pixel_idx = torch.where(valid, iq[..., 1] * width + iq[..., 0], -1)

    d = p - state.camera_pos.detach()
    dist2 = torch.sum(d * d, dim=-1)
    d = d / torch.sqrt(torch.clamp(dist2, min=1e-20))[..., None]
    cos_theta = dot(state.camera_dir.detach(), d)
    sensor_val = ((1.0 / dist2) * (1.0 / cos_theta) ** 3
                  * state.inv_area.detach())
    return SensorDirectSample(valid=valid, q=q, pixel_idx=pixel_idx,
                              sensor_val=sensor_val)


def sample_primary_edge(state: SensorState,
                        sample1: torch.Tensor) -> PrimaryEdgeSample:
    """Pick a point on a screen-space silhouette edge and build the +-eps
    ray pair. ``x_dot_n`` is the only output that carries a gradient."""
    edges = state.edges
    width, height = state.resolution
    idx, pdf, s = discrete_sample_reuse(edges.distrb, sample1)
    # two packed row gathers: the endpoints, which carry the gradient, and
    # the detached columns. Lanes sorted by edge read long runs of equal
    # rows: gather_rows (a fixed-order segmented sum backward), not
    # table[idx]
    ends = gather_rows(torch.cat([edges.p0, edges.p1], dim=1), idx)
    rest = gather_rows(torch.cat(
        [edges.edge_normal, edges.edge_length[:, None],
         edges.valid.float()[:, None], edges.distrb.pmf[:, None]],
        dim=1).detach(), idx)
    pdf = pdf / torch.clamp(rest[..., 2], min=1e-20)
    ok = (rest[..., 3] > 0.5) & (rest[..., 4] > 0.0)

    en = rest[..., 0:2]
    p3 = ends[..., 0:3] * (1.0 - s)[..., None] + ends[..., 3:6] * s[..., None]
    p_ = p3[..., :2]
    p = p_.detach()
    x_dot_n = dot(p_, en)

    ip = torch.floor(p * const((width, height), p.dtype,
                               p.device)).to(torch.int32)
    onscreen = ((ip[..., 0] >= 0) & (ip[..., 0] < width)
                & (ip[..., 1] >= 0) & (ip[..., 1] < height))
    pix = torch.where(ok & onscreen, ip[..., 1] * width + ip[..., 0], -1)

    det_state = detach_tree(state)
    ray_p = sample_primary_ray(det_state, p + EdgeEpsilon * en)
    ray_n = sample_primary_ray(det_state, p - EdgeEpsilon * en)
    # visibility-check ray toward the edge point itself, bounded just short
    # of it (a conservative 100 x ShadowEpsilon)
    ray_c = sample_primary_ray(det_state, p)
    q_world = xform.transform_pos(det_state.sample_to_world, p3.detach())
    vis_dist = norm(q_world - det_state.camera_pos) - 99.0 * ShadowEpsilon
    return PrimaryEdgeSample(idx=pix, x_dot_n=x_dot_n, ray_p=ray_p,
                             ray_n=ray_n, pdf=pdf, ray_c=ray_c,
                             vis_dist=vis_dist)
