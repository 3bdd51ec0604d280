"""Perspective pinhole camera. Counterpart of
``psdr_tpu/sensor/perspective.py`` for camera rays; the primary-edge
(silhouette) pipeline and ``sample_direct`` wait for slice 2."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import transform as xform
from ..core.math import norm, normalize
from ..core.records import Ray


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


def configure_sensor(cam: PerspectiveCamera, to_world: torch.Tensor,
                     resolution) -> SensorState:
    width, height = int(resolution[0]), int(resolution[1])
    aspect = width / height
    dev = to_world.device
    camera_to_sample = torch.as_tensor(
        xform.scale(np.array([-0.5, -0.5 * aspect, 1.0]))
        @ xform.translate(np.array([-1.0, -1.0 / aspect, 0.0]))
        @ xform.perspective(cam.fov_x, cam.near_clip, cam.far_clip),
        device=dev)
    sample_to_camera = torch.linalg.inv(camera_to_sample)
    world_to_sample = camera_to_sample @ torch.linalg.inv(to_world)
    sample_to_world = to_world @ sample_to_camera

    def pt(*v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

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
