"""Homogeneous 4x4 transforms (column-vector convention: p' = M @ [p, 1]).

Counterpart of ``psdr_tpu/core/transform.py``. The builders are host numpy;
``transform_pos``/``transform_dir`` apply a matrix to points or directions
of shape (..., 3), and ``inverse`` inverts one, on numpy arrays and torch
tensors alike.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def translate(v) -> np.ndarray:
    out = np.eye(4, dtype=np.float32)
    out[:3, 3] = np.asarray(v, np.float32)
    return out


def scale(v) -> np.ndarray:
    v = np.asarray(v, np.float32)
    return np.diag(np.concatenate([v, np.ones(1, np.float32)]))


def rotate(axis, angle_deg) -> np.ndarray:
    """Rotation about an arbitrary axis; angle in degrees."""
    axis = np.asarray(axis, np.float32)
    axis = axis / np.maximum(np.sqrt(np.sum(axis * axis)), 1e-20)
    theta = np.deg2rad(np.asarray(angle_deg, np.float32))
    s, c = np.sin(theta), np.cos(theta)
    x, y, z = axis[0], axis[1], axis[2]
    C = 1.0 - c
    return np.array([
        [x * x * C + c,     x * y * C - z * s, x * z * C + y * s, 0.0],
        [y * x * C + z * s, y * y * C + c,     y * z * C - x * s, 0.0],
        [z * x * C - y * s, z * y * C + x * s, z * z * C + c,     0.0],
        [0.0, 0.0, 0.0, 1.0],
    ], dtype=np.float32)


def perspective(fov_deg: float, near: float, far: float) -> np.ndarray:
    """Maps [near, far] on +z to [0, 1]; fov mapped to [-1, 1]."""
    recip = 1.0 / (far - near)
    cot = 1.0 / math.tan(math.radians(fov_deg * 0.5))
    m = np.diag(np.array([cot, cot, far * recip, 0.0], np.float32))
    m[2, 3] = -near * far * recip
    m[3, 2] = 1.0
    return m


def look_at(origin, target, up) -> np.ndarray:
    """Camera-to-world: columns = [left, new_up, dir, origin]."""
    origin = np.asarray(origin, np.float32)
    target = np.asarray(target, np.float32)
    up = np.asarray(up, np.float32)

    def unit(v):
        return v / np.maximum(np.sqrt(np.sum(v * v)), 1e-20)

    dir_ = unit(target - origin)
    left = unit(np.cross(up, dir_))
    new_up = np.cross(dir_, left)
    mat = np.stack([left, new_up, dir_, origin], axis=-1)  # (3, 4)
    bottom = np.array([[0.0, 0.0, 0.0, 1.0]], np.float32)
    return np.concatenate([mat, bottom], axis=0)


def transform_pos(mat, p):
    """Apply M to points p (..., 3) with perspective divide."""
    tmp = p @ mat[:3, :3].T + mat[:3, 3]
    w = p @ mat[3, :3] + mat[3, 3]
    return tmp / w[..., None]


def transform_dir(mat, d):
    """Apply M's linear part to directions d (..., 3) (no divide)."""
    return d @ mat[:3, :3].T


def inverse(mat):
    if isinstance(mat, torch.Tensor):
        return torch.linalg.inv_ex(mat).inverse
    return np.linalg.inv(mat)
