"""The benchmark's own geometry: the meshes, transforms and camera frames
that a configuration's scene is made of, as host arrays. The port and the
reference are both handed these same arrays, so neither builds the scene
that the other is judged on."""
from __future__ import annotations

import numpy as np


def translate(t) -> np.ndarray:
    m = np.eye(4)
    m[:3, 3] = t
    return m


def rotate(axis, deg: float) -> np.ndarray:
    """Rotation by ``deg`` degrees about ``axis``, right-handed
    (Rodrigues' formula)."""
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    th = np.deg2rad(deg)
    k = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    m = np.eye(4)
    m[:3, :3] = np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * (k @ k)
    return m


def apply(m: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Points ``v`` (n, 3) under the affine transform ``m``."""
    return v @ m[:3, :3].T + m[:3, 3]


def look_at(eye, target, up) -> np.ndarray:
    """Camera to world: columns left, up, forward and the eye."""
    eye = np.asarray(eye, np.float64)
    f = np.asarray(target, np.float64) - eye
    f /= np.linalg.norm(f)
    left = np.cross(np.asarray(up, np.float64), f)
    left /= np.linalg.norm(left)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = left, np.cross(f, left), f, eye
    return m


def quad(size: float):
    """A square of half-width ``size`` in the z = 0 plane, facing +z:
    (vertices, faces)."""
    s = size
    v = np.array([[-s, -s, 0], [s, -s, 0], [s, s, 0], [-s, s, 0]], np.float64)
    return v, np.array([[0, 1, 2], [0, 2, 3]], np.int64)


def icosphere(subdiv: int, radius: float):
    """A sphere of ``20 * 4**subdiv`` faces, facing outward: an icosahedron
    whose faces are split in four ``subdiv`` times, each new vertex pushed
    onto the sphere. (vertices, faces)."""
    p = (1.0 + 5.0 ** 0.5) / 2.0
    v = [(-1, p, 0), (1, p, 0), (-1, -p, 0), (1, -p, 0), (0, -1, p),
         (0, 1, p), (0, -1, -p), (0, 1, -p), (p, 0, -1), (p, 0, 1),
         (-p, 0, -1), (-p, 0, 1)]
    verts = [np.asarray(x, np.float64) / np.linalg.norm(x) for x in v]
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
             (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
             (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
             (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    for _ in range(subdiv):
        mid = {}

        def middle(a, b):
            k = (min(a, b), max(a, b))
            if k not in mid:
                m = verts[a] + verts[b]
                verts.append(m / np.linalg.norm(m))
                mid[k] = len(verts) - 1
            return mid[k]

        nxt = []
        for a, b, c in faces:
            ab, bc, ca = middle(a, b), middle(b, c), middle(c, a)
            nxt += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = nxt
    return np.stack(verts) * radius, np.asarray(faces, np.int64)

