"""Procedural meshes (quads, icospheres), host numpy. Counterpart of
``psdr_tpu/shape/primitives.py`` as far as ``testing/scenes.py`` needs it."""
from __future__ import annotations

import numpy as np

from .mesh import Mesh


def make_quad(size: float = 1.0, z: float = 0.0, flip: bool = False, **kwargs) -> Mesh:
    """Unit quad in the XY plane, facing +z (or -z when flipped)."""
    s = size
    vertices = np.array([[-s, -s, z], [s, -s, z], [s, s, z], [-s, s, z]], np.float32)
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    if flip:
        faces = faces[:, ::-1].copy()
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    return Mesh(vertices, faces, uv=uv, uv_idx=faces.copy(), **kwargs)


def make_icosphere(subdiv: int = 2, radius: float = 1.0, **kwargs) -> Mesh:
    """Icosphere by repeated midpoint subdivision of an icosahedron."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int64)

    for _ in range(subdiv):
        cache: dict = {}
        vlist = list(verts)

        def midpoint(a: int, b: int) -> int:
            key = (min(a, b), max(a, b))
            if key in cache:
                return cache[key]
            m = vlist[a] + vlist[b]
            m = m / np.linalg.norm(m)
            vlist.append(m)
            cache[key] = len(vlist) - 1
            return cache[key]

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(vlist)
        faces = np.asarray(new_faces, np.int64)

    return Mesh((verts * radius).astype(np.float32), faces.astype(np.int32), **kwargs)
