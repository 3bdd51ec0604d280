"""Procedural test scenes, jax-free copies of the JAX package's test
scenes.

``cbox_scene`` and ``sphere_light_scene`` build the same host geometry,
materials, light and camera as ``tests/scenes.py`` (numpy throughout, so
both packages get identical inputs); ``floor_light_scene`` is
``tests/test_gradients.py::_floor_light_scene``, a floor under a light
outside the view, whose image is smooth in the light's position. At
``occluder_subdiv=5`` ``cbox_scene`` is the scene ``bench.py`` measures:
20,492 triangles. ``triangle_soup`` is the random soup of
``tests/test_bvh.py`` that the intersection tests share.
"""
from __future__ import annotations

import numpy as np

from .. import (AreaLight, Diffuse, PerspectiveCamera, RenderOptions,
                Scene)
from ..core import transform as xf
from ..shape import primitives


def cbox_scene(width=48, height=48, spp=4, sppe=0, sppse=0,
               occluder_subdiv=1, device="cpu") -> Scene:
    """Cornell-box-style: 5 walls, overhead area light, floating sphere
    occluder."""
    sc = Scene(device=device)
    white = sc.add_bsdf(Diffuse([0.95, 0.95, 0.95]), "white")
    red = sc.add_bsdf(Diffuse([0.9, 0.2, 0.2]), "red")
    green = sc.add_bsdf(Diffuse([0.2, 0.9, 0.2]), "green")
    black = sc.add_bsdf(Diffuse([0.0, 0.0, 0.0]), "absorption_only")

    def wall(translate, rotate_axis, rotate_deg, bsdf):
        q = primitives.make_quad(size=1.0, bsdf_id=bsdf, enable_edges=False,
                                 use_face_normals=True)
        m = xf.translate(translate)
        if rotate_deg:
            m = m @ xf.rotate(rotate_axis, rotate_deg)
        q.set_transform(np.asarray(m))
        sc.add_mesh(q)

    wall([0, -1, 0], [1, 0, 0], -90.0, white)   # floor (+y normal)
    wall([0, 1, 0], [1, 0, 0], 90.0, white)     # ceiling
    wall([0, 0, -1], [0, 0, 0], 0.0, white)     # back (+z normal)
    wall([-1, 0, 0], [0, 1, 0], 90.0, red)      # left
    wall([1, 0, 0], [0, 1, 0], -90.0, green)    # right

    sphere = primitives.make_icosphere(subdiv=occluder_subdiv, radius=0.35,
                                       bsdf_id=white)
    sphere.set_transform(np.asarray(xf.translate([0.0, -0.2, 0.0])))
    sc.add_mesh(sphere)

    light = primitives.make_quad(size=0.25, bsdf_id=black,
                                 enable_edges=False, use_face_normals=True)
    light.set_transform(np.asarray(
        xf.translate([0.0, 0.98, 0.0]) @ xf.rotate([1, 0, 0], 90.0)))
    light_idx = sc.add_mesh(light)
    sc.add_emitter(AreaLight([20.0, 20.0, 8.0], mesh_index=light_idx))

    cam = PerspectiveCamera(fov_x=39.0, near=0.01, far=100.0)
    cam.set_transform(np.asarray(xf.look_at([0, 0, 3.6], [0, 0, 0], [0, 1, 0])))
    sc.add_sensor(cam)

    sc.opts = RenderOptions(width=width, height=height, spp=spp, sppe=sppe,
                            sppse=sppse)
    return sc


def sphere_light_scene(width=32, height=32, spp=4, sppe=0, sppse=0,
                       subdiv=1, device="cpu") -> Scene:
    """Diffuse sphere on the z-axis lit by an overhead area light."""
    sc = Scene(device=device)
    white = sc.add_bsdf(Diffuse([0.8, 0.8, 0.8]), "white")
    grey = sc.add_bsdf(Diffuse([0.5, 0.5, 0.5]), "grey")
    sc.add_mesh(primitives.make_icosphere(subdiv=subdiv, radius=1.0,
                                          bsdf_id=white))
    floor = primitives.make_quad(size=8.0, bsdf_id=grey, enable_edges=False,
                                 use_face_normals=True)
    floor.set_transform(np.asarray(
        xf.translate([0.0, -1.0, 0.0]) @ xf.rotate([1, 0, 0], -90.0)))
    sc.add_mesh(floor)
    light = primitives.make_quad(size=1.0, bsdf_id=-1, enable_edges=False,
                                 use_face_normals=True)
    light.set_transform(np.asarray(
        xf.translate([0.0, 4.0, 0.0]) @ xf.rotate([1, 0, 0], 90.0)))
    light_idx = sc.add_mesh(light)
    sc.add_emitter(AreaLight([10.0, 10.0, 10.0], mesh_index=light_idx))
    cam = PerspectiveCamera(fov_x=40.0, near=0.1, far=100.0)
    cam.set_transform(np.asarray(xf.look_at([0, 1.5, 6.0], [0, 0, 0],
                                            [0, 1, 0])))
    sc.add_sensor(cam)
    sc.opts = RenderOptions(width=width, height=height, spp=spp, sppe=sppe,
                            sppse=sppse)
    return sc


def floor_light_scene(width=16, height=16, spp=16, device="cpu") -> Scene:
    """Floor + overhead light, nothing occluding and the light outside the
    camera frustum: the image is a smooth function of a light translation,
    so the interior gradient is the whole gradient."""
    sc = Scene(device=device)
    grey = sc.add_bsdf(Diffuse([0.6, 0.6, 0.6]), "grey")
    floor = primitives.make_quad(size=4.0, bsdf_id=grey, enable_edges=False,
                                 use_face_normals=True)
    floor.set_transform(np.asarray(xf.rotate([1, 0, 0], -90.0)))
    sc.add_mesh(floor)
    light = primitives.make_quad(size=1.0, bsdf_id=-1, enable_edges=False,
                                 use_face_normals=True)
    light.set_transform(np.asarray(
        xf.translate([0.0, 3.0, 0.0]) @ xf.rotate([1, 0, 0], 90.0)))
    li = sc.add_mesh(light)
    sc.add_emitter(AreaLight([8.0, 8.0, 8.0], mesh_index=li))
    cam = PerspectiveCamera(fov_x=35.0, near=0.1, far=100.0)
    cam.set_transform(np.asarray(xf.look_at([0, 2.0, 0.0], [0, 0, 0],
                                            [0, 0, 1])))
    sc.add_sensor(cam)
    sc.opts = RenderOptions(width=width, height=height, spp=spp)
    return sc


def triangle_soup(n_tris=2048, n_rays=600):
    """Random triangles and rays (``tests/test_bvh.py:192-197``) with mixed
    ``active`` and ``tmax``: numpy (p0, e1, e2, ray_o, ray_d, active,
    tmax)."""
    rng = np.random.default_rng(9)
    p0 = rng.uniform(-1, 1, (n_tris, 3)).astype(np.float32)
    e1 = rng.uniform(-0.3, 0.3, (n_tris, 3)).astype(np.float32)
    e2 = rng.uniform(-0.3, 0.3, (n_tris, 3)).astype(np.float32)
    rng = np.random.default_rng(10)
    o = rng.uniform(-2, 2, (n_rays, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rng = np.random.default_rng(11)
    act = rng.uniform(size=n_rays) > 0.1
    tmax = np.where(rng.uniform(size=n_rays) > 0.5, np.inf,
                    rng.uniform(0.5, 6, n_rays)).astype(np.float32)
    return p0, e1, e2, o, d, act, tmax
