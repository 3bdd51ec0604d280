"""Procedural test scenes, jax-free copies of the JAX package's test
scenes.

``cbox_scene`` and ``sphere_light_scene`` build the same host geometry,
materials, light and camera as ``tests/scenes.py`` (numpy throughout, so
both packages get identical inputs); ``floor_light_scene`` is
``tests/test_gradients.py::_floor_light_scene``, a floor under a light
outside the view, whose image is smooth in the light's position;
``gi_shadow_scene`` and ``hidden_shadow_scene`` are the validation scenes
of the indirect and the camera-side boundary estimators; ``env_scene``
(an icosphere under the gradient sky of ``tests/test_envmap.py``) and
``textured_quad_scene`` (``tests/test_texture.py``) are the small scenes of
the materials and lights, and ``env_bench_scene`` their full-width scene: a
rough-conductor sphere, a textured ground, a sphere with authored normals,
an area light and a 512 x 1024 environment map. At
``occluder_subdiv=5`` ``cbox_scene`` is the scene ``bench.py`` measures:
20,492 triangles. ``triangle_soup`` is the random soup of
``tests/test_bvh.py`` that the intersection tests share;
``coincident_case`` puts two coincident triangles into different leaves
(the tie rule's case); ``scene_rays``, ``tiled_camera_rays`` and
``tiled_path_rays`` make the rays the render path sends through a built
scene: camera rays, the bounce and shadow rays from their hits, and a path
tracer's later bounces; ``tiled_material_rays`` makes the BSDF-sampled
bounce rays and the shadow rays toward environment-map samples.
``write_scene`` writes a scene as XML, OBJ and EXR files for the loader;
``flagship_deform`` is ``examples/flagship_recovery.py``'s deformation of
the occluder.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import (AreaLight, Diffuse, EnvironmentMap, PerspectiveCamera,
                RenderOptions, RoughConductor, Scene)
from ..bsdf import sample_bsdf
from ..core.bitmap import from_array
from ..accel.bvh import build_bvh_topology
from ..core import transform as xf
from ..core.constants import ShadowEpsilon
from ..core.frame import to_world
from ..core.records import Ray
from ..core.warp import square_to_cosine_hemisphere
from ..integrator.base import tiled_pixel_order
from ..integrator.direct import _emitter_meta
from ..scene.scene import ray_intersect, sample_emitter_position
from ..sensor.perspective import sample_primary_ray
from ..shape import primitives
from ..shape.mesh import _host


def cbox_scene(width=48, height=48, spp=4, sppe=0, sppse=0,
               occluder_subdiv=1, device="cuda") -> Scene:
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
                       subdiv=1, vertex_offset=False,
                       device="cuda") -> Scene:
    """Diffuse sphere on the z-axis lit by an overhead area light; with
    ``vertex_offset`` the sphere carries the 1D vertex offset leaf."""
    sc = Scene(device=device)
    white = sc.add_bsdf(Diffuse([0.8, 0.8, 0.8]), "white")
    grey = sc.add_bsdf(Diffuse([0.5, 0.5, 0.5]), "grey")
    sc.add_mesh(primitives.make_icosphere(
        subdiv=subdiv, radius=1.0, bsdf_id=white,
        enable_vertex_offset=vertex_offset))
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


def floor_light_scene(width=16, height=16, spp=16, device="cuda") -> Scene:
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


def gi_shadow_scene(width=24, height=24, spp=32, sppe=2, sppse=32,
                    device="cuda") -> Scene:
    """``tests/test_indirect_boundary.py::_gi_shadow_scene``: an area light
    facing UP lights a white ceiling panel, and the camera sees a floor lit
    only by the ceiling's reflection. A blocker quad between the two casts
    a shadow whose motion neither the interior nor the direct boundary
    estimator captures: the far side of the blocker's silhouette segments
    is the bright, non-emissive ceiling. Sliding the blocker (mesh 3) in
    its plane has no interior derivative at all."""
    sc = Scene(device=device)
    white = sc.add_bsdf(Diffuse([0.9, 0.9, 0.9]), "white")
    grey = sc.add_bsdf(Diffuse([0.6, 0.6, 0.6]), "grey")
    black = sc.add_bsdf(Diffuse([0.0, 0.0, 0.0]), "black")

    def quad(size, bsdf, transform, edges=False):
        q = primitives.make_quad(size=size, bsdf_id=bsdf, enable_edges=edges,
                                 use_face_normals=True)
        q.set_transform(np.asarray(transform))
        return sc.add_mesh(q)

    quad(3.0, grey, xf.rotate([1, 0, 0], -90.0))           # floor, +y normal
    quad(3.0, white,
         xf.translate([0, 2.0, 0]) @ xf.rotate([1, 0, 0], 90.0))  # ceiling
    # a small light above the floor facing up: it lights the ceiling only
    li = quad(0.3, black,
              xf.translate([1.2, 0.4, 1.2]) @ xf.rotate([1, 0, 0], -90.0))
    sc.add_emitter(AreaLight([60.0, 60.0, 60.0], mesh_index=li))
    # the blocker, horizontal, with edges
    quad(0.5, grey, xf.translate([0, 0.35, 0]) @ xf.rotate([1, 0, 0], -90.0),
         edges=True)

    cam = PerspectiveCamera(fov_x=45.0)
    cam.set_transform(np.asarray(
        xf.look_at([0, 1.4, 2.8], [0, 0.0, 0], [0, 1, 0])))
    sc.add_sensor(cam)
    sc.opts = RenderOptions(width=width, height=height, spp=spp, sppe=sppe,
                            sppse=sppse)
    return sc


def hidden_shadow_scene(width=20, height=20, spp=32, sppse=48,
                        device="cuda") -> Scene:
    """``tests/test_camera_indirect_boundary.py::_hidden_shadow_scene``: a
    light above a floor, a blocker (mesh 2) casting a direct shadow on it,
    and a camera that sees only a white panel facing the floor, so the
    shadow reaches the image through one diffuse bounce off the panel: the
    case of a sensor subpath of length 2 (``PathTracer(camera_depth=2)``)."""
    sc = Scene(device=device)
    white = sc.add_bsdf(Diffuse([0.9, 0.9, 0.9]), "white")
    grey = sc.add_bsdf(Diffuse([0.8, 0.8, 0.8]), "grey")
    black = sc.add_bsdf(Diffuse([0.0, 0.0, 0.0]), "black")

    def quad(size, bsdf, transform, edges=False):
        q = primitives.make_quad(size=size, bsdf_id=bsdf, enable_edges=edges,
                                 use_face_normals=True)
        q.set_transform(np.asarray(transform))
        return sc.add_mesh(q)

    quad(2.0, grey, xf.rotate([1, 0, 0], -90.0))    # floor: shadow receiver
    li = quad(0.6, black,
              xf.translate([0.0, 2.2, 0.0]) @ xf.rotate([1, 0, 0], 90.0))
    sc.add_emitter(AreaLight([40.0, 40.0, 40.0], mesh_index=li))
    quad(0.7, grey,
         xf.translate([0.0, 0.3, 0.0]) @ xf.rotate([1, 0, 0], -90.0),
         edges=True)                                # the moving silhouette
    # a vertical panel facing the camera: the downward light grazes it, so
    # its radiance is the floor's bounce; it fills the whole frustum
    quad(1.6, white, xf.translate([0.0, 1.0, -1.8]))

    cam = PerspectiveCamera(fov_x=25.0)
    cam.set_transform(np.asarray(
        xf.look_at([0.0, 1.0, 1.2], [0.0, 1.0, -1.8], [0, 1, 0])))
    sc.add_sensor(cam)
    sc.opts = RenderOptions(width=width, height=height, spp=spp, sppe=0,
                            sppse=sppse)
    return sc


def gradient_sky(h=16, w=32) -> np.ndarray:
    """``tests/test_envmap.py::_gradient_sky``: a bright band near the
    horizon on +x, dark elsewhere; azimuthally non-uniform, so a rotation
    has a visible derivative. (h, w, 3) float32."""
    theta = np.linspace(0, np.pi, h, dtype=np.float32)[:, None]
    phi = np.linspace(0, 2 * np.pi, w, endpoint=False,
                      dtype=np.float32)[None, :]
    val = (np.exp(-((theta - 1.3) ** 2) * 8.0)
           * (1.0 + 0.9 * np.cos(phi))) + 0.05
    return np.repeat(val.astype(np.float32)[..., None], 3, axis=-1)


def env_scene(bsdf=None, width=24, height=24, spp=8, sppe=0, sppse=0,
              sky=None, device="cuda") -> Scene:
    """``tests/test_envmap.py::_env_scene``: a subdiv-2 icosphere of
    material ``bsdf`` (default ``Diffuse([0.7, 0.7, 0.7])``) under the
    16 x 32 gradient sky (or the image ``sky``), no other light."""
    sc = Scene(device=device)
    b = sc.add_bsdf(Diffuse([0.7, 0.7, 0.7]) if bsdf is None else bsdf, "mat")
    sc.add_mesh(primitives.make_icosphere(subdiv=2, radius=1.0, bsdf_id=b))
    sc.add_emitter(EnvironmentMap(gradient_sky() if sky is None else sky,
                                  scale=1.0))
    cam = PerspectiveCamera(fov_x=40.0)
    cam.set_transform(np.asarray(xf.look_at([0, 0, 5], [0, 0, 0], [0, 1, 0])))
    sc.add_sensor(cam)
    sc.opts = RenderOptions(width=width, height=height, spp=spp, sppe=sppe,
                            sppse=sppse)
    return sc


def textured_quad_scene(tex, width=32, height=32, spp=8,
                        device="cuda") -> Scene:
    """``tests/test_texture.py::_textured_quad_scene``: a quad whose
    reflectance is the image ``tex`` (H, W, 3), under an area light."""
    sc = Scene(device=device)
    mat = sc.add_bsdf(Diffuse(from_array(tex)), "tex")
    sc.add_mesh(primitives.make_quad(size=1.0, bsdf_id=mat,
                                     enable_edges=False,
                                     use_face_normals=True))
    light = primitives.make_quad(size=0.5, bsdf_id=-1, enable_edges=False,
                                 use_face_normals=True)
    light.set_transform(np.asarray(
        xf.translate([0, 0, 3.0]) @ xf.rotate([1, 0, 0], 180.0)))
    li = sc.add_mesh(light)
    sc.add_emitter(AreaLight([12.0, 12.0, 12.0], mesh_index=li))
    cam = PerspectiveCamera(fov_x=45.0)
    cam.set_transform(np.asarray(xf.look_at([0, 0, 2.5], [0, 0, 0],
                                            [0, 1, 0])))
    sc.add_sensor(cam)
    sc.opts = RenderOptions(width=width, height=height, spp=spp)
    return sc


def sun_sky(h=512, w=1024, seed=7) -> np.ndarray:
    """A smooth sky (bright toward the zenith and the horizon haze, a dim
    ground half, low-frequency seeded variation in azimuth) with a sun disk
    a few texels wide at 40 degrees of elevation. (h, w, 3) float32."""
    rng = np.random.default_rng(seed)
    theta = (np.arange(h, dtype=np.float64)[:, None] + 0.5) * (np.pi / h)
    phi = (np.arange(w, dtype=np.float64)[None, :] + 0.5) * (2 * np.pi / w)
    up = np.cos(theta)
    sky = np.where(up > 0, 0.25 + 0.5 * up + 0.3 * np.exp(-8.0 * up),
                   0.08 + 0.05 * np.exp(8.0 * up))
    amp = rng.uniform(0.02, 0.08, 4)
    phase = rng.uniform(0, 2 * np.pi, 4)
    wave = sum(a * np.cos((k + 1) * phi + p)
               for k, (a, p) in enumerate(zip(amp, phase)))
    base = sky * (1.0 + wave)
    tint = np.array([0.75, 0.9, 1.15])
    img = base[..., None] * tint
    # the sun: a disk of ~1.2 degrees radius (about 3.5 texels)
    t0, p0 = np.deg2rad(50.0), np.deg2rad(60.0)
    cosang = (np.sin(theta) * np.sin(t0) * np.cos(phi - p0)
              + np.cos(theta) * np.cos(t0))
    sun = np.clip((cosang - np.cos(np.deg2rad(1.2))) * 4e4, 0.0, 1.0)
    img = img + sun[..., None] * np.array([900.0, 820.0, 700.0])
    return img.astype(np.float32)


def checker_texture(n=256, seed=11) -> np.ndarray:
    """A 16 x 16 checker whose two colours drift with seeded low-frequency
    noise. (n, n, 3) float32 in (0, 1)."""
    rng = np.random.default_rng(seed)
    y, x = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    check = ((x // (n // 16)) + (y // (n // 16))) % 2
    coarse = rng.uniform(0.0, 1.0, (9, 9, 3))
    fy, fx = y / (n - 1) * 8, x / (n - 1) * 8
    iy, ix = np.minimum(fy.astype(int), 7), np.minimum(fx.astype(int), 7)
    ty, tx = (fy - iy)[..., None], (fx - ix)[..., None]
    noise = ((1 - ty) * ((1 - tx) * coarse[iy, ix] + tx * coarse[iy, ix + 1])
             + ty * ((1 - tx) * coarse[iy + 1, ix]
                     + tx * coarse[iy + 1, ix + 1]))
    tex = np.where(check[..., None] == 1, 0.55 + 0.35 * noise,
                   0.15 + 0.2 * noise)
    return tex.astype(np.float32)


def env_bench_scene(width=512, height=512, spp=64, sppe=0, sppse=0,
                    sphere_subdiv=5, small_subdiv=3, env_size=(512, 1024),
                    tex_size=256, device="cuda") -> Scene:
    """The full-width scene of the materials and lights: a 20,480-face
    icosphere (radius 1) of ``RoughConductor(alpha_u=0.2, alpha_v=0.3)``; a
    6 x 6 ground quad at y = -1 whose reflectance is a 256 x 256 image; a
    1,280-face icosphere (radius 0.4) beside it, diffuse, with authored
    vertex normals (the normalized positions); one area-light quad above;
    and a 512 x 1024 environment map (``sun_sky``), whose importance table
    is the frozen cmf on the divided 511 x 255 grid. 21,776 faces with the
    bounding mesh; the emitter-first sweep sees 2 + 12 faces. The size
    arguments shrink it for CPU rehearsals."""
    sc = Scene(device=device)
    metal = sc.add_bsdf(RoughConductor(alpha_u=0.2, alpha_v=0.3), "metal")
    ground = sc.add_bsdf(Diffuse(from_array(checker_texture(tex_size))),
                         "ground")
    clay = sc.add_bsdf(Diffuse([0.75, 0.55, 0.4]), "clay")
    black = sc.add_bsdf(Diffuse([0.0, 0.0, 0.0]), "black")

    sc.add_mesh(primitives.make_icosphere(subdiv=sphere_subdiv, radius=1.0,
                                          bsdf_id=metal))
    floor = primitives.make_quad(size=3.0, bsdf_id=ground,
                                 enable_edges=False, use_face_normals=True)
    floor.set_transform(np.asarray(
        xf.translate([0.0, -1.0, 0.0]) @ xf.rotate([1, 0, 0], -90.0)))
    sc.add_mesh(floor)

    ball = primitives.make_icosphere(subdiv=small_subdiv, radius=0.4)
    nrm = ball.vertices / np.linalg.norm(ball.vertices, axis=1, keepdims=True)
    small = type(ball)(ball.vertices, ball.faces, normals=nrm,
                       normal_idx=ball.faces.copy(), use_vertex_normals=True,
                       bsdf_id=clay)
    small.set_transform(np.asarray(xf.translate([1.6, -0.6, 0.6])))
    sc.add_mesh(small)

    light = primitives.make_quad(size=0.35, bsdf_id=black, enable_edges=False,
                                 use_face_normals=True)
    light.set_transform(np.asarray(
        xf.translate([0.0, 3.0, 0.0]) @ xf.rotate([1, 0, 0], 90.0)))
    li = sc.add_mesh(light)
    sc.add_emitter(AreaLight([4.0, 4.0, 4.0], mesh_index=li))
    sc.add_emitter(EnvironmentMap(sun_sky(*env_size), scale=1.0))

    cam = PerspectiveCamera(fov_x=40.0, near=0.1, far=100.0)
    cam.set_transform(np.asarray(xf.look_at([0, 1.5, 6.0], [0, 0, 0],
                                            [0, 1, 0])))
    sc.add_sensor(cam)
    sc.opts = RenderOptions(width=width, height=height, spp=spp, sppe=sppe,
                            sppse=sppse)
    return sc


def flagship_deform(v: np.ndarray) -> np.ndarray:
    """``examples/flagship_recovery.py``'s deformation of the occluder's
    raw vertices: a smooth bump about (0.25, 0, 0.1) plus a rigid shift."""
    v = np.asarray(v, np.float32)
    c = np.array([0.25, 0.0, 0.1], np.float32)
    r2 = np.sum((v - c) ** 2, axis=1, keepdims=True)
    bump = 0.12 * np.exp(-r2 / 0.05) * (v - c) / np.sqrt(
        np.maximum(r2, 1e-8))
    return (v + bump + np.array([0.06, -0.04, 0.03], np.float32)).astype(
        np.float32)


def _fmt(v) -> str:
    return ", ".join("%.9g" % float(x) for x in np.ravel(v))


def write_scene(scene: Scene, directory: str, name: str = "scene.xml",
                integrator: str = "") -> str:
    """Write ``scene`` as files the loader reads back: one OBJ per mesh
    (``Mesh.dump``), one float EXR per image texture and for an
    environment map (``core.exr.write_exr``, lossless), and the XML, whose
    numbers carry nine significant digits. Diffuse and rough-conductor
    BSDFs, area lights, an environment map, the first perspective sensor
    and the film and sampler of ``scene.opts``; ``integrator`` is an
    optional ``<integrator>`` element. The XML has no switch for a mesh's
    edges: the loaded meshes all carry them. Returns the XML's path."""
    import os

    from ..core.exr import write_exr

    lines = ['<scene version="0.5.0">']
    if integrator:
        lines.append(integrator)

    def matrix(m):
        return f'<transform name="to_world"><matrix value="{_fmt(m)}"/>' \
               '</transform>'

    def param(tag_name, data, fname):
        data = _host(data)
        if data.shape[:2] != (1, 1):
            write_exr(os.path.join(directory, fname), data)
            return (f'<texture name="{tag_name}" type="bitmap"><string '
                    f'name="filename" value="{fname}"/></texture>')
        if data.shape[-1] == 1:
            return f'<float name="{tag_name}" value="{_fmt(data)}"/>'
        return f'<rgb name="{tag_name}" value="{_fmt(data)}"/>'

    cam = scene.sensors[0]
    o = scene.opts
    lines.append(
        f'<sensor type="perspective"><float name="fov" value="{cam.fov_x!r}"/>'
        f'<float name="near_clip" value="{cam.near_clip!r}"/>'
        f'<float name="far_clip" value="{cam.far_clip!r}"/>'
        + matrix(_host(cam.to_world))
        + f'<sampler type="independent"><integer name="sample_count" '
        f'value="{o.spp}"/></sampler><film type="hdrfilm"><integer '
        f'name="width" value="{o.width}"/><integer name="height" '
        f'value="{o.height}"/></film></sensor>')
    ids = []
    for i, b in enumerate(scene.bsdfs):
        bid = b.id or f"bsdf{i}"
        ids.append(bid)
        fields = b.params()
        lines.append(f'<bsdf type="{b.kind}" id="{bid}">' + "".join(
            param(k, v, f"{bid}_{k}.exr") for k, v in fields.items())
            + '</bsdf>')
    for i, em in enumerate(scene.emitters):
        if isinstance(em, EnvironmentMap):
            fname = f"envmap{i}.exr"
            write_exr(os.path.join(directory, fname), _host(em.radiance.data))
            lines.append(
                f'<emitter type="envmap"><string name="filename" '
                f'value="{fname}"/><float name="scale" '
                f'value="{_fmt(_host(em.scale))}"/>'
                + matrix(_host(em.to_world)) + '</emitter>')
    for i, m in enumerate(scene.meshes):
        fname = f"mesh{i}.obj"
        m.dump(os.path.join(directory, fname))
        world = m.to_world_left @ _host(m.to_world) @ m.to_world_right
        body = [f'<string name="filename" value="{fname}"/>', matrix(world)]
        if m.use_face_normals:
            body.append('<boolean name="face_normals" value="true"/>')
        if m.bsdf_id >= 0:
            body.append(f'<ref id="{ids[m.bsdf_id]}"/>')
        if m.emitter_id >= 0:
            rad = _host(scene.emitters[m.emitter_id].radiance)
            body.append(f'<emitter type="area"><rgb name="radiance" '
                        f'value="{_fmt(rad)}"/></emitter>')
        lines.append('<shape type="obj">' + "".join(body) + '</shape>')
    lines.append('</scene>')
    path = os.path.join(directory, name)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


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


def coincident_case(swap: bool = False, n_rays: int = 512):
    """64 triangles in 16 leaves of 4: small random ones, and the same
    large triangle twice, as ids 10 and 50, in the plane z = 0. The
    topology's permutation is set by hand: slot = id, or with ``swap`` ids
    10 and 50 trade slots, so the copy in the lower slot (leaf 2) has the
    higher id. Rays come from both sides of the plane, even ones from above. Returns numpy
    (topology, p0, e1, e2, ray_o, ray_d, active, tmax) and the id that
    must win every tie."""
    rng = np.random.default_rng(5)
    p0 = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
    e1 = rng.uniform(-0.3, 0.3, (64, 3)).astype(np.float32)
    e2 = rng.uniform(-0.3, 0.3, (64, 3)).astype(np.float32)
    # the first four leaves lie above the plane and the last four below, so
    # a ray from below meets the copy in the higher slot first, and enters
    # the lower copy's subtree at the very t of its best hit
    e1[:, 2] *= 0.8
    e2[:, 2] *= 0.8
    p0[:16, 2] = rng.uniform(0.3, 0.7, 16)
    p0[48:, 2] = -rng.uniform(0.3, 0.7, 16)
    for i in (10, 50):
        p0[i], e1[i], e2[i] = (-0.8, -0.8, 0.0), (1.6, 0, 0), (0, 1.6, 0)
    perm = np.arange(64, dtype=np.int32)
    if swap:
        perm[[10, 50]] = perm[[50, 10]]
    topo = build_bvh_topology(p0, e1, e2, leaf_size=4)._replace(perm=perm)
    xy = rng.uniform(-0.75, 0.6, (n_rays, 2)).astype(np.float32)
    side = np.where(np.arange(n_rays) % 2 == 0, 1.0, -1.0).astype(np.float32)
    o = np.concatenate([xy, 2.0 * side[:, None]], axis=-1)
    d = rng.normal(scale=0.05, size=(n_rays, 3)).astype(np.float32)
    d[:, 2] = -side
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (topo, p0, e1, e2, o, d, np.ones(n_rays, bool),
            np.full(n_rays, np.inf, np.float32)), int(perm[10])


def grazing_case(edge=0.05, dist=(20.0, 100.0), sine=(1e-4, 1e-2),
                 n_tris=2048, n_rays=1500, seed=3):
    """A triangle soup under badly conditioned rays: each ray aims at a
    point inside some triangle, at an angle to its plane whose sine is
    drawn log-uniformly from ``sine``, from an origin ``dist`` away, where
    the triangles' edges are up to ``edge`` long. Numpy (p0, e1, e2, ray_o,
    ray_d, active, tmax), every ray active with no tmax."""
    rng = np.random.default_rng(seed)
    p0 = rng.uniform(-1, 1, (n_tris, 3)).astype(np.float32)
    e1 = rng.uniform(-edge, edge, (n_tris, 3)).astype(np.float32)
    e2 = rng.uniform(-edge, edge, (n_tris, 3)).astype(np.float32)
    i = rng.integers(0, n_tris, n_rays)
    uv = rng.uniform(0.1, 0.4, (n_rays, 2))
    p = p0[i] + uv[:, :1] * e1[i] + uv[:, 1:] * e2[i]
    n = np.cross(e1[i], e2[i])
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    t1 = e1[i] / np.linalg.norm(e1[i], axis=-1, keepdims=True)
    t2 = np.cross(n, t1)
    a = rng.uniform(0, 2 * np.pi, (n_rays, 1))
    s = np.exp(rng.uniform(*np.log(sine), (n_rays, 1)))
    d = np.cos(a) * t1 + np.sin(a) * t2 + s * n
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = p - d * rng.uniform(*dist, (n_rays, 1))
    return (p0, e1, e2, o.astype(np.float32), d.astype(np.float32),
            np.ones(n_rays, bool), np.full(n_rays, np.inf, np.float32))


def scene_rays(scene, flat, n, seed):
    """The three sweeps of the render path on a built scene ``flat``, n
    rays each, from a numpy seed: camera rays through uniformly random
    pixels, cosine-bounce rays from their hits and light-sample shadow
    rays. Each is (Ray, active, tmax or None)."""
    dev = flat.tri.p0.device
    u = torch.as_tensor(np.random.default_rng(seed).uniform(size=(n, 6))
                        .astype(np.float32), device=dev)
    return _sweeps(scene, flat, sample_primary_ray(flat.sensors[0], u[:, 0:2]),
                   u[:, 2:4], u[:, 4:6])


def tiled_camera_rays(scene, flat, n, spp, seed, chunk=0):
    """The sweeps of n lanes of the render path's wavefront, its
    ``chunk``-th run of n (default: the first): n / spp pixels in
    32x32-tile order, spp uniformly jittered samples each (numpy seed), as
    ``render_interior`` lays them out, and the bounce and shadow rays from
    their hits. As ``scene_rays``."""
    dev = flat.tri.p0.device
    w, h = scene.opts.width, scene.opts.height
    first = chunk * (n // spp)
    pix = np.repeat(tiled_pixel_order(w, h)[first:first + n // spp], spp)
    u = np.random.default_rng(seed).uniform(size=(n, 6))
    xy = (np.stack([pix % w, pix // w], axis=-1) + u[:, 0:2]) / [w, h]
    u = torch.as_tensor(u.astype(np.float32), device=dev)
    cam = sample_primary_ray(flat.sensors[0],
                             torch.as_tensor(xy.astype(np.float32),
                                             device=dev))
    return _sweeps(scene, flat, cam, u[:, 2:4], u[:, 4:6])


def tiled_path_rays(scene, flat, n, spp, seed, depth=3):
    """The sweeps of a path tracer's later bounces over the first n lanes of
    the render path's wavefront (``tiled_camera_rays``'s pixels): for each
    depth k = 2..depth the cosine-bounce rays and the light-sample shadow
    rays that leave the hits of depth k - 1's bounce rays, which are no
    longer coherent within a pixel. A lane lives on while its bounce ray
    hits a surface with a BSDF. ``{"depth k bounce" | "depth k shadow":
    (Ray, active, tmax or None)}``."""
    dev = flat.tri.p0.device
    w, h = scene.opts.width, scene.opts.height
    pix = np.repeat(tiled_pixel_order(w, h)[:n // spp], spp)
    u = np.random.default_rng(seed).uniform(size=(n, 2 + 4 * depth))
    xy = (np.stack([pix % w, pix // w], axis=-1) + u[:, 0:2]) / [w, h]
    u = torch.as_tensor(u.astype(np.float32), device=dev)
    ray = sample_primary_ray(flat.sensors[0],
                             torch.as_tensor(xy.astype(np.float32),
                                             device=dev))
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    out = {}
    for k in range(1, depth + 1):
        its = ray_intersect(flat, ray, alive)
        alive = its.valid & (its.bsdf_id >= 0)
        bounce, shadow = _vertex_sweeps(scene, flat, its, alive,
                                        u[:, 4 * k - 2:4 * k],
                                        u[:, 4 * k:4 * k + 2])
        if k > 1:
            out[f"depth {k} bounce"], out[f"depth {k} shadow"] = bounce, shadow
        ray = bounce[0]
    return out


def tiled_material_rays(scene, flat, n, spp, seed, chunk=0):
    """Two sweeps that the materials and the environment map add, over the
    ``chunk``-th run of n lanes of the render path's wavefront
    (``tiled_camera_rays``'s pixels): ``"bounce"``, the BSDF-sampled
    continuation rays that leave the camera hits (closest hit; on a rough
    conductor they cluster about the mirror direction), and ``"sky
    shadow"``, the shadow rays toward the light samples that fell on the
    environment map, whose ``tmax`` reaches the scene box. ``{name: (Ray, active, tmax or None)}``."""
    dev = flat.tri.p0.device
    w, h = scene.opts.width, scene.opts.height
    first = chunk * (n // spp)
    pix = np.repeat(tiled_pixel_order(w, h)[first:first + n // spp], spp)
    u = np.random.default_rng(seed).uniform(size=(n, 7))
    xy = (np.stack([pix % w, pix // w], axis=-1) + u[:, 0:2]) / [w, h]
    u = torch.as_tensor(u.astype(np.float32), device=dev)
    cam = sample_primary_ray(flat.sensors[0],
                             torch.as_tensor(xy.astype(np.float32),
                                             device=dev))
    its = ray_intersect(flat, cam, torch.ones((n,), dtype=torch.bool,
                                              device=dev))
    alive = its.valid & (its.bsdf_id >= 0)
    bs = sample_bsdf(scene.bsdf_kinds, flat.bsdfs, its, u[:, 2:5], alive)
    bounce = Ray(its.p, to_world(its.sh_frame, bs.wo))
    ps = sample_emitter_position(flat, scene.face_offset,
                                 _emitter_meta(scene), its.p, u[:, 5:7],
                                 alive)
    wo = ps.p - its.p
    dist = torch.sqrt(torch.clamp((wo * wo).sum(-1), min=1e-20))
    shadow = Ray(its.p, wo / dist[:, None])
    return {"bounce": (bounce, alive & bs.valid, None),
            "sky shadow": (shadow, alive & ps.valid & (ps.emitter < 0),
                           dist - ShadowEpsilon)}


def _sweeps(scene, flat, cam, u_bounce, u_light):
    active = torch.ones((cam.o.shape[0],), dtype=torch.bool,
                        device=cam.o.device)
    its = ray_intersect(flat, cam, active)
    return ((cam, active, None),
            *_vertex_sweeps(scene, flat, its, its.valid, u_bounce, u_light))


def _vertex_sweeps(scene, flat, its, alive, u_bounce, u_light):
    """The cosine-bounce and the light-sample shadow sweep that leave the
    hits ``its`` on the lanes ``alive``: two (Ray, active, tmax or None)."""
    bounce = Ray(its.p, to_world(its.sh_frame,
                                 square_to_cosine_hemisphere(u_bounce)))
    ps = sample_emitter_position(flat, scene.face_offset,
                                 _emitter_meta(scene), its.p, u_light, alive)
    wo = ps.p - its.p
    dist = torch.sqrt(torch.clamp((wo * wo).sum(-1), min=1e-20))
    shadow = Ray(its.p, wo / dist[:, None])
    return (bounce, alive, None), (shadow, alive, dist - ShadowEpsilon)
