"""Mitsuba-style XML scene loader. Counterpart of
``psdr_tpu/scene/loader.py``, on the standard library's ElementTree:

* the node grammar: scene / integrator / sensor (+ sampler, film) / bsdf /
  emitter (envmap) / shape (obj, + ref, + area emitter);
* transforms: translate / rotate / scale / lookat / matrix, composed so
  that later children apply after earlier ones;
* the film and the sampler set ``RenderOptions``' width, height and spp;
* ``param_map`` keys ``Mesh[i]`` / ``BSDF[id=x]`` / ``Emitter[i]`` /
  ``Sensor[i]``, made by ``Scene.add_*``.

``load_string`` and ``load_file`` return the populated Scene on ``device``
(the card unless the caller asks for the CPU); ``load_integrator`` makes
the integrator the XML names.
"""
from __future__ import annotations

import dataclasses
import os
import xml.etree.ElementTree as ET

import numpy as np

from ..bsdf import Diffuse, RoughConductor
from ..core import transform as xf
from ..core.bitmap import constant, from_array
from ..core.exr import read_exr
from ..emitter import AreaLight, EnvironmentMap
from ..sensor import PerspectiveCamera
from ..shape.mesh import load_obj
from .scene import Scene


def _floats(text: str) -> list[float]:
    return [float(x) for x in text.replace(",", " ").split()]


def _resolve(fname: str, base_dir: str) -> str:
    """An asset path: absolute, scene-relative, cwd-relative, or relative to
    the scene file's parent directories (scene files often name assets
    relative to a working directory above them)."""
    if os.path.isabs(fname):
        return fname
    candidates = [os.path.join(base_dir, fname), fname,
                  os.path.join(base_dir, "..", fname),
                  os.path.join(base_dir, "..", "..", fname)]
    for c in candidates:
        if os.path.exists(c):
            return c
    return candidates[0]


def _named(node) -> dict:
    """The <float/integer/string/boolean/rgb/... name=... value=...>
    children of ``node``."""
    out = {}
    for child in node:
        if child.tag not in ("float", "integer", "string", "boolean", "rgb",
                             "spectrum", "vector", "point"):
            continue
        name, val = child.get("name"), child.get("value")
        if child.tag == "float":
            out[name] = float(val)
        elif child.tag == "integer":
            out[name] = int(val)
        elif child.tag == "boolean":
            out[name] = val.lower() == "true"
        elif child.tag == "string":
            out[name] = val
        else:
            v = _floats(val)
            out[name] = v * 3 if len(v) == 1 else v
    return out


def _parse_transform(node) -> np.ndarray:
    """Compose the child transforms; a later child applies after the
    earlier ones."""
    m = np.eye(4, dtype=np.float32)
    for child in node:
        tag = child.tag
        if tag == "translate":
            step = xf.translate([float(child.get(a, "0")) for a in "xyz"])
        elif tag == "scale":
            if child.get("value") is not None:
                v = _floats(child.get("value"))
                s = v * 3 if len(v) == 1 else v
            else:
                s = [float(child.get(a, "1")) for a in "xyz"]
            step = xf.scale(s)
        elif tag == "rotate":
            axis = [float(child.get(a, "0")) for a in "xyz"]
            step = xf.rotate(axis, float(child.get("angle")))
        elif tag == "lookat":
            step = xf.look_at(_floats(child.get("origin")),
                              _floats(child.get("target")),
                              _floats(child.get("up")))
        elif tag == "matrix":
            step = np.asarray(_floats(child.get("value")),
                              np.float32).reshape(4, 4)
        else:
            raise ValueError(f"Unsupported transform node <{tag}>")
        m = step @ m
    return m


def _load_texture_or_rgb(node, name, default, channels=3, base_dir="."):
    """A named parameter that is an rgb or float constant or a bitmap
    texture read from an EXR file."""
    for child in node:
        if child.get("name") != name:
            continue
        if child.tag == "texture":
            if child.get("type") != "bitmap":
                raise ValueError("only bitmap textures are supported")
            fname = _resolve(_named(child)["filename"], base_dir)
            return from_array(read_exr(fname))
        if child.tag in ("rgb", "spectrum"):
            v = _floats(child.get("value"))
            return constant(v * 3 if len(v) == 1 else v, channels)
        if child.tag == "float":
            return constant(float(child.get("value")), channels)
    return constant(default, channels)


def _load_bsdf(node, base_dir="."):
    t = node.get("type")
    bid = node.get("id", "")
    if t == "diffuse":
        return Diffuse(_load_texture_or_rgb(node, "reflectance",
                                            [0.5, 0.5, 0.5],
                                            base_dir=base_dir), bsdf_id=bid)
    if t == "roughconductor":
        props = _named(node)
        alpha = props.get("alpha", 0.1)
        alpha_u = _load_texture_or_rgb(node, "alpha_u", alpha, 1, base_dir)
        alpha_v = _load_texture_or_rgb(node, "alpha_v", alpha, 1, base_dir)
        if "alpha_u" not in props and "alpha" in props:
            alpha_u = constant(alpha, 1)
            alpha_v = constant(alpha, 1)
        return RoughConductor(
            alpha_u=alpha_u, alpha_v=alpha_v,
            eta=_load_texture_or_rgb(node, "eta", [0.2004, 0.9240, 1.1022],
                                     3, base_dir),
            k=_load_texture_or_rgb(node, "k", [3.9129, 2.4528, 2.1421], 3,
                                   base_dir),
            specular_reflectance=_load_texture_or_rgb(
                node, "specular_reflectance", [1.0, 1.0, 1.0], 3, base_dir),
            bsdf_id=bid)
    raise ValueError(f"Unsupported BSDF type '{t}'")


def _load_sensor(scene: Scene, node) -> None:
    if node.get("type") != "perspective":
        raise ValueError("only perspective sensors are supported")
    props = _named(node)
    to_world = np.eye(4, dtype=np.float32)
    for child in node:
        if child.tag == "transform":
            to_world = _parse_transform(child)
    cam = PerspectiveCamera(fov_x=float(props.get("fov", 30.0)),
                            near=float(props.get("near_clip", 1e-2)),
                            far=float(props.get("far_clip", 1e4)))
    cam.set_transform(to_world)
    scene.add_sensor(cam)

    width, height, spp = 256, 256, 1
    for child in node:
        if child.tag == "sampler":
            sp = _named(child)
            spp = int(sp.get("sample_count", sp.get("sampleCount", 1)))
        elif child.tag == "film":
            fp = _named(child)
            width = int(fp.get("width", 256))
            height = int(fp.get("height", 256))
    # replace() keeps every option the XML does not set (sppe, pass_lanes)
    scene.opts = dataclasses.replace(scene.opts, width=width, height=height,
                                     spp=spp)


def _load_shape(scene: Scene, node, bsdf_ids: dict, base_dir: str) -> None:
    if node.get("type") != "obj":
        raise ValueError("only obj shapes are supported")
    props = _named(node)
    fname = _resolve(props["filename"], base_dir)
    to_world = None
    bsdf_id = -1
    emitter_node = None
    for child in node:
        if child.tag == "transform":
            to_world = _parse_transform(child)
        elif child.tag == "ref":
            bsdf_id = bsdf_ids[child.get("id")]
        elif child.tag == "emitter":
            if child.get("type") != "area":
                raise ValueError("shapes carry area emitters only")
            emitter_node = child
    mesh = load_obj(fname,
                    use_face_normals=bool(props.get("face_normals", False)),
                    use_vertex_normals=bool(
                        props.get("use_vertex_normals", False)),
                    bsdf_id=bsdf_id, mesh_id=node.get("id", ""))
    if to_world is not None:
        mesh.set_transform(to_world)
    mesh_index = scene.add_mesh(mesh)
    if emitter_node is not None:
        scene.add_emitter(AreaLight(_named(emitter_node)["radiance"],
                                    mesh_index=mesh_index))


def load_string(xml: str, base_dir: str = ".", device="cuda") -> Scene:
    root = ET.fromstring(xml)
    if root.tag != "scene":
        raise ValueError("the root node must be <scene>")
    scene = Scene(device=device)
    scene._integrator_spec = None
    bsdf_ids: dict[str, int] = {}
    for node in root:
        tag = node.tag
        if tag == "integrator":
            scene._integrator_spec = (node.get("type"), _named(node))
        elif tag == "sensor":
            _load_sensor(scene, node)
        elif tag == "bsdf":
            b = _load_bsdf(node, base_dir)
            bsdf_ids[node.get("id", f"_{len(bsdf_ids)}")] = scene.add_bsdf(
                b, node.get("id", ""))
        elif tag == "emitter":
            if node.get("type") != "envmap":
                raise ValueError("top-level emitters must be envmaps")
            props = _named(node)
            to_world = None
            for child in node:
                if child.tag == "transform":
                    to_world = _parse_transform(child)
            scene.add_emitter(EnvironmentMap(
                read_exr(_resolve(props["filename"], base_dir)),
                scale=float(props.get("scale", 1.0)), to_world=to_world))
        elif tag == "shape":
            _load_shape(scene, node, bsdf_ids, base_dir)
    return scene


def load_file(fname: str, auto_configure: bool = True,
              device="cuda") -> Scene:
    with open(fname) as f:
        xml = f.read()
    scene = load_string(xml, base_dir=os.path.dirname(os.path.abspath(fname)),
                        device=device)
    if auto_configure:
        scene.configure()
    return scene


def load_integrator(scene: Scene):
    """The integrator the scene's XML names (default: direct)."""
    from ..integrator import (DirectIntegrator, FieldExtractionIntegrator,
                              PathTracer)
    spec = getattr(scene, "_integrator_spec", None)
    if spec is None:
        return DirectIntegrator(1, 1)
    kind, props = spec
    if kind == "direct":
        return DirectIntegrator(int(props.get("bsdf_samples", 1)),
                                int(props.get("emitter_samples",
                                              props.get("light_samples", 1))))
    if kind in ("path", "pathtracer"):
        return PathTracer(max_depth=int(props.get("max_depth", 3)),
                          hide_emitters=bool(props.get("hide_emitters",
                                                       False)))
    if kind == "field":
        return FieldExtractionIntegrator(props.get("field", "silhouette"))
    raise ValueError(f"Unsupported integrator '{kind}'")
