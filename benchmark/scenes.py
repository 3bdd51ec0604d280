"""A configuration's scene as host arrays, and its hand-over to the port.

The description (``configs/<config>.py`` ``scene(cfg)``) is a dict:

* ``bsdfs``: ``{"kind": "diffuse", "reflectance": [r, g, b]}``, one-sided
  Lambertian reflection on the front of a face, or ``{"kind":
  "roughconductor", "alpha_u", "alpha_v", "eta": [..], "k": [..],
  "specular_reflectance": [..]}``, a GGX microfacet conductor;
* ``meshes``: ``{"vertices": (V, 3), "faces": (F, 3), "bsdf": index,
  "edges": bool}`` in world space, each face's front given by its winding
  (the normal of (v1 - v0) x (v2 - v0)), shaded with that face normal;
  ``edges`` keeps the mesh's edge table in the port (off where no boundary
  term needs it);
* ``lights``: ``{"mesh": index, "radiance": [r, g, b]}``, emitting from the
  front of each face of the mesh;
* ``envmap`` (optional): ``{"radiance": (H, W, 3), "scale"}``, light from
  every direction that leaves the scene, in latitude-longitude order
  (``reference.Envmap`` states the mapping);
* ``camera``: ``{"fov_x": degrees across, "near", "far", "to_world": 4x4}``
  (columns left, up, forward, eye); film x runs to the right, y down;
* ``integrator``: what the configuration runs.

The port gets these arrays through its public API; the reference
(``reference.py``, or the configuration's own under ``references/``)
reads the same arrays.

A gradient cell moves one mesh (``translated``): its target image is the
reference's image of the scene with the mesh moved by the workload's
offset, and its finite differences move the mesh by +-eps along each
axis. The port's gradient with respect to that mesh's vertices, summed
over the vertices, is the gradient of the same translation: each
vertex moves with it."""
from __future__ import annotations

import numpy as np


def port_scene(port, data: dict, opts: dict, device):
    sc = port.Scene(device=device)
    for b in data["bsdfs"]:
        if b["kind"] == "diffuse":
            sc.add_bsdf(port.Diffuse(list(b["reflectance"])))
        elif b["kind"] == "roughconductor":
            sc.add_bsdf(port.RoughConductor(
                alpha_u=b["alpha_u"], alpha_v=b["alpha_v"],
                eta=tuple(b["eta"]), k=tuple(b["k"]),
                specular_reflectance=tuple(b["specular_reflectance"])))
        else:
            raise NotImplementedError(b["kind"])
    ids = [sc.add_mesh(port.Mesh(np.asarray(m["vertices"], np.float32),
                                 np.asarray(m["faces"], np.int32),
                                 use_face_normals=True,
                                 enable_edges=bool(m["edges"]),
                                 bsdf_id=int(m["bsdf"])))
           for m in data["meshes"]]
    for li in data["lights"]:
        sc.add_emitter(port.AreaLight(list(li["radiance"]),
                                      mesh_index=ids[li["mesh"]]))
    if data.get("envmap"):
        sc.add_emitter(port.EnvironmentMap(data["envmap"]["radiance"],
                                           scale=data["envmap"]["scale"]))
    c = data["camera"]
    cam = port.PerspectiveCamera(fov_x=c["fov_x"], near=c["near"],
                                 far=c["far"])
    cam.set_transform(np.asarray(c["to_world"], np.float32))
    sc.add_sensor(cam)
    sc.opts = port.RenderOptions(**opts)
    return sc


def translated(data: dict, mesh: int, offset) -> dict:
    """``data`` with the vertices of mesh ``mesh`` moved by ``offset``;
    every other array is shared with ``data``."""
    meshes = list(data["meshes"])
    m = dict(meshes[mesh])
    m["vertices"] = (np.asarray(m["vertices"], np.float64)
                     + np.asarray(offset, np.float64))
    meshes[mesh] = m
    return dict(data, meshes=meshes)
