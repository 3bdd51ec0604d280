"""``cbox_direct``: the reference's Cornell box under ``DirectIntegrator``.

``scene(cfg)`` makes the scene from ``cbox_direct.json`` as host arrays
(``scenes.py`` describes them); ``build(port, data, opts, device)`` hands
them to the port through its public API."""
from __future__ import annotations

import numpy as np

import scenes
import shapes

WHITE, RED, GREEN, BLACK = range(4)


def scene(cfg: dict) -> dict:
    s = cfg["scene"]
    meshes = []
    for t, axis, deg, bsdf in (([0, -1, 0], [1, 0, 0], -90.0, WHITE),
                               ([0, 1, 0], [1, 0, 0], 90.0, WHITE),
                               ([0, 0, -1], [1, 0, 0], 0.0, WHITE),
                               ([-1, 0, 0], [0, 1, 0], 90.0, RED),
                               ([1, 0, 0], [0, 1, 0], -90.0, GREEN)):
        v, f = shapes.quad(1.0)
        m = shapes.translate(t) @ shapes.rotate(axis, deg)
        meshes.append(dict(vertices=shapes.apply(m, v), faces=f, bsdf=bsdf,
                           edges=False))
    v, f = shapes.icosphere(s["occluder_subdiv"], s["occluder_radius"])
    meshes.append(dict(vertices=v + np.asarray(s["occluder_center"]),
                       faces=f, bsdf=WHITE, edges=True))
    v, f = shapes.quad(s["light_size"])
    m = shapes.translate(s["light_center"]) @ shapes.rotate([1, 0, 0], 90.0)
    meshes.append(dict(vertices=shapes.apply(m, v), faces=f, bsdf=BLACK,
                       edges=False))
    return dict(
        bsdfs=[dict(kind="diffuse", reflectance=r) for r in
               ([0.95, 0.95, 0.95], [0.9, 0.2, 0.2], [0.2, 0.9, 0.2],
                [0.0, 0.0, 0.0])],
        meshes=meshes,
        lights=[dict(mesh=len(meshes) - 1, radiance=s["light_radiance"])],
        camera=dict(fov_x=s["fov_x"], near=0.01, far=100.0,
                    to_world=shapes.look_at(s["eye"], [0, 0, 0], [0, 1, 0])),
        integrator=dict(cfg["integrator"]))


def build(port, data: dict, opts: dict, device):
    ic = data["integrator"]
    return (scenes.port_scene(port, data, opts, device),
            port.DirectIntegrator(ic["bsdf_samples"], ic["light_samples"]))
