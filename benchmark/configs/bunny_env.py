"""``bunny_env``: the reference's rough-conductor object under an
environment map, under ``DirectIntegrator``.

``scene(cfg)`` makes the scene from ``bunny_env.json`` as host arrays
(``scenes.py`` describes them), the sky from its seed; ``build(port,
data, opts, device)`` hands them to the port through its public API."""
from __future__ import annotations

import numpy as np

import scenes
import shapes


def sun_sky(h: int, w: int, seed: int) -> np.ndarray:
    """A smooth sky, brighter toward the zenith and the horizon, a dim
    lower half, seeded variation in azimuth and a sun disk a few texels
    wide at 50 degrees from the zenith. (h, w, 3) float32, rows from the
    zenith down, columns over the azimuth."""
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
    img = (sky * (1.0 + wave))[..., None] * np.array([0.75, 0.9, 1.15])
    t0, p0 = np.deg2rad(50.0), np.deg2rad(60.0)
    cosang = (np.sin(theta) * np.sin(t0) * np.cos(phi - p0)
              + np.cos(theta) * np.cos(t0))
    sun = np.clip((cosang - np.cos(np.deg2rad(1.2))) * 4e4, 0.0, 1.0)
    img = img + sun[..., None] * np.array([900.0, 820.0, 700.0])
    return img.astype(np.float32)


def scene(cfg: dict) -> dict:
    s = cfg["scene"]
    v, f = shapes.icosphere(s["subdiv"], 1.0)
    return dict(
        bsdfs=[dict(kind="roughconductor", alpha_u=s["alpha"],
                    alpha_v=s["alpha"], eta=[0.2004, 0.9240, 1.1022],
                    k=[3.9129, 2.4528, 2.1421],
                    specular_reflectance=[1.0, 1.0, 1.0])],
        meshes=[dict(vertices=v, faces=f, bsdf=0, edges=True)],
        lights=[],
        envmap=dict(radiance=sun_sky(*s["env_size"], s["sky_seed"]),
                    scale=s["env_scale"]),
        camera=dict(fov_x=s["fov_x"], near=0.01, far=100.0,
                    to_world=shapes.look_at(s["eye"], [0, 0, 0], [0, 1, 0])),
        integrator=dict(cfg["integrator"]))


def build(port, data: dict, opts: dict, device):
    ic = data["integrator"]
    return (scenes.port_scene(port, data, opts, device),
            port.DirectIntegrator(ic["bsdf_samples"], ic["light_samples"]))
