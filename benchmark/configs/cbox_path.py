"""``cbox_path``: the reference's Cornell box under the port's
``PathTracer``, paths to ``max_depth`` + 1 segments.

``scene(cfg)`` is ``cbox_direct``'s scene (the same walls, light, sphere
and camera, from the same keys of the configuration);
``build(port, data, opts, device)`` hands it to the port with
``PathTracer(max_depth)``: no boundary terms, ``camera_depth`` 1, the
lights seen directly."""
from __future__ import annotations

from pathlib import Path

import harness
import scenes

_direct = harness.load_module(Path(__file__).with_name("cbox_direct.py"),
                              "bench_config_cbox_direct")


def scene(cfg: dict) -> dict:
    return _direct.scene(cfg)


def build(port, data: dict, opts: dict, device):
    ic = data["integrator"]
    return (scenes.port_scene(port, data, opts, device),
            port.PathTracer(max_depth=ic["max_depth"], camera_depth=1,
                            hide_emitters=False))
