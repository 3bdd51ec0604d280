"""The checks that decide ``correct``, each against the plain reference of
the cell's configuration (``Bench.reference``: ``references/<config>.py``
where the configuration brings one, else ``reference.py``: its own
generator, camera, intersector and estimator). A job kind's ``judge``
calls its check here.

**Forward cells** (``judge``, ``numbers``): one image of the window, at
pixels drawn from the seed, against the reference's estimate of the same
pixels at more samples a pixel than the image has.

The pixels: the film cut into the workload's ``regions`` (columns, rows),
``pixels_per_region`` drawn from each without repeats, less those whose
footprint, widened by half a pixel, shows a light
(``reference.sees_emitter``): a light's edge puts a step of tens of
times the image's mean into such a pixel, and its noise would drown the
rest of the sums. Which pixels are left out follows from the scene's
geometry alone, not from either side's samples. Compared numbers,
each with a limit in the workload file (sums over the drawn pixels):

* ``bias_all``: |sum(I - R)| / sum(R) over every pixel and channel, the
  bias of the whole image;
* ``bias_region``: the largest over regions and channels of
  |sum(I - R)| / sum(R), a bias of one part of the image or one colour;
* ``noise``: the median over pixels of |I - R|^2 / |R|^2 (over the
  channels; 0 where both are black), the Monte Carlo error of both sides
  together, which grows where the image holds fewer samples than its spp
  says. The median, and not the mean, so that a few pixels of a
  highlight's or a shadow's edge do not decide it.

The control (``control=True``) is the reference in the program's place,
computed in bfloat16 at the image's own samples a pixel.

**Gradient cells** (``grad_target``, ``fd_gradient``, ``grad_numbers``):
the mean over the window's steps of the program's gradient with respect
to a translation of one mesh (the workload's ``grad.mesh``) along each of
``grad.axes``, against central finite differences of the reference's
loss mean((R - T)^2) over the whole film: R the reference's image with
the mesh moved by +eps and by -eps along the axis (``scenes.translated``),
both from one generator seed (common random numbers), at ``check.fd_spp``
samples a pixel; T the target, the reference's image of the scene with
the mesh moved by ``grad.target_offset`` at ``grad.target_spp``. Neither
depends on the run's seed, so both are made once per checkout and kept
under ``bench_runs/``, keyed by a hash of the files they are made from
(``cached``). Compared: ``grad_err``, |g - g_fd| / |g_fd| over the axes.
The control is the program without its boundary terms (the interior
derivative alone, what plain autodiff of the renderer gives), which
misses the visibility term that a translation moves."""
from __future__ import annotations

import hashlib
import os
from pathlib import Path

import numpy as np
import torch

import harness
import scenes

BENCH = Path(__file__).resolve().parent


def pixels(wl: dict, seed: int):
    """(pixel ids, region of each) drawn from ``seed``."""
    w, h = wl["film"]
    cols, rows = wl["check"]["regions"]
    k = wl["check"]["pixels_per_region"]
    rng = np.random.default_rng([seed, 1])
    ids, region = [], []
    for ry in range(rows):
        for rx in range(cols):
            x0, x1 = rx * w // cols, (rx + 1) * w // cols
            y0, y1 = ry * h // rows, (ry + 1) * h // rows
            pick = rng.choice((x1 - x0) * (y1 - y0), size=k, replace=False)
            ids.append((y0 + pick // (x1 - x0)) * w + x0 + pick % (x1 - x0))
            region.append(np.full(k, ry * cols + rx))
    return np.concatenate(ids), np.concatenate(region)


def reference_pixels(bench, cell: str, seed: int, device,
                     control: bool = False):
    """(pixel ids, regions, the reference's estimate of them); under
    ``control`` the bfloat16 reference at the image's samples a pixel,
    on a generator of its own."""
    wl = bench.workload(cell)
    reference = bench.reference(bench.cell(cell)["config"])
    data = harness.scene_data(bench, cell)
    ids, region = pixels(wl, seed)
    keep = ~reference.sees_emitter(data, wl["film"], ids, device)
    ids, region = ids[keep], region[keep]
    spp = (wl["spp"] * wl["passes"] if control else wl["check"]["spp"])
    gen_seed = int(np.random.default_rng([seed, 3 if control else 2])
                   .integers(0, 1 << 62))
    est = reference.render(data, wl["film"], ids, spp, gen_seed, device,
                           torch.bfloat16 if control else torch.float32)
    return ids, region, est


def judge(bench, cell: str, seed: int, img, device):
    """The arguments of ``numbers`` for the program's image ``img`` (one
    row a pixel) of a run on ``seed``."""
    ids, region, ref = reference_pixels(bench, cell, seed, device)
    mine = np.asarray(img, np.float64).reshape(-1, 3)[ids]
    return mine, ref, region


def numbers(mine, ref, region) -> dict:
    diff = mine - ref
    out = {"bias_all": abs(diff.sum()) / ref.sum()}
    worst = 0.0
    for r in np.unique(region):
        sel = region == r
        worst = max(worst, float(np.max(np.abs(diff[sel].sum(0))
                                        / ref[sel].sum(0))))
    out["bias_region"] = worst
    num, den = (diff ** 2).sum(1), (ref ** 2).sum(1)
    rel = np.where(den > 0, num / np.where(den > 0, den, 1.0),
                   np.where(num > 0, np.inf, 0.0))
    out["noise"] = float(np.median(rel))
    return {k: float(v) for k, v in out.items()}


def within(nums: dict, limits: dict) -> bool:
    return all(np.isfinite(v) and v <= limits[k] for k, v in nums.items())


# -- gradient cells -----------------------------------------------------------

def cached(bench, cell: str, what: str, device, make) -> np.ndarray:
    """``make()``'s array, kept in ``bench_runs/<cell>.<what>.<hash>.npy``
    of the checkout: the hash is of the device's kind and of every file
    that the array can be made from (the reference, the scene's
    description, this file, the configurations and the workload), so that
    a change to any of them makes it anew."""
    config = bench.cell(cell)["config"]
    h = hashlib.sha256(torch.device(device).type.encode())
    for path in (Path(bench.reference(config).__file__),
                 BENCH / "scenes.py", BENCH / "shapes.py", Path(__file__),
                 *sorted(p for p in (bench.dir / "configs").iterdir()
                         if p.is_file()),
                 bench.dir / "workloads" / f"{cell}.json"):
        h.update(path.name.encode() + path.read_bytes())
    path = (bench.root / "bench_runs"
            / f"{cell}.{what}.{h.hexdigest()[:16]}.npy")
    if path.is_file():
        return np.load(path)
    value = np.asarray(make())
    path.parent.mkdir(exist_ok=True)
    part = path.with_name(path.name + ".part")
    with open(part, "wb") as f:
        np.save(f, value)
    os.replace(part, path)
    return value


def _film(wl: dict):
    w, h = wl["film"]
    return wl["film"], np.arange(w * h)


def grad_target(bench, cell: str, device) -> np.ndarray:
    """(pixels, 3) float32, the target image T: the reference's image of
    the scene with mesh ``grad.mesh`` moved by ``grad.target_offset``."""
    wl = bench.workload(cell)
    g = wl["grad"]

    def make():
        ref = bench.reference(bench.cell(cell)["config"])
        data = scenes.translated(harness.scene_data(bench, cell), g["mesh"],
                                 g["target_offset"])
        film, ids = _film(wl)
        return ref.render(data, film, ids, g["target_spp"], g["target_seed"],
                          device).astype(np.float32)
    return cached(bench, cell, "target", device, make)


def fd_gradient(bench, cell: str, device, seed=None) -> np.ndarray:
    """(axes,) central differences of the reference's loss along each of
    ``grad.axes``, at ``check.eps`` and ``check.fd_spp``, both sides from
    the generator seed ``seed`` (the workload's ``check.fd_seed`` where
    None, and then kept per checkout)."""
    wl = bench.workload(cell)
    g, c = wl["grad"], wl["check"]

    def make():
        ref = bench.reference(bench.cell(cell)["config"])
        data = harness.scene_data(bench, cell)
        target = grad_target(bench, cell, device).astype(np.float64)
        film, ids = _film(wl)

        def loss(offset):
            img = ref.render(scenes.translated(data, g["mesh"], offset),
                             film, ids, c["fd_spp"],
                             c["fd_seed"] if seed is None else seed, device)
            return float(((img - target) ** 2).mean())
        out = []
        for axis in np.asarray(g["axes"], np.float64):
            step = c["eps"] * axis
            out.append((loss(step) - loss(-step)) / (2 * c["eps"]))
        return np.asarray(out)
    if seed is not None:
        return make()
    return cached(bench, cell, "fd", device, make)


def grad_numbers(mean_grad, g_fd) -> dict:
    """``grad_err``: the distance of the program's mean gradient from the
    finite differences, over their length."""
    mean_grad, g_fd = (np.asarray(x, np.float64) for x in (mean_grad, g_fd))
    return {"grad_err": float(np.linalg.norm(mean_grad - g_fd)
                              / np.linalg.norm(g_fd))}
