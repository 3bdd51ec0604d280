"""The check that decides ``correct``: one image of the window, at pixels
drawn from the seed, against the plain reference's estimate of the same
pixels (``reference.py``: its own generator, camera, intersector and
estimator, at more samples a pixel than the image has).

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
computed in bfloat16 at the image's own samples a pixel."""
from __future__ import annotations

import numpy as np
import torch

import harness
import reference


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
