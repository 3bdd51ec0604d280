"""Integrator base: wavefront generation and image accumulation.

Counterpart of ``psdr_tpu/integrator/base.py`` for the interior term of a
detached forward render. One lane per (pixel, sample); lanes are
pixel-major along a 32x32 tile traversal and run in pixel-aligned chunks of
``RenderOptions.pass_lanes``, each with its own key from ``split``. The
boundary estimators, the camera-hit prior, lane sharding and differentiable
renders wait for later slices and raise ``NotImplementedError``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import threefry
from ..core.math import scrub_nonfinite
from ..core.sampler import RngStream, ld_2d
from ..scene.scene import FlatScene, Scene, detach_flat
from ..sensor.perspective import sample_primary_ray

_M32 = 0xFFFFFFFF


def tiled_pixel_order(width: int, height: int, tile: int = 32) -> np.ndarray:
    """Pixel ids in tile-major traversal order, so adjacent lanes form
    tight ray frusta."""
    yy, xx = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    order = np.lexsort((xx.ravel() % tile, yy.ravel() % tile,
                        xx.ravel() // tile, yy.ravel() // tile))
    return (yy.ravel() * width + xx.ravel())[order].astype(np.int32)


def tile_pos_to_pixel(pos: torch.Tensor, width: int, height: int,
                      tile: int = 32):
    """Closed-form inverse of ``tiled_pixel_order`` when the film tiles
    evenly; None otherwise (callers read the order table)."""
    if width % tile or height % tile:
        return None
    tiles_x = width // tile
    within = pos % (tile * tile)
    t = pos // (tile * tile)
    y = (t // tiles_x) * tile + within // tile
    x = (t % tiles_x) * tile + within % tile
    return y * width + x


def _pix_hash(idx: torch.Tensor, word: int) -> torch.Tensor:
    """Per-pixel 32-bit hash of (pixel id, word), as the JAX package's
    scramble words (uint32 in int64)."""
    h = (idx & _M32) ^ word
    h = ((h ^ (h >> 16)) * 0x45D9F3B) & _M32
    h = ((h ^ (h >> 16)) * 0x45D9F3B) & _M32
    return h ^ (h >> 16)


class Integrator:
    """Base class; subclasses implement ``Li(scene, flat, rng, ray,
    active)``."""

    def Li(self, scene: Scene, flat: FlatScene, rng: RngStream, ray, active,
           prior=None) -> torch.Tensor:
        raise NotImplementedError

    # -- interior -------------------------------------------------------------
    def render_interior(self, scene: Scene, flat: FlatScene, sensor_id: int,
                        key: torch.Tensor, shard=None) -> torch.Tensor:
        if shard is not None:
            raise NotImplementedError("lane sharding waits for slice 5")
        opts = scene.opts
        if opts.camera_hit_prior:
            raise NotImplementedError("the camera-hit prior waits for slice 2")
        num_pixels = opts.num_pixels
        spp = opts.spp
        dev = scene.device
        if spp == 0:
            return torch.zeros((num_pixels, 3), device=dev)
        n = num_pixels * spp
        chunk = min(opts.pass_lanes, n)
        if chunk % spp:
            raise NotImplementedError(
                "render_interior runs pixel-aligned chunks only: pass_lanes "
                "must be a multiple of spp")
        pix_order_np = tiled_pixel_order(opts.width, opts.height)
        pix_order = torch.as_tensor(pix_order_np, device=dev).long()
        if opts.sampler not in ("sobol", "independent"):
            raise NotImplementedError(
                f"sampler={opts.sampler!r} is not ported yet")
        use_sobol = opts.sampler == "sobol" and spp > 1
        film = torch.tensor([opts.width, opts.height], dtype=torch.float32,
                            device=dev)

        def lane_values(lane, key_c):
            pos = torch.clamp(lane // spp, max=num_pixels - 1)
            idx = tile_pos_to_pixel(pos, opts.width, opts.height)
            if idx is None:
                idx = pix_order[pos]
            base = torch.stack([(idx % opts.width).float(),
                                (idx // opts.width).float()], dim=-1)
            rng = RngStream(key_c, salt=0, device=dev)
            # pixel-aligned chunks: each pixel's spp lanes are adjacent
            rng.vis_spp = spp
            m = lane.shape[0]
            if use_sobol:
                # the JAX package draws a uniform jitter here and replaces
                # it; only its counter slot matters
                rng._subkey()
                # XOR-scrambled (0,2)-sequence for the subpixel jitter and
                # the first NEE/BSDF samples, one scramble pair each per pixel
                w = threefry.randint(rng._subkey(), (6,), 0,
                                     np.iinfo(np.int32).max).tolist()
                s_idx = lane % spp
                jitter = ld_2d(s_idx, _pix_hash(idx, w[0]),
                               _pix_hash(idx, w[1]))
                rng.ld = (s_idx,) + tuple(_pix_hash(idx, w[k])
                                          for k in range(2, 6))
            else:
                jitter = rng.next_2d(m)
            ray = sample_primary_ray(flat.sensors[sensor_id],
                                     (base + jitter) / film)
            value = scrub_nonfinite(self.Li(scene, flat, rng, ray, lane < n))
            return torch.where((lane < n)[..., None], value, 0.0)

        ppc = chunk // spp
        n_chunks = -(-n // chunk)
        keys = [key] if n_chunks == 1 else threefry.split(key, n_chunks)
        blocks = []
        for c in range(n_chunks):
            lane = c * chunk + torch.arange(chunk, device=dev)
            blocks.append(lane_values(lane, keys[c])
                          .reshape(ppc, spp, 3).sum(dim=1))
        tile_img = torch.cat(blocks)
        # pixel p sits at tile position inv_order[p]
        inv_order = torch.as_tensor(np.argsort(pix_order_np), device=dev)
        return tile_img[inv_order] / spp

    # -- public API -------------------------------------------------------------
    def radiance_image(self, scene: Scene, flat: FlatScene, sensor_id: int,
                       key: torch.Tensor, with_boundary: bool,
                       shard=None) -> torch.Tensor:
        """Interior (+ boundary, slice 2) render -> (num_pixels, 3)."""
        keys = threefry.split(key, 3)
        img = self.render_interior(scene, flat, sensor_id, keys[0], shard)
        if with_boundary and (scene.opts.sppe > 0 or scene.opts.sppse > 0):
            raise NotImplementedError("boundary terms wait for slice 2")
        return img

    def render_fn(self, scene: Scene, sensor_id: int = 0,
                  with_boundary: bool = True, detached: bool = False):
        """``f(params, key) -> (num_pixels, 3)`` that rebuilds the scene
        from params each call. ``detached=True`` is the forward renderer
        (renderC semantics with per-frame rebuild)."""
        if not detached:
            raise NotImplementedError(
                "differentiable renders (detached=False) wait for slice 2")
        scene.prepare_accel()

        def f(params, key):
            with torch.no_grad():
                flat = detach_flat(scene.build(params))
                return self.radiance_image(scene, flat, sensor_id, key,
                                           with_boundary)
        return f

    def renderC(self, scene: Scene, sensor_id: int = 0,
                seed: int = 0) -> torch.Tensor:
        """Forward render at the current params -> (H, W, 3)."""
        with torch.no_grad():
            img = self.radiance_image(scene, detach_flat(scene.flat),
                                      sensor_id, threefry.PRNGKey(seed), False)
        return img.reshape(scene.opts.height, scene.opts.width, 3)

    def renderD(self, scene: Scene, sensor_id: int = 0, seed: int = 0):
        raise NotImplementedError("renderD waits for slice 2 (the backward)")
