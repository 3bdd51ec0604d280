"""Integrator base: wavefront generation and image accumulation.

Counterpart of ``psdr_tpu/integrator/base.py``: the interior term and the
primary-edge boundary term, in the forward render and under autograd. One
lane per (pixel, sample); interior lanes are pixel-major along a 32x32 tile
traversal and run in chunks of ``RenderOptions.pass_lanes``, each with its
own key from ``split``. Under ``RenderOptions.resolve_remat`` each chunk is
checkpointed: the backward re-runs the chunk's forward (same key, so the
same uniforms and the same hits) instead of keeping its intermediates. The
boundary terms are zero in the primal (``x - x.detach()``) and carry only a
gradient. ``shard=(rank, n_ranks)`` restricts every term to that rank's
contiguous slice of its lane domain (``shard_lane_range``); the partial
images of all ranks sum to the full-budget estimator
(``parallel/sharding.py``).

renderC and renderD run through a per-integrator cache of ``Program``s
(``program.py``: a CUDA graph captured once and replayed), keyed as the
JAX package keys its compiled programs; ``render_program`` is
``render_fn`` as a program over ``(params, key)``, ``grad_program`` the
value and gradient of an L2 loss through it. Nothing a render reads
from host data is made inside it: the tile order is cached on the scene
and the small constants in ``core/hoist.py``.
"""
from __future__ import annotations

import os

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .. import profiling
from ..core import threefry
from ..core.constants import RayEpsilon
from ..core.gather import gather_rows
from ..core.hoist import const, memo
from ..core.segsum import index_sum
from ..core.math import ray_intersect_triangle, scrub_nonfinite
from ..core.records import Ray, RenderOptions, any_requires_grad
from ..core.sampler import RngStream, _pix_hash, ld_2d_scrambled
from ..program import Program, value_and_grad
from ..scene.scene import (FlatScene, Scene, _closest_hit, detach_flat,
                           ray_test)
from ..sensor.perspective import sample_primary_edge, sample_primary_ray


@profiling.span("camera")
def camera_prior_rows(flat: FlatScene, sensor_id: int, pix_order: torch.Tensor,
                      opts: RenderOptions) -> torch.Tensor:
    """Detached per-pixel candidate rows for the camera-hit prior: one
    pixel-center ray per pixel, packed as ``[p0 e1 e2 tri_id]`` (10 floats)
    in tile order, so a pixel-aligned chunk reads its candidates as one
    slice. Missed pixels get an all-zero row whose candidate never hits."""
    flat_det = detach_flat(flat)
    dev = pix_order.device
    base = torch.stack([(pix_order % opts.width).float(),
                        (pix_order // opts.width).float()], dim=-1)
    film = const((opts.width, opts.height), torch.float32, dev)
    ray = sample_primary_ray(flat_det.sensors[sensor_id], (base + 0.5) / film)
    hit = _closest_hit(flat_det, ray, torch.ones(pix_order.shape,
                                                 dtype=torch.bool, device=dev))
    rows = gather_rows(flat_det.face_table,
                       torch.clamp(hit.tri_id, min=0))[:, 0:9]
    rows = torch.where(hit.valid[..., None], rows, 0.0)
    # tri ids are < 2^24 (enforced at build): exact in float32
    tid = torch.where(hit.valid, hit.tri_id, -1).float()
    return torch.cat([rows, tid[:, None]], dim=1)


@profiling.span("intersect")
def camera_prior_for_rays(prior_rows_c: torch.Tensor, ray, spp: int):
    """Per-lane prior tuple for ``ray_intersect_with_prior``: each pixel's
    candidate row goes to its spp lanes, and each lane's ray is
    intersected with it. A candidate hit is a real scene hit, so its t
    bounds the closest t even for a row of another pixel."""
    m = ray.o.shape[0]
    ppc = prior_rows_c.shape[0]
    pr = prior_rows_c[:, None, :].expand(ppc, spp, 10).reshape(m, 10)
    o, d = ray.o.detach(), ray.d.detach()
    uv_c, t_c = ray_intersect_triangle(pr[:, 0:3], pr[:, 3:6], pr[:, 6:9],
                                       o, d)
    cand_tri = pr[:, 9].to(torch.int32)
    ok = ((uv_c[:, 0] >= 0.0) & (uv_c[:, 1] >= 0.0)
          & (uv_c[:, 0] + uv_c[:, 1] <= 1.0) & (t_c > RayEpsilon)
          & (t_c < 1e30) & (cand_tri >= 0))
    inf = float("inf")
    # the margin covers a last-ulp disagreement with the hit query's MT;
    # a looser bound costs cull work, never correctness
    tmax_b = torch.where(ok, t_c * 1.001 + 1e-4, inf)
    return (tmax_b, cand_tri, torch.where(ok[..., None], uv_c, 0.0),
            torch.where(ok, t_c, inf), ok)


def tiled_pixel_order(width: int, height: int, tile: int = 32) -> np.ndarray:
    """Pixel ids in tile-major traversal order, so adjacent lanes form
    tight ray frusta."""
    yy, xx = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    order = np.lexsort((xx.ravel() % tile, yy.ravel() % tile,
                        xx.ravel() // tile, yy.ravel() // tile))
    return (yy.ravel() * width + xx.ravel())[order].astype(np.int32)


def tile_orders(scene: Scene, width: int, height: int, device):
    """``tiled_pixel_order`` and its inverse (pixel p sits at tile position
    ``inv[p]``) as int64 tensors on ``device``, made once per film and
    device and kept on the scene."""
    def make():
        order = tiled_pixel_order(width, height)
        return (torch.as_tensor(order, device=device).long(),
                torch.as_tensor(np.argsort(order), device=device))
    return memo(scene, ("tile_orders", width, height, str(device)), make)


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


@profiling.span("film")
def accumulate_image(value: torch.Tensor, pixel_idx: torch.Tensor,
                     num_pixels: int) -> torch.Tensor:
    """Sum sample values into a (num_pixels, 3) image, each pixel's lanes
    in one fixed order (``core.segsum.index_sum``); lanes with
    ``pixel_idx < 0`` are dropped."""
    return index_sum(value, pixel_idx, num_pixels)


def _checkpointed(fn):
    """``fn`` whose intermediates the backward recomputes instead of
    keeping (``torch.utils.checkpoint``). The port draws no torch random
    numbers (its stream is Threefry on its keys), so no generator state is
    saved or restored: that would read the CUDA generator during a
    capture."""
    return lambda *args: checkpoint(fn, *args, use_reentrant=False,
                                    preserve_rng_state=False)


def scan_lane_chunks(run_lanes, n: int, num_pixels: int, key: torch.Tensor,
                     pass_lanes: int, device, lane_range=None,
                     remat: bool = False) -> torch.Tensor:
    """Run ``run_lanes(lane (m,), key) -> (num_pixels, 3)`` over the
    wavefront in chunks of ``pass_lanes`` and sum the images.
    ``lane_range=(start, count)`` sweeps only that slice of the lane domain
    (a rank's share, ``shard_lane_range``): its chunk keys are split over
    its own chunk count, and lanes >= n are masked inside ``run_lanes``.
    ``remat`` checkpoints each chunk."""
    start, count = (0, n) if lane_range is None else lane_range
    chunk = min(pass_lanes, count)
    n_chunks = -(-count // chunk)
    if remat:
        run_lanes = _checkpointed(run_lanes)
    if n_chunks == 1:
        return run_lanes(start + torch.arange(count, device=device), key)
    keys = threefry.split(key, n_chunks)
    img = torch.zeros((num_pixels, 3), device=device)
    for c in range(n_chunks):
        lane = start + c * chunk + torch.arange(chunk, device=device)
        img = img + run_lanes(lane, keys[c])
    return img


def shard_lane_range(n: int, shard) -> tuple[int, int]:
    """The contiguous lane slice of rank ``d`` of ``n_dev`` over [0, n):
    ``shard=(d, n_dev)`` -> (start, count); ``shard=None`` -> (0, n). Each
    rank takes ceil(n / n_dev) lanes; the last rank's lanes >= n are
    masked, so the ranks' partial images sum to the full-budget estimator
    for any n."""
    if shard is None:
        return 0, n
    d, n_dev = shard
    count = -(-n // n_dev)
    return d * count, count


class Integrator:
    """Base class; subclasses implement ``Li(scene, flat, rng, ray, active,
    prior=None)``. ``prior`` is the optional camera-hit prior for the
    camera closest hit (``scene.ray_intersect_with_prior``)."""

    def Li(self, scene: Scene, flat: FlatScene, rng: RngStream, ray, active,
           prior=None) -> torch.Tensor:
        raise NotImplementedError

    # -- interior -------------------------------------------------------------
    def render_interior(self, scene: Scene, flat: FlatScene, sensor_id: int,
                        key: torch.Tensor, shard=None) -> torch.Tensor:
        opts = scene.opts
        num_pixels = opts.num_pixels
        spp = opts.spp
        dev = scene.device
        if spp == 0:
            return torch.zeros((num_pixels, 3), device=dev)
        n = num_pixels * spp
        start, count = shard_lane_range(n, shard)
        chunk = min(opts.pass_lanes, count)
        pix_order, inv_order = tile_orders(scene, opts.width, opts.height,
                                           dev)
        if opts.sampler not in ("sobol", "stratified", "independent"):
            raise ValueError(f"unknown sampler {opts.sampler!r}")
        # stratify the subpixel jitter over an a x b grid when spp
        # factorizes: lower primary-visibility variance at the same cost
        a = int(np.sqrt(spp))
        while a > 1 and spp % a:
            a -= 1
        use_sobol = opts.sampler == "sobol" and spp > 1
        strat = ((a, spp // a)
                 if (opts.stratify_primary and opts.sampler == "stratified"
                     and a > 1) else None)
        # pixel-aligned chunks: each pixel's spp lanes are adjacent, which
        # the NEE visibility reuse and the per-chunk reduction rely on; a
        # rank's slice must then start and end on a pixel too
        aligned = chunk % spp == 0 and count % spp == 0 and start % spp == 0
        film = const((opts.width, opts.height), torch.float32, dev)
        remat = opts.resolve_remat(count)

        def lane_values(lane, key_c, prior_rows_c=None):
            with profiling.span("camera"):
                pos = torch.clamp(lane // spp, max=num_pixels - 1)
                idx = tile_pos_to_pixel(pos, opts.width, opts.height)
                if idx is None:
                    idx = pix_order[pos]
                base = torch.stack([(idx % opts.width).float(),
                                    (idx // opts.width).float()], dim=-1)
                rng = RngStream(key_c, salt=0, device=dev)
                if aligned:
                    rng.vis_spp = spp
                m = lane.shape[0]
                if use_sobol:
                    # the JAX package draws a uniform jitter here and
                    # replaces it; only its counter slot matters
                    rng._subkey()
                    # XOR-scrambled (0,2)-sequence for the subpixel jitter
                    # and the first NEE/BSDF samples, one scramble pair
                    # each per pixel; the words stay 0-dim tensors on the
                    # key's device (a CPU scalar in the card's ops where
                    # the key is a host key)
                    w = threefry.randint(rng._subkey(), (6,), 0,
                                         np.iinfo(np.int32).max)
                    s_idx = lane % spp
                    jitter = ld_2d_scrambled(s_idx, idx, w, 0)
                    rng.ld = (s_idx, idx, w)
                else:
                    jitter = rng.next_2d(m)
                if strat is not None:
                    sa, sb = strat
                    s_idx = lane % spp
                    cell = torch.stack([(s_idx % sa).float(),
                                        (s_idx // sa).float()], dim=-1)
                    jitter = (cell + jitter) / const((sa, sb), torch.float32,
                                                     dev)
                    # per-pixel rotations of the stratum index for the NEE
                    # and the BSDF sample, independent hashes of the pixel,
                    # so that subpixel and light strata decorrelate across
                    # pixels ("padded" stratified sampling); the (sa, sb)
                    # grid rides along so _stratify2 shares this
                    # factorization
                    w = threefry.randint(rng._subkey(), (2,), 0,
                                         np.iinfo(np.int32).max)
                    rng.strata = (s_idx, spp, (sa, sb),
                                  _pix_hash(idx, w[0]) % spp,
                                  _pix_hash(idx, w[1]) % spp)
                ray = sample_primary_ray(flat.sensors[sensor_id],
                                         (base + jitter) / film)
            if prior_rows_c is None:
                value = self.Li(scene, flat, rng, ray, lane < n)
            else:
                prior = camera_prior_for_rays(prior_rows_c, ray, spp)
                value = self.Li(scene, flat, rng, ray, lane < n, prior=prior)
            value = scrub_nonfinite(value)
            return torch.where((lane < n)[..., None], value, 0.0), idx

        if not aligned:
            def run_lanes(lane, key_c):
                value, idx = lane_values(lane, key_c)
                return accumulate_image(value, torch.where(lane < n, idx, -1),
                                        num_pixels)

            img = scan_lane_chunks(run_lanes, n, num_pixels, key,
                                   opts.pass_lanes, dev,
                                   lane_range=(start, count), remat=remat)
            return img / spp

        # each chunk reduces to a dense (chunk/spp, 3) block of pixels in
        # tile order; one gather puts them back in pixel order
        ppc = chunk // spp
        n_chunks = -(-count // chunk)
        prior_rows = None
        if opts.resolve_camera_prior(spp):
            prior_rows = camera_prior_rows(flat, sensor_id, pix_order, opts)

        def chunk_block(c, key_c):
            lane = start + c * chunk + torch.arange(chunk, device=dev)
            pr_c = None
            if prior_rows is not None:
                # a slice that would run past the end starts earlier, as
                # jax.lax.dynamic_slice clamps it
                s = min(start // spp + c * ppc, prior_rows.shape[0] - ppc)
                pr_c = prior_rows[s:s + ppc]
            value, _ = lane_values(lane, key_c, pr_c)
            with profiling.span("film"):
                return value.reshape(ppc, spp, 3).sum(dim=1)

        if remat:
            chunk_block = _checkpointed(chunk_block)

        keys = [key] if n_chunks == 1 else threefry.split(key, n_chunks)
        blocks = [chunk_block(c, keys[c]) for c in range(n_chunks)]
        with profiling.span("film"):
            tile_img = torch.cat(blocks)
            # pixel p sits at tile position inv_order[p]; this slice's
            # blocks cover positions [start / spp, start / spp + rows)
            rows = tile_img.shape[0]
            rel = inv_order - start // spp
            in_range = (rel >= 0) & (rel < rows)
            img = torch.where(in_range[..., None], gather_rows(
                tile_img, torch.clamp(rel, 0, rows - 1)), 0.0)
            return img / spp

    # -- primary boundary ------------------------------------------------------
    def render_primary_edges(self, scene: Scene, flat: FlatScene,
                             sensor_id: int, key: torch.Tensor,
                             shard=None) -> torch.Tensor:
        """The primary-edge (silhouette) boundary term -> (num_pixels, 3),
        zero in the primal: radiance difference across a sampled screen-space
        edge point times its normal velocity ``x_dot_n``, the only factor
        that carries a gradient."""
        opts = scene.opts
        num_pixels = opts.num_pixels
        dev = scene.device
        sensor = flat.sensors[sensor_id]
        if opts.sppe == 0 or sensor.edges is None:
            return torch.zeros((num_pixels, 3), device=dev)
        n = num_pixels * opts.sppe
        flat_det = detach_flat(flat)

        def run_lanes(lane, key_c):
            rng = RngStream(key_c, salt=1, device=dev)
            m = lane.shape[0]
            # edge-sorted lanes are spatially coherent, so the NEE
            # visibility reuse applies with 16 consecutive lanes in the
            # role of a pixel's strata (its control variate is unbiased for
            # any grouping). Both concatenated halves group independently,
            # since 16 divides m.
            if m % 16 == 0 and os.environ.get(
                    "PSDR_TPU_VIS_REUSE", "edge") == "edge":
                rng.vis_spp = 16
            pes = sample_primary_edge(sensor,
                                      torch.sort(rng.next_1d(m)).values)
            valid = (pes.idx >= 0) & (lane < n)
            if opts.primary_edge_vis_check:
                # reject samples whose edge point is hidden from the camera
                occluded = ray_test(flat_det, pes.ray_c, pes.vis_dist, valid)
                valid = valid & ~occluded
            # ONE Li over the concatenated -/+ rays: each query then runs
            # once at twice the width; lanes stay edge-sorted in each half
            rays_cat = Ray(torch.cat([pes.ray_n.o, pes.ray_p.o]),
                           torch.cat([pes.ray_n.d, pes.ray_p.d]))
            with torch.no_grad():
                L = self.Li(scene, flat_det, rng, rays_cat,
                            torch.cat([valid, valid]))
            delta_L = L[:m] - L[m:]
            pdf = torch.where(valid, pes.pdf.detach(), 1.0)
            value = pes.x_dot_n[..., None] * (delta_L / pdf[..., None])
            # scrub before the subtraction: NaN - NaN would stay NaN
            value = scrub_nonfinite(value)
            if opts.sppe > 1:
                value = value / opts.sppe
            value = value - value.detach()
            value = torch.where(valid[..., None], value, 0.0)
            return accumulate_image(value, torch.where(valid, pes.idx, -1),
                                    num_pixels)

        # halved chunk: run_lanes doubles its lane count (the concatenated
        # -/+ rays), which keeps a chunk's tensors at pass_lanes
        lane_range = shard_lane_range(n, shard)
        return scan_lane_chunks(run_lanes, n, num_pixels, key,
                                max(1, opts.pass_lanes // 2), dev,
                                lane_range=lane_range,
                                remat=opts.resolve_remat(lane_range[1]))

    # -- secondary boundary: overridden by integrators that support it ---------
    def render_secondary_edges(self, scene: Scene, flat: FlatScene,
                               sensor_id: int, key: torch.Tensor,
                               shard=None) -> torch.Tensor:
        return torch.zeros((scene.opts.num_pixels, 3), device=scene.device)

    # -- public API -------------------------------------------------------------
    def radiance_image(self, scene: Scene, flat: FlatScene, sensor_id: int,
                       key: torch.Tensor, with_boundary: bool,
                       shard=None) -> torch.Tensor:
        """Interior render plus, with ``with_boundary``, the primary- and
        secondary-edge boundary terms -> (num_pixels, 3).

        ``shard=(rank, n_ranks)`` restricts every term to that rank's lane
        slice; the ranks' partial images then sum to the full-budget
        estimator (``parallel/sharding.py``'s ``lanes`` mode)."""
        keys = threefry.split(key, 3)
        img = self.render_interior(scene, flat, sensor_id, keys[0], shard)
        if with_boundary and scene.opts.sppe > 0:
            img = img + self.render_primary_edges(scene, flat, sensor_id,
                                                  keys[1], shard)
        if with_boundary and scene.opts.sppse > 0:
            img = img + self.render_secondary_edges(scene, flat, sensor_id,
                                                    keys[2], shard)
        return img

    def render_fn(self, scene: Scene, sensor_id: int = 0,
                  with_boundary: bool = True, detached: bool = False):
        """``f(params, key) -> (num_pixels, 3)`` that rebuilds the scene
        from params each call. Gradients flow from the image to every
        params leaf that requires grad, through the build. ``detached=True``
        is the forward renderer (renderC semantics with per-frame rebuild):
        no graph, and the hit records are read without a recompute."""
        scene.prepare_accel()

        @profiling.span("render")
        def f(params, key):
            if not detached:
                return self.radiance_image(scene, scene.build(params),
                                           sensor_id, key, with_boundary)
            with torch.no_grad():
                flat = detach_flat(scene.build(params))
                return self.radiance_image(scene, flat, sensor_id, key,
                                           with_boundary)
        return f

    def render_program(self, scene: Scene, sensor_id: int = 0,
                       with_boundary: bool = False,
                       detached: bool = True) -> Program:
        """``render_fn`` as a ``Program`` over ``(params, key)``: captured
        on the first call on CUDA tensors and replayed after (the JAX
        package's ``jax.jit(integrator.render_fn(scene, with_boundary=False,
        detached=True))``, its forward benchmark). The params and the key
        lie on one device; ``threefry.PRNGKey(seed, device=...)`` makes the
        key there. Only the forward: under ``torch.no_grad()``."""
        return Program(self.render_fn(scene, sensor_id, with_boundary,
                                      detached),
                       name=f"{type(self).__name__}.render_program",
                       retrace_on=lambda: scene.accel_version)

    def grad_program(self, scene: Scene, target: torch.Tensor,
                     sensor_id: int = 0,
                     with_boundary: bool = False) -> Program:
        """``bench.py``'s jitted ``grad_step`` as a ``Program`` over
        ``(params, key)``: ``value_and_grad`` of mean((image - target)^2)
        through ``render_fn(with_boundary=...)``, with respect to every
        params leaf -> (loss, gradient tree shaped as params). Captured
        with its backward on the first call on CUDA tensors; a rebuilt
        BVH topology (``Scene.maybe_rebuild_accel``) captures it again.
        ``target`` is (num_pixels, 3) on the scene's device."""
        render = self.render_fn(scene, sensor_id, with_boundary)

        def loss(params, key):
            return torch.mean((render(params, key) - target) ** 2)
        return Program(value_and_grad(loss), grad=True,
                       name=f"{type(self).__name__}.grad_program",
                       retrace_on=lambda: scene.accel_version)

    def _jit_radiance(self, scene: Scene, sensor_id: int,
                      with_boundary: bool) -> dict:
        """Per-integrator program cache: renderC and renderD run one
        ``Program`` per (scene, flat, opts, sensor, boundary, detached),
        as the JAX package runs one compiled program per combination."""
        cache = getattr(self, "_radiance_jits", None)
        if cache is None:
            cache = self._radiance_jits = {}
        return cache

    def _jit_radiance_call(self, scene: Scene, sensor_id: int,
                           with_boundary: bool, detached: bool,
                           key: torch.Tensor) -> torch.Tensor:
        """``radiance_image`` through the cached ``Program`` of this
        combination. The program closes over ``scene.flat`` (the cache key
        tracks its identity, so a rebuilt scene gets a new program) and
        takes only the key, which moves to the scene's device first. The
        cache is cleared when it holds more than 16 programs; dropping a
        program frees its graph and pool."""
        cache = self._jit_radiance(scene, sensor_id, with_boundary)
        flat = scene.flat
        k = (id(scene), id(flat), scene.opts, sensor_id, with_boundary,
             detached)
        f = cache.get(k)
        if f is None:
            if len(cache) > 16:
                cache.clear()

            @profiling.span("render")
            def run(key_):
                fl = detach_flat(flat) if detached else flat
                return self.radiance_image(scene, fl, sensor_id, key_,
                                           with_boundary)

            f = cache[k] = Program(run, name=f"{type(self).__name__}."
                                             "_jit_radiance")
        return f(key.to(scene.device))

    def renderC(self, scene: Scene, sensor_id: int = 0,
                seed: int = 0) -> torch.Tensor:
        """Forward render at the current params -> (H, W, 3), through the
        program cache (``_jit_radiance_call``)."""
        img = self._jit_radiance_call(scene, sensor_id, False, True,
                                      threefry.PRNGKey(seed))
        return img.reshape(scene.opts.height, scene.opts.width, 3)

    def renderD(self, scene: Scene, sensor_id: int = 0,
                seed: int = 0) -> torch.Tensor:
        """Primal of the differentiable render at the current params (the
        recompute path; the boundary terms are zero in the primal and add
        only their gradient) -> (H, W, 3). Where no parameter of the scene
        requires grad it runs through the program cache, as the JAX
        package's jitted primal does; where one does, it runs eagerly and
        the image carries the graph to those parameters (a captured
        gradient is ``grad_program``'s)."""
        key = threefry.PRNGKey(seed)
        flat = scene.flat
        if any_requires_grad(flat):
            img = self.radiance_image(scene, flat, sensor_id, key, True)
        else:
            img = self._jit_radiance_call(scene, sensor_id, True, False, key)
        return img.reshape(scene.opts.height, scene.opts.width, 3)
