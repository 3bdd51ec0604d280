#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``psdr_tpu_torch``) on one GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
Every phase passes or the script exits nonzero:

1. the card: a CUDA device, its name and power limit (``nvidia-smi``);
   TF32 off for matmuls and convolutions;
2. build the kernels (``psdr_tpu_torch/csrc/*.cu``: K1 ``intersect.cu``,
   K2 ``brute.cu``, K3 ``culled.cu``, the fixed-order sum ``segsum.cu``,
   the random stream ``rng.cu``, ``Program.profile_layers``' timestamp
   ``stamp.cu`` and the materials ``bsdf.cu``), one ``nvcc`` per source in
   parallel;
3. K1 against its plain PyTorch version on the card, closest hits bit for
   bit and any hits in ``valid``: a random triangle soup (2048 tris, 600
   rays, mixed ``active`` and ``tmax``), a soup whose tree has an even
   depth, two coincident triangles in different leaves under rays from
   both sides (K1 and K3: the lowest slot wins), then the bench scene
   (20,492 tris) on 2^16 camera rays, 2^16 cosine-bounce rays from their
   hits and 2^16 light-sample shadow rays. Then K1 timed on the main
   path's own shapes, the first 2^21-lane camera chunk in tile order
   (closest) and the bounce and shadow sweeps from its hits (any), and on
   2^21 rays through random pixels, the incoherent case; each timed run's
   result compared the same way (the bounce sweep and the random rays on
   their first PLAIN_RAYS = 2^18 rays), and each shape's slab and
   triangle tests counted once by the kernel's counting instantiation, for
   its bound;
4. ``renderC`` on the card against ``renderC`` on the CPU (64x64, spp 4,
   1,292 tris), same key;
5. the forward at full width: ``DirectIntegrator(1, 1)`` through
   ``render_fn(with_boundary=False, detached=True)`` on
   ``cbox_scene(512, 512, spp=64, occluder_subdiv=5)``: one warm-up frame,
   three timed frames, then one profiled frame; K1 and K2 must launch;
   then the random stream's kernels (``csrc/rng.cu``) against the tensor
   code on the card, bit for bit, at the cells' shapes, each timed
   (``rng_phase``); then the materials kernel (``csrc/bsdf.cu``) in each
   mode against the BSDF dispatch's tensor code on the card, bit for bit,
   at 2^19 and 2^21 lanes of the cbox list and of the conductor, each
   timed (``bsdf_phase``);
6. K2 against its plain version, bit for bit: the 700- and 24-triangle
   soups, then the bench scene's emitter-first sweep of 2^21
   bounce rays (its 2 emitter faces), timed;
7. K3's entry point (``ray_intersect_k3``), the counterpart of
   ``scripts/bench_intersect.py``: 1,280- and 20,480-triangle icospheres
   under 2^20 tiled pinhole rays and the bench scene's first 2^21-lane
   camera chunk (tile order, spp 64), each bit for bit against
   ``k1_plain`` and K1, the camera chunk also at a second blocking and
   timed beside K1;
8. a gradient on the card against the same on the CPU (64x64, spp 4);
9. the main path of this slice, the backward at ``bench.py``'s config:
   ``value_and_grad`` of mean(img^2) through ``Scene.build`` and
   ``render_fn(with_boundary=False)`` on ``cbox_scene(512, 512, spp=16,
   occluder_subdiv=5)``: one warm-up step, three timed steps, then one
   profiled step; every leaf finite, K1 (both modes) and K2 launched;
10. the gradient with the boundary terms on the card against the CPU
    (64x64, spp 4, sppe 2, sppse 4); 11. the guiding table on the card
    against the CPU, and a guided step; 12. the boundary step of
    ``DirectIntegrator(1, 1)`` at ``scripts/bench_renderD.py``'s config
    (256x256, spp 16, sppe 8, sppse 64), with K1 and K2 at its shapes;
13. the ``PathTracer`` on the card against the CPU at 64x64:
    ``PathTracer(3)`` interior (spp 4) and ``PathTracer(max_depth=2,
    camera_depth=2)`` with sppe 2, sppse 4 (the fused boundary pass), loss
    and every leaf under phase 10's bounds, boundary images exactly zero;
14. ``PathTracer(max_depth=3)`` forward at phase 5's config (7 rays a
    sample: 1 camera + 2 a depth), then K1 and K2 on the later bounces'
    own rays: the depth-2 bounce (closest) and the depth-2 and depth-3
    shadow sweeps (any) of the first chunk (``k1_plain`` on their first
    PLAIN_RAYS rays), and the depth-3 emitter-first sweep (K2);
15. ``PathTracer(3)`` backward at phase 9's config;
16. the full boundary step, ``PathTracer(max_depth=2, camera_depth=2)``
    through ``render_fn(with_boundary=True)`` at phase 12's config, the
    same step with ``PSDR_TPU_FUSED_BOUNDARY=0`` beside it, no
    ``indexing_backward`` kernel among the profiled step's top ten, and K1
    on the direction side's compacted wavefront (the far trace and the
    anchor trace);
17. the materials and lights on the card against the CPU at 64x64, spp 4:
    ``env_scene`` with a rough-conductor sphere (render, then
    ``value_and_grad`` per leaf under ``PathTracer(2)``, interior and with
    sppe 2, sppse 4) and ``textured_quad_scene`` (render and gradient),
    every leaf finite, the roughness, ``eta``, ``k``, texels, and the
    map's radiance, scale and ``to_world`` among them; and the six AOVs of
    ``FieldExtractionIntegrator`` on the bench scene at 128x128;
18. ``env_bench_scene`` (a rough-conductor sphere of 20,480 faces, a
    textured ground, a sphere with authored normals, an area light and a
    512 x 1024 environment map on its frozen, divided importance grid)
    forward at 512x512, spp 64: ``DirectIntegrator(1, 1)`` and
    ``PathTracer(3)``;
19. the same scene's backward at spp 16 under ``PathTracer(3)``, every leaf
    finite, no ``indexing_backward`` kernel among the profiled step's top
    ten; the same step profiled with the masked lanes' texel reads spread
    (as shipped) and piled on texel 0; and the bilinear lookup's forward and
    backward (four row gathers, four ``index_add_``) timed alone on one
    2^21-lane chunk for the ground texture and for the sky;
20. K1 and K2 at that scene's shapes (``tiled_material_rays``): K1 closest
    on the camera rays of the chunk that ends at the middle of the frame
    and on its BSDF-sampled bounce rays,
    K1 any on its shadow rays toward the sky, K2 on the emitter-first
    sweep over 2 + 12 faces; each against its plain version, timed and
    counted. A lane on which K1 and ``k1_plain`` differ must equal K1's
    walk in tensor code (``k1_walk_plain``): the known rule for grazing
    rays whose computed t is off by more than the cull margin; the count
    is printed;
21. the loader on the card: the bench scene with a 256 x 256 texture on its
    floor written as files (``testing.scenes.write_scene``: the meshes
    through ``Mesh.dump``, the texture through ``core.exr.write_exr``, the
    XML) and loaded with ``Scene.load_file`` on the card: its params equal
    the written ones, ``renderC`` at 64x64, spp 4 matches the CPU's load
    under phase 4's gates, and the forward at phase 5's config launches K1
    and K2 as phase 5 did;
22. the main path of slice 7, the trainer at full width: the same scene
    loaded at ``examples/flagship_recovery.py``'s config (256x256, spp 16,
    sppe 4, sppse 32, one view), a target rendered at the true shape, the
    occluder started from the flagship's deformation, and
    ``opt.Optimizer`` on its ``vertex_positions`` (lr 1e-2) through
    ``render_fn(with_boundary=True)``: one warm-up step and five timed
    steps, each with a finite loss and finite gradients, only the selected
    leaf moved and K1 (both modes) and K2 launched; before them, the
    derivative of the loss along the line to the true shape by the
    gradient against a central difference with the same keys; one
    profiled step without an ``indexing_backward`` kernel in its top ten;
    then K1 and K2 on one step's own inputs (every distinct launch) on the
    refit tree, each against its plain version, timed and counted for its
    bound; ``refit_quality`` timed, one accel rebuild forced, one step on
    the new tree, the step as a program captured on the refit tree, which
    the rebuild makes capture again and whose replay then equals the eager
    step on the new tree (``gate_replay``), and K1 and K2 again on a
    step's inputs there;
23. the trainer and the harness on the card against the CPU at 32x32 (spp
    8, sppe 2, sppse 8): one optimizer step (loss, every selected leaf's
    gradient under phase 10's bounds, the Adam update equal given equal
    gradients), a save / load round trip, ``run_ad`` and ``run_fd`` of a
    sphere translation (each within 1e-4 relative L2 plus the card's
    spread; with their AD-vs-FD error), and the gradient of the 1D vertex
    offset;
24. the environment map's opt-in tables (``PSDR_TPU_ENV_ALIAS=1``,
    ``PSDR_TPU_ENV_HIER=1``) on a 100 x 200 sky (a 398 x 198 grid): render
    and gradient on the card against the CPU; then ``env_bench_scene``'s
    forward (phase 18's config) under each, beside the frozen cmf's;
25. the sharded paths (``psdr_tpu_torch.parallel``) over two gloo ranks
    that share the card (gloo takes CUDA tensors; NCCL cannot put two ranks
    on one card): phase 12's boundary step through ``shard_render_fn``,
    split by budget (spp 16) and by lanes (spp 15, which 2 does not
    divide), each image against ``per_device_render_fn``'s serial emulation
    on the card (rtol 2e-5, atol 2e-6) and each gradient leaf within
    SHARD_REL_L2 of it (the rank bodies are ``testing.ranks``'s, as the
    tests run them); ``make_train_step`` under ``sgd(STEP_LR)`` with
    ``overlap=True`` against ``overlap=False`` and the emulation (over
    gloo its forward and backward are a ``VJPProgram``'s two graphs and
    its update a third, the all-reduces between them); the collective
    guiding table at phase 11's size against the serial one; a one-rank
    NCCL group through ``shard_render_fn`` against the plain render,
    launch counts included, and its ``make_train_step`` captured whole,
    all-reduces inside, against the plain gradient, then timed against the
    split form (``testing.ranks.step_forms``, FORM_REPS calls each in
    turns at ONE_RANK_SCENE and RENDERD); seconds per sharded step, which
    are ranks sharing one card and no scaling figure;
26. ``make_multiview_train_step`` at the flagship's full config (256x256,
    spp 16, sppe 4, sppse 32, the 20,492-face scene, 3 views on 3 gloo
    ranks) from the deformed occluder: loss and updated vertices against a
    serial emulation of the same step (SHARD_REL_L2), beside the
    emulation's own run-to-run spread within this process and across two
    others; seconds per step (each rank's step a program for its loss and
    gradients and one for its update, the all-reduces between them);
27. the main path of slice 8: ``examples.flagship_recovery`` at full
    width (3 views, the bench scene, ``flagship_deform`` as the start,
    smoothed gradients, masked Adam with ``exponential_decay``) for
    FLAGSHIP_ITERS iterations, every iteration with a finite loss and
    gradient and K1 (both modes) and K2 launched, the vertex RMSE below its
    start at the end; the loss and RMSE curve and seconds an iteration
    (each iteration a replay of the step's program, the first with its
    warm-up and capture);
28. the main path of this slice, the forward renders as captured CUDA
    graphs (``psdr_tpu_torch/program.py``), each against the eager render
    at the same key: (a) ``DirectIntegrator(1, 1).render_program`` (phase
    5's config, the scene rebuilt from the params inside the program), (b)
    the same under ``PathTracer(3)`` (phase 14's), (c) ``renderC`` on
    ``env_bench_scene`` (phase 18's) and (d) ``renderD`` with no parameter
    under grad at phase 12's config, every boundary estimator's forward
    and the compacted sweeps in it. For each: capture seconds, graph nodes
    and pool bytes; one replay's launch counts equal to the eager frame's
    (8 / 48 / 8 for a, 24 / 64 / 8 for b); replays at seeds 0, 1, 0 equal
    to the eager image of each seed bit for bit (the eager render repeats
    itself bit for bit) and seed 1 against seed 0,
    which must lie as far apart as the eager renders of the two seeds (no
    key baked in); eager frames and replays timed as
    phase 5 times frames, one of each profiled (device busy, idle share,
    host launch calls); peak memory with the program cached. The kernels
    line's ``launches_forward_programs`` are these replays'; its ``ms``,
    ``plain_ms`` and ``bound_ms`` those of the shapes that (a) replays
    (phases 3 and 6);
29. the main path of this slice, the gradient programs as captured CUDA
    graphs, each against its eager step (``gradient_configs``): (e)
    ``DirectIntegrator(1, 1).grad_program`` (``bench.py``'s jitted
    ``value_and_grad``) at phase 9's config, (f) the same under
    ``PathTracer(3)`` (phase 15's), (g) with every boundary term at phase
    12's, (h) one flagship iteration (``flagship_recovery
    .make_train_step``: three views, smoothing, masked Adam on its
    schedule) at phase 27's config, its eager step's K1 and K2 launches
    held against their plain versions, timed and counted for their bound,
    its replayed vertices equal to the update of the replay's own gradient
    at counts 0 and 1, the replay from count 1 equal to the eager step,
    (i) phase 22's trainer as its value-and-gradient program and
    ``Optimizer._jit_update``, (j) phase 11's guiding build. For each:
    capture seconds, graph nodes and pool bytes; a replay's launch counts
    equal to the eager step's (2 / 12 / 2 for e, 6 / 16 / 2 for f, 4 / 20
    / 4 for g, 3 / 16 / 3 for i); replays at seeds 0, 1, 0 against the
    eager step of each seed, the loss and every gradient leaf equal to it
    bit for bit (the eager step repeats itself), seeds 0 and 1 as far
    apart as eager, segsum launched; the output
    buffers at fixed addresses; eager steps and replays timed (median of
    3), one of each profiled (device busy, idle share, host launch calls:
    one a program), no ``indexing_backward`` kernel in a replay's top
    ten. The kernels line's ``launches`` are these replays';
30. the scene-query layer: K1 through the direction sort
    (``_closest_hit(sort_rays=True)``) against K1 on the same rays
    unsorted, bit for bit, on the PathTracer's depth-2 and depth-3 bounce
    and shadow sweeps (phase 14's chunk) and ``env_bench_scene``'s sky
    shadow sweep (phase 20's); the compacted occlusion sweep
    (``_ray_test_sparse``) against the dense one, lane for lane, on the
    three compacted sweeps of a phase-5 frame (the emitter-first sweep,
    visibility reuse's probes and its quarter-cap second sweep) and on
    the depth-2 shadow sweep, which overflows the cap; each timed both
    ways behind the spin kernel, with the sort, the gathers, the kernel
    launches and the scatters apart. Then ``renderC`` at phase 4's size
    under each ``Scene.accel_mode`` on the card against the CPU, with K1
    launched under "auto", "pallas" and "bvh_walk", K3 under "culled" and
    "bvh", no tree under "brute"; a tree of 8-triangle leaves
    (``accel_leaf_size``), K1 and K3 against ``k1_plain``; and
    ``render_program`` replayed after SNAPSHOTS radiance snapshots evicted
    its envmap table from the host cache and the freed memory was
    refilled with NaN, against the eager render;
31. reproducibility: phases 28 and 29 replay each of
    (a)-(j) twice more at seed 0, equal to the first replay bit for bit,
    and run each eager step twice, equal; then REPRO_STEPS eager trainer
    steps at phase 22's config in two passes, every K1 and K2 launch's
    rays and record hashed on the card (``LaunchHasher``), equal launch for
    launch with equal losses and vertices; a second process
    (``python3 chip_smoke.py --repro-child PATH``) whose REPRO_SMALL
    trainer run equals the same run in this process; phase 12's boundary
    step on two builds of its scene, equal, with the compacted wavefront's
    active lanes; and the fixed-order sum (``csrc/segsum.cu``, a helper of
    the port, no TPU kernel's port) against its plain version bit for bit
    on the main path's own inputs and on hot-row, cold-row and pixel
    shapes, timed beside ``index_add_``;
32. the main path of this slice, the reference's representative gradient
    configuration (BASELINE.md:16): ``preprocess_secondary_edges`` at
    GUIDING_REF (40000 x 5 x 5 cells, 2 samples a cell, 16 rounds:
    2,000,000 lanes a round) on phase 12's scene, its first call (eager
    warm-up, capture, replay), its body eagerly, a build at another seed
    (replayed, profiled) and a second build at the first seed: replay =
    eager and build = build bit for bit, every mass finite and >= 0, some
    positive, the cmf non-decreasing and ending at the total; the guided
    boundary step at phase 12's config, eager (warm-up, three timed steps,
    one profiled step without an ``indexing_backward`` kernel in its top
    ten, the gradient unlike the unguided one) and as ``grad_program``
    against its eager step at seeds 0, 1, 0 bit for bit (phase 29's gates);
    the share of a secondary-edge chunk's lanes that are valid, guided and
    unguided; K1 and K2 at the guided chunk's compacted shapes (524,288
    lanes) and one round's per-cell sum onto 1,000,001 rows (segsum), each
    against its plain version and timed; and what the table buys
    (``scripts/bench_guiding_scale.py``'s measurement): the variance of the
    boundary derivative image over VARIANCE_SEEDS keys, guided against
    unguided, below VARIANCE_RATIO. The kernels line's
    ``launches_guided_boundary`` are the build's first call's and the
    three timed steps';
33. the main path of this slice, gradients above ``remat_lanes`` (2^23),
    where ``remat_passes="auto"`` checkpoints every pass chunk:
    ``PathTracer(3)`` on ``env_bench_scene`` at 512x512, spp 64 (2^24
    lanes), eager (peak memory, launches, every leaf finite, its image
    against the forward's at the same key under phase 4's gates) and as
    ``grad_program`` (first call, a replay, each equal to eager bit for
    bit, one profiled replay); ``remat_passes`` True against False at phase
    19's config (2^22 lanes) eagerly, and at 2^24 lanes on the bench scene
    under ``DirectIntegrator(1, 1)`` eager and replayed: every form's loss
    and every leaf equal bit for bit, with the seconds and peak memory of
    each. The kernels line's ``launches_checkpointed`` are the timed eager
    step's at 2^24 lanes (a checkpointed backward launches its chunks'
    kernels again);
34. the configurations never run on the card before, each on the card
    against the CPU (``untried_configs``: at 64x64, env_bench_scene's
    boundary step at 16x16):
    ``PathTracer(3, camera_depth=3)``'s boundary step, the guided
    ``PathTracer(2, camera_depth=2)`` under both tables (the card's
    carried across to the CPU after their masses matched),
    ``DirectIntegrator(1, 1)``'s boundary step on ``env_bench_scene``,
    ``DirectIntegrator(2, 2)``, ``camera_hit_prior``,
    ``primary_edge_vis_check``, the stratified sampler with and without
    ``stratify_primary`` and the independent one, ``hide_emitters`` on both
    integrators, ``PathTracer(6)``, and ``PSDR_TPU_VIS_REUSE=off``,
    ``=bern`` (q 0.0625) and ``PSDR_TPU_SSE_COMPACT=0``: images under phase
    4's gates, loss and every leaf under phase 10's bounds.

The CPU sides of phases 4, 8, 10, 13, 17, 21, 30 and 34 run in a second
process (``python3 chip_smoke.py --cpu-reference DIR``, ``CpuReference``),
started after the build, beside the card's phases; each earlier phase
runs its card side and holds the comparison until phase 34, so that no
phase waits for the CPU.

With "auto" on the card every scene query of phases 5-29 runs on K1
through the sort and the compaction where the JAX package's call site
asks for them: a compacted sweep is two K1 any-hit launches (the capped
head, then the residue past the cap).

A kernel's bound is the larger of its bytes (each input read once, each
output written once) over 3.35 TB/s and its operations on these rays over
67 TFLOP/s (float32 outside the tensor cores), the published peaks of the
H100 SXM; the random stream's integer operations count against one
instruction a lane a clock (INT32_OPS). No single PyTorch call computes a
ray / triangle closest hit or a Threefry draw, so ``library_ms`` is null
throughout.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. No JAX is imported.
"""
from __future__ import annotations

import atexit
import contextlib
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

# the smoke drives one card: expose only the first unless the caller chose
os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
import torch  # noqa: E402  (after the device choice)

ROOT = os.path.dirname(os.path.abspath(__file__))
RTOL = 1e-5              # hit t, as tests/test_bvh.py:43-50
IMG_RTOL, IMG_ATOL = 1e-4, 1e-5   # per-pixel, as tests/test_torch_render.py
IMG_CLOSE_FRAC = 0.99
IMG_MEAN_REL = 1e-4
BENCH = dict(width=512, height=512, spp=64, occluder_subdiv=5)
BWD = dict(BENCH, spp=16)   # bench.py's backward config
# scripts/bench_renderD.py's config: the boundary step
RENDERD = dict(width=256, height=256, spp=16, sppe=8, sppse=64,
               occluder_subdiv=5)
SMALL = dict(width=64, height=64, spp=4, occluder_subdiv=3)
SMALL_BOUNDARY = dict(SMALL, sppe=2, sppse=4)
# the materials and lights: the small card-vs-CPU scenes, the AOVs' bench
# scene, and env_bench_scene at the forward's and the backward's spp
ENV_SMALL = dict(width=64, height=64, spp=4)
ENV_SMALL_BOUNDARY = dict(ENV_SMALL, sppe=2, sppse=4)
AOV = dict(width=128, height=128, spp=1, occluder_subdiv=5)
AOV_FIELDS = ("silhouette", "position", "depth", "geoNormal", "shNormal", "uv")
ENV_BENCH = dict(width=512, height=512, spp=64)
ENV_BWD = dict(ENV_BENCH, spp=16)
# a rough conductor's silhouette lanes divide by a cosine that is itself a
# rounded difference: two tiers, as tests/test_torch_envmap.py
ROUGH_IMG_TIERS = ((1e-4, 0.97), (2e-3, 0.99))
GUIDING = dict(reso=(24, 3, 3, 4), nrounds=8, seed=3)
# the trainer: examples/flagship_recovery.py's full config, one view, on
# the bench scene loaded from files; the occluder is mesh 5
TRAIN = dict(width=256, height=256, spp=16, sppe=4, sppse=32,
             occluder_subdiv=5)
OCCLUDER = 5
TRAIN_STEPS = 5
# phase 22's check that the gradient leads toward the truth: keys, the
# step of the central difference along the line to the truth, and the bound
# on |gradient - difference| / |difference| (read 0.035 on these keys at
# full width, 0.026 to 0.053 key by key, PERF.md)
DESCENT_KEYS = (100, 101, 102, 103)
DESCENT_EPS = 0.1
DESCENT_REL = 0.1
TEX_SIZE = 256          # the floor texture written as EXR (phases 21, 22)
SMALL_TRAIN = dict(width=32, height=32, spp=8, sppe=2, sppse=8)
ENV_SKY = (100, 200)    # a 398 x 198 importance grid: above 2^15 cells
# phase 24's card-vs-CPU scenes under the opt-in tables
ENV_OPT_SMALL = dict(width=32, height=32, spp=4)
ENV_OPT_BOUNDARY = dict(width=32, height=32, spp=2, sppe=2, sppse=8)
# card against CPU derivative images of run_ad and run_fd, relative L2,
# plus the card's own run-to-run spread (read 6.3e-7 and 3.2e-7, PERF.md)
HARNESS_REL_L2 = 1e-4
# phases 25-27: the sharded steps and the flagship. Phase 25 runs phase 12's
# boundary step over SHARD_RANKS gloo ranks sharing the card, split by
# budget (spp 16) and by lanes (an spp no rank count divides); phase 26 the
# multi-view step at the flagship's full config, one view a rank; phase 27
# the flagship's recovery loop for FLAGSHIP_ITERS iterations (about 25 s on
# the card, what the script's time limit leaves; the 100-plus-iteration run
# goes through the example). A sharded gradient must equal its serial
# emulation on the card within SHARD_REL_L2 relative L2 per leaf (and
# GRAD_COS). Read 1.4e-6 to 2.0e-5, and once 2.8e-4 of unknown cause
# (PERF.md); phase 26 prints the emulation's run-to-run spread within one
# process and across processes, which read the same (1.4e-6 at most), so
# the processes do not round apart. The bound stands 7x above that one
# reading; a sum that double-counted the replicated cotangent would be off
# by 50%, ranks that drew other lanes by the Monte-Carlo noise
SHARD_REL_L2 = 2e-3
SHARD_RANKS = 2
SHARD_LANES_SPP = 15
SHARD_KEY = 11
MV_RANKS = 3
MV_STEPS = 3
MV_SPREAD_RUNS = 2      # runs of phase 26's emulation in each of 3 processes
# the SGD rate of the checked train steps (phases 25, 26): a step of 1e3
# times a gradient stands far above the float32 rounding of the parameter
# it moves, so the updated params carry the gradient's digits (at a rate
# of 1 the rounding alone read 1.3e-4 and 5.2e-4 relative L2, PERF.md)
STEP_LR = 1e3
FLAGSHIP_ITERS = 30
RANK_TIMEOUT = 600      # seconds a phase's ranks may take, spawn included
# phase 25's one NCCL rank: its train step's scene, and the calls of each
# step form timed (in turns) there and at RENDERD
ONE_RANK_SCENE = dict(width=32, height=32, spp=4, sppe=2, sppse=16,
                      occluder_subdiv=3)
FORM_REPS = 7
K2_LAUNCHES = 200       # launches per timed run of the emitter-first sweep
QUERY_REPS = 20         # launches per timed piece of a sort or a compaction
# phase 31: eager trainer steps hashed launch by launch, twice, at TRAIN;
# and the same count at REPRO_SMALL in this process and in a second one
REPRO_STEPS = 15
REPRO_SMALL = dict(width=32, height=32, spp=4, sppe=2, sppse=16,
                   occluder_subdiv=3)
# phase 32: the reference's representative gradient configuration
# (BASELINE.md:16): phase 12's boundary step under a secondary-edge guiding
# table of 40000 x 5 x 5 cells at 2 samples a cell built over 16 rounds
# (scripts/bench_guiding_scale.py): 1,000,000 cells, 2,000,000 lanes a
# round. Then what the table buys, as that script measures it: the
# variance of the boundary derivative image over VARIANCE_SEEDS keys,
# guided against unguided, on its scene (VARIANCE), below VARIANCE_RATIO
# (the JAX package's bar, tests/test_reference_parity.py:277)
GUIDING_REF = dict(reso=(40000, 5, 5, 2), nrounds=16, seed=5)
VARIANCE = dict(width=64, height=64, spp=0, sppse=64, occluder_subdiv=3)
VARIANCE_SEEDS = 4
VARIANCE_RATIO = 0.8
# phase 34: the configurations never run on the card before, each against
# the CPU at phases 4, 10 and 13's 64x64 (SMALL, SMALL_BOUNDARY): a lane
# whose hit differs between K1 and k1_plain (the cull-margin rule) changes
# a whole path, which at 32x32 weighs four times more in the loss and the
# image mean (read there: 2.4e-5 of the loss under PathTracer(3,
# camera_depth=3), 1.16e-4 of the image mean from one pixel under
# DirectIntegrator(2, 2)); env_bench_scene's boundary step at 16x16, whose
# CPU run is the costliest
UNTRIED_ENV_BOUNDARY = dict(width=16, height=16, spp=2, sppe=2, sppse=4)
UNTRIED_GUIDING = dict(reso=(4, 4, 4, 2), nrounds=2, seed=3)
# ... whose CPU side, with those of phases 4, 8, 10, 13, 17, 21 and 30,
# runs in a second process from the start, beside the card's phases, on
# three threads at the lowest priority (nice 19), so that it takes the
# cores that the host's launches leave idle
CPU_REFERENCE_THREADS = 3
CPU_REFERENCE_TIMEOUT = 1100    # seconds after its start it may take at most
SNAPSHOTS = 9           # radiance snapshots that evict a frozen envmap table
NAN_STREAMS = 64        # streams that refill the freed memory (2 x the pool)
SPIN_CYCLES = 100_000_000   # the spin kernel ahead of those launches
GRAD_REL_L2, GRAD_COS = 1e-2, 0.999   # per leaf, as tests/test_torch_grad.py
N_ICO = 1 << 20         # tiled pinhole rays per icosphere (K3's entry point)
N_CHECK = 1 << 16       # rays per bench-scene comparison
N_TIME = 1 << 21        # rays per timed sweep: one pass_lanes chunk
# the first rays of a timed sweep that k1_plain runs on, and that the
# kernel's result is held to, where its block-culled dense walk takes ~10 s
# on all 2^21 (phase 3's bounce sweep and random rays, phase 14's later
# bounces); elsewhere it runs on every ray
PLAIN_RAYS = 1 << 18
DEVICE = "cuda:0"
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, published
FP32_FLOPS = 67e12          # float32 outside the tensor cores, published
# flops as the sources execute them: K1's slab test reads the near and far
# planes by the ray's sign, K3's takes them by min/max; a Moller-Trumbore
# test left after u, left after v, or run in full with its accept test
K1_SLAB_FLOPS = 19
K3_SLAB_FLOPS = 25
MT_FLOPS = (25, 43, 51)
LANE_BYTES = 1 + 16         # every lane: active read; t, tri_id, uv written
ACTIVE_BYTES = 28           # an active lane besides: o, d, tmax read
# the random stream (csrc/rng.cu): 32-bit integer operations an element as
# the algorithm states them, a funnel-shift rotation one, against one
# instruction a lane a clock: 132 SMs x 4 schedulers x 32 lanes at the
# 1.98 GHz boost clock.
# A Threefry-2x32 block: the key schedule's 2 xors, 2 + 15 adds of key
# words, 20 rounds of an add, a rotation and an xor. Then a uniform's xor,
# shift, or and float subtraction; random_bits' xor; randint's four blocks,
# two remainders, a product, a sum and a remainder, and the offset's add.
# A (0,2)-point: the bit reversal, the LP matrix's 32 bit tests and 32
# xors, two scramble hashes of 9, two xors, two conversions, two scalings.
INT32_OPS = 132 * 4 * 32 * 1.98e9
THREEFRY_OPS = 79
RNG_OPS = {"uniform": THREEFRY_OPS + 4, "random_bits": THREEFRY_OPS + 1,
           "split": THREEFRY_OPS, "fold_in": THREEFRY_OPS,
           "randint": 4 * THREEFRY_OPS + 6, "ld_2d": 89}
# bytes an element: the output written (a (0,2)-point also reads its int64
# sample index and pixel id)
RNG_BYTES = {"uniform": 4, "random_bits": 8, "split": 16, "fold_in": 16,
             "randint": 4, "ld_2d": 24}
# the draws' element counts on the cells' paths: a 2^21-lane chunk's
# next_3d (bunny_env), a chunk's next_2d lanes, and cbox_direct's 2^19 lanes
RNG_SIZES = (3 << 21, 1 << 21, 1 << 19)
# the materials kernel (csrc/bsdf.cu): cbox_direct's and cbox_path's 2^19
# lanes a call, bunny_env's 2^21; bytes a lane that it must move with every
# lane active and constant maps (no uv read): the mask (1), bsdf_id (4) and
# wi (12) read, then wo (12) read and the value (12) or pdf (4) written, or
# the sample's two numbers (8) read and valid, pdf and wo (17) written
BSDF_SIZES = (1 << 19, 1 << 21)
BSDF_BYTES = {"eval": 41, "pdf": 33, "sample": 42}


T_START = time.time()


def log(*args):
    """Print and flush; a phase's heading carries the seconds since the
    start."""
    if args and str(args[0]).startswith("phase "):
        args = (*args, f"[{time.time() - T_START:.0f} s]")
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def check_any_hits(label, args, tris, hk, hp):
    """Any-hit kernel record ``hk`` against plain record ``hp`` on the K1
    inputs ``args`` (bvh, ray_o, ray_d, active, tmax) over triangles
    ``tris`` (p0, e1, e2): ``valid`` exactly equal; and, as the walk may
    stop at another triangle than the closest, the plain Moller-Trumbore
    on the kernel's triangle accepts the hit and gives its t and uv.
    Returns (largest |t_kernel - t_plain MT| over hit lanes, lanes whose
    ``valid`` differs)."""
    from psdr_tpu_torch.accel.bruteforce import _accept, moller_trumbore_tile
    vk, vp = hk.valid.cpu().numpy(), hp.valid.cpu().numpy()
    n_bad = int((vk != vp).sum())
    if n_bad:
        raise AssertionError(f"{label}: valid differs on {n_bad} lanes")
    if not vk.any():    # a sweep that nothing blocks: valid is all there is
        log(f"  {label}: 0 / {vk.size} occluded; valid equal")
        return 0.0, 0
    _, ray_o, ray_d, _, tmax = args
    hit = hk.valid
    ids = hk.tri_id[hit].long()
    tri9 = tuple(x[ids, c] for x in tris for c in range(3))
    u, v, t = moller_trumbore_tile(
        *(ray_o[hit, c] for c in range(3)),
        *(ray_d[hit, c] for c in range(3)), tri9)
    if not bool(_accept(u, v, t, tmax[hit]).all()):
        raise AssertionError(f"{label}: a kernel hit fails the plain "
                             "accept test")
    np.testing.assert_allclose(hk.uv[hit].cpu().numpy(),
                               torch.stack([u, v], -1).cpu().numpy(),
                               rtol=1e-4, atol=1e-5, err_msg=label)
    tk, tp = hk.t.cpu().numpy()[vk], t.cpu().numpy()
    np.testing.assert_allclose(tk, tp, rtol=RTOL, err_msg=label)
    err = float(np.abs(tk - tp).max())
    log(f"  {label}: {vk.sum()} / {vk.size} occluded, t against the plain "
        f"MT on the kernel's triangle; valid equal, max |dt| {err:.3g}")
    return err, n_bad


@contextlib.contextmanager
def switches(env):
    """The environment switches ``env`` set for the block and restored
    after."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def time_ms(fn, reps: int, warmup: bool = True, spin: bool = False):
    """Mean device milliseconds of ``fn`` over ``reps`` back-to-back
    launches, by CUDA events, and the last launch's result. ``spin`` queues
    the launches behind a spin kernel (see ``launch_times_ms``): for a
    kernel that runs shorter than the host takes to enqueue it."""
    if warmup:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if spin:
        torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def bound(n_bytes, flops):
    """(bound ms, the side that sets it)."""
    by, op = n_bytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return (by, "bytes") if by >= op else (op, "operations")


def ray_bytes(active):
    """Bytes of rays and hits that K1, K2 or K3 must move under the mask
    ``active``: an inactive lane's ray is never read."""
    return active.numel() * LANE_BYTES + int(active.sum()) * ACTIVE_BYTES


def tree_bytes(bvh):
    """Bytes of the tree that K1 reads, each once: the wide nodes, the leaf
    rows, their validity bytes and the permutation."""
    P, L = bvh.num_leaves, bvh.leaf_size
    return (bvh.wide.numel() + bvh.leaf_tris.numel()) * 4 + P * L * 5


def small_cases(intersect, bvh_mod, dev, record):
    """The tests/test_bvh.py:192-197 soup (2048 tris, 600 rays; the tree
    is 9 levels deep), a 1000-triangle soup (8 levels), and the tie case:
    two coincident triangles in different leaves, rays from both sides,
    the lowest slot wins in K1 and K3."""
    from psdr_tpu_torch.scene.scene import BVH_LEAF_SIZE
    from psdr_tpu_torch.testing.scenes import coincident_case, triangle_soup

    def on_card(xs):
        return [torch.as_tensor(x, device=dev) for x in xs]

    for n_tris in (2048, 1000):
        p0, e1, e2, *rays = triangle_soup(n_tris=n_tris)
        topo = bvh_mod.build_bvh_topology(p0, e1, e2, leaf_size=BVH_LEAF_SIZE)
        tris = on_card((p0, e1, e2))
        args = (bvh_mod.refit_bvh(topo, *tris), *on_card(rays))
        hp = intersect.k1_plain(*args)
        record("closest", exact(f"soup {n_tris} closest",
                                intersect.k1_cuda(*args), hp))
        record("any", check_any_hits(f"soup {n_tris} any", args, tris,
                                     intersect.k1_cuda(*args, any_hit=True),
                                     hp))
    for swap in (False, True):
        (topo, *arrs), winner = coincident_case(swap)
        p0, e1, e2, *rays = on_card(arrs)
        args = (bvh_mod.refit_bvh(topo, p0, e1, e2), *rays)
        hp = intersect.k1_plain(*args)
        label = f"coincident triangles (winner id {winner})"
        record("closest", exact(f"{label}: K1", intersect.k1_cuda(*args), hp))
        exact(f"{label}: K3", intersect.k3_cuda(*args), hp)
        exact(f"{label}: the walk in tensor code",
              intersect.k1_walk_plain(*args), hp)
        ids = hp.tri_id.cpu().numpy()
        if (ids == winner).sum() < 100 or (ids == 60 - winner).any():
            raise AssertionError(f"{label}: the tie case has no ties")


def bench_scene(dev):
    """The bench scene on the card: (scene, detached flat scene)."""
    from psdr_tpu_torch.scene.scene import detach_flat
    from psdr_tpu_torch.testing.scenes import cbox_scene
    sc = cbox_scene(**BENCH, device=dev)
    sc.prepare_accel()
    return sc, detach_flat(sc.build(sc.params()))


def k1_args(flat, ray, act, tmax):
    return (flat.accel, ray.o.contiguous(), ray.d.contiguous(), act,
            (torch.full_like(ray.o[:, 0], float("inf")) if tmax is None
             else tmax.contiguous()))


def k1_phase(intersect, bvh_mod, dev):
    """Phase 3: K1 against its plain version on the small cases and the
    bench scene, then timed at the main path's shapes and on random rays.
    Returns ({mode: [(max |dt|, valid mismatches), ...]}, {shape: dict of
    its mode, kernel ms, plain ms, counts and bound})."""
    from psdr_tpu_torch.testing.scenes import scene_rays, tiled_camera_rays
    err = {"closest": [], "any": []}
    small_cases(intersect, bvh_mod, dev, lambda m, e: err[m].append(e))
    sc, flat = bench_scene(dev)
    tris = (flat.tri.p0, flat.tri.e1, flat.tri.e2)
    log(f"  bench scene: {flat.tri.p0.shape[0]} tris, "
        f"{flat.accel.num_leaves} leaves, "
        f"{bvh_mod.wide_layout(flat.accel.num_leaves)}")

    compare = comparer(err, tris)
    for label, rays in zip(("camera", "bounce", "shadow"),
                           scene_rays(sc, flat, N_CHECK, 1)):
        args = k1_args(flat, *rays)
        hp = intersect.k1_plain(*args)
        for any_hit in ((False, True) if rays[2] is None else (True,)):
            compare(label, args, intersect.k1_cuda(*args, any_hit=any_hit),
                    hp, any_hit)
    # timed: the main path's shapes (tile order) and the incoherent case
    t_cam, t_bnc, t_shd = tiled_camera_rays(sc, flat, N_TIME, BENCH["spp"], 2)
    r_cam, _, r_shd = scene_rays(sc, flat, N_TIME, 2)
    shapes = {}
    for name, any_hit, rays, plain in (
            ("tiled camera chunk", False, t_cam, None),
            ("tiled bounce sweep", True, t_bnc, PLAIN_RAYS),
            ("tiled shadow sweep", True, t_shd, None),
            ("random camera rays", False, r_cam, PLAIN_RAYS),
            ("random shadow rays", True, r_shd, PLAIN_RAYS)):
        shapes[name] = k1_shape(intersect, name, any_hit,
                                k1_args(flat, *rays), compare, plain)
    return err, shapes


def comparer(err, tris):
    """``compare(label, args, kernel hit, plain hit, any_hit)`` that holds a
    K1 result to the plain version's (closest: bit for bit; any: ``valid``,
    and the plain Moller-Trumbore on the kernel's triangle over ``tris``)
    and appends (max |dt|, valid mismatches) to ``err[mode]``."""
    def compare(label, args, hk, hp, any_hit):
        mode = "any" if any_hit else "closest"
        err[mode].append(
            check_any_hits(f"{label} {mode}", args, tris, hk, hp)
            if any_hit else exact(f"{label} {mode}", hk, hp))
    return compare


def k1_shape(intersect, name, any_hit, args, compare, plain_rays=None):
    """K1 timed on the rays ``args`` (kernel, plain once, kernel), its slab
    and triangle tests counted once by the counting instantiation for the
    bound, and the timed result compared with the plain version's through
    ``compare(label, args, kernel hit, plain hit, any_hit)``; with
    ``plain_rays``, the plain version runs (and the kernel's result is
    compared) on the first ``plain_rays`` rays only. Returns the dict of
    its mode, ms, plain ms, counts and bound."""
    n = args[1].shape[0]
    m = min(plain_rays or n, n)
    some = (args[0], *(x[:m] for x in args[1:]))
    k1, hk = time_ms(lambda: intersect.k1_cuda(*args, any_hit=any_hit), 20,
                     spin=True)
    p1, hp = time_ms(lambda: intersect.k1_plain(*some), 1, warmup=False)
    k2, _ = time_ms(lambda: intersect.k1_cuda(*args, any_hit=any_hit), 20,
                    spin=True)
    counts = torch.zeros((4,), dtype=torch.int64, device=args[1].device)
    intersect.k1_cuda(*args, any_hit=any_hit, counts=counts)
    n_box, *n_tri = (int(c) for c in counts.cpu())
    flops = n_box * K1_SLAB_FLOPS + sum(
        c * f for c, f in zip(n_tri, MT_FLOPS))
    b_ms, b_by = bound(ray_bytes(args[3]) + tree_bytes(args[0]), flops)
    ms = min(k1, k2)
    per_ray = " + ".join(f"{c / n:.1f}" for c in n_tri)
    log(f"  {n} rays, {name} ({'any' if any_hit else 'closest'}, "
        f"{int(args[3].sum())} active): kernel {k1:.3f} / {k2:.3f} ms, "
        f"plain {p1:.1f} ms" + (f" on the first {m} rays" if m < n else "")
        + f"; {n_box / n:.1f} slab tests and "
        f"{per_ray} triangle tests (left after u + left after v + in "
        f"full) a ray, {flops / n:.0f} flops a ray -> bound "
        f"{b_ms:.5f} ms by {b_by}, reached {b_ms / ms:.3f}")
    compare(f"{n} {name}", some, type(hk)(*(f[:m] for f in hk)), hp, any_hit)
    return dict(any_hit=any_hit, rays=n, active=int(args[3].sum()), ms=ms,
                plain_ms=p1, plain_rays=m,
                slab_tests=n_box, tri_tests_by_stage=n_tri, flops=flops,
                bound_ms=b_ms, bound_by=b_by)


def exact(label, hk, hp):
    """Kernel record ``hk`` equal to plain record ``hp`` bit for bit:
    valid, tri_id, t (inf on misses) and uv. Returns (max |dt| over hit
    lanes, lanes whose valid differs), both 0, or raises."""
    vk, vp = hk.valid.cpu().numpy(), hp.valid.cpu().numpy()
    n_bad = int((vk != vp).sum())
    diffs = {f: int((getattr(hk, f).cpu().numpy()
                     != getattr(hp, f).cpu().numpy()).reshape(len(vk), -1)
                    .any(axis=1).sum())
             for f in ("tri_id", "t", "uv")}
    if n_bad or any(diffs.values()):
        raise AssertionError(f"{label}: not bit-equal: valid differs on "
                             f"{n_bad} lanes, {diffs}")
    if not vk.any():
        raise AssertionError(f"{label}: no lane hit, nothing to compare")
    log(f"  {label}: {vk.sum()} / {vk.size} hit; valid, tri_id, t, uv equal "
        "bit for bit")
    return 0.0, 0


def k2_phase(intersect, dev):
    """Phase 6: K2 against brute_plain on two soups and on the bench
    scene's 2^21-lane emitter-first sweep, the last timed (``k2_timed``).
    Returns ([(max |dt|, valid mismatches), ...], the timed sweep's
    dict)."""
    from psdr_tpu_torch.accel.bruteforce import brute_plain
    from psdr_tpu_torch.testing.scenes import scene_rays, triangle_soup
    err = []
    for n_tris in (700, 24):
        args = [torch.as_tensor(x, device=dev)
                for x in triangle_soup(n_tris=n_tris)]
        err.append(exact(f"soup {n_tris} tris", intersect.k2_cuda(*args),
                         brute_plain(*args)))
    sc, flat = bench_scene(dev)
    _, (bounce, hit, _), _ = scene_rays(sc, flat, N_TIME, 2)
    idxs = flat.em_tri_idx
    args = (*(x[idxs].contiguous() for x in (flat.tri.p0, flat.tri.e1,
                                             flat.tri.e2)),
            bounce.o.contiguous(), bounce.d.contiguous(), hit,
            torch.full_like(hit, float("inf"), dtype=torch.float32))
    e, timed = k2_timed(intersect, args, "emitter-first sweep",
                        f"{N_TIME} bounce rays")
    return err + [e], timed


def launch_times_ms(fn, reps):
    """Device milliseconds of each of ``reps`` launches of ``fn``, by one
    CUDA event between launches. The launches are queued behind a spin
    kernel of some 50 ms, so the card finds each one waiting: the interval
    between two events is then the kernel's own time, not the time the
    host takes to enqueue it (which, for a kernel of tens of microseconds,
    is the longer of the two)."""
    fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(SPIN_CYCLES)
    events[0].record()
    for e in events[1:]:
        fn()
        e.record()
    torch.cuda.synchronize()
    return np.array([a.elapsed_time(b) for a, b in zip(events, events[1:])])


def k2_timed(intersect, args, name, what):
    """K2 on ``args`` (p0, e1, e2, ray_o, ray_d, active, tmax) against
    brute_plain bit for bit, timed launch by launch in two separate runs of
    K2_LAUNCHES with the plain version's runs between them: the median and
    the minimum over all launches. Returns ((max |dt|, valid mismatches),
    dict of ms (the median), ms_min, plain ms, rays, active rays, faces and
    the bound)."""
    from psdr_tpu_torch.accel.bruteforce import brute_plain
    n, n_faces = args[3].shape[0], args[0].shape[0]
    n_active = int(args[5].sum())
    hk = intersect.k2_cuda(*args)
    run1 = launch_times_ms(lambda: intersect.k2_cuda(*args), K2_LAUNCHES)
    p1, hp = time_ms(lambda: brute_plain(*args), 5)
    run2 = launch_times_ms(lambda: intersect.k2_cuda(*args), K2_LAUNCHES)
    both = np.concatenate([run1, run2])
    ms, ms_min = float(np.median(both)), float(both.min())
    # K2 runs every test of an active lane in full: it has no early exit
    b_ms, b_by = bound(ray_bytes(args[5]) + n_faces * 36,
                       n_active * n_faces * MT_FLOPS[2])
    log(f"  {what} x {n_faces} faces, {name} ({n_active} active): "
        f"kernel median {ms:.4f} ms, minimum {ms_min:.4f} ms over 2 x "
        f"{K2_LAUNCHES} launches (runs' medians {np.median(run1):.4f} / "
        f"{np.median(run2):.4f}, maxima {run1.max():.4f} / {run2.max():.4f})"
        f"; plain {p1:.3f} ms; bound {b_ms:.5f} ms by {b_by}, reached "
        f"{b_ms / ms:.3f} at the median, {b_ms / ms_min:.3f} at the minimum")
    e = exact(f"{n} {name}", hk, hp)
    return e, dict(rays=n, active=n_active, faces=n_faces, ms=ms,
                   ms_min=ms_min, plain_ms=p1, bound_ms=b_ms, bound_by=b_by)


def icosphere_case(bvh_mod, dev, subdiv):
    """An icosphere of 20 * 4^subdiv faces and N_ICO pinhole rays from
    z = 3 in 32x32 tiles, as scripts/bench_intersect.py lays them out:
    (bvh, ray_o, ray_d, active, tmax) on ``dev``."""
    from psdr_tpu_torch.scene.scene import BVH_LEAF_SIZE
    from psdr_tpu_torch.shape import primitives
    from psdr_tpu_torch.shape.mesh import compute_triangle_info
    m = primitives.make_icosphere(subdiv=subdiv, radius=1.0)
    info, _ = compute_triangle_info(torch.as_tensor(m.vertices, device=dev),
                                    torch.as_tensor(m.faces, device=dev),
                                    m.num_vertices, m.corner_table(dev))
    tris = (info.p0, info.e1, info.e2)
    topo = bvh_mod.build_bvh_topology(*(x.cpu().numpy() for x in tris),
                                      leaf_size=BVH_LEAF_SIZE)
    side = int(np.sqrt(N_ICO))
    g = np.linspace(-0.55, 0.55, side, dtype=np.float32)
    px, py = np.meshgrid(g, g)
    d = np.stack([px.ravel(), py.ravel(),
                  np.full(side * side, -1.0, np.float32)], axis=-1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    yy, xx = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    order = np.lexsort((xx.ravel() % 32, yy.ravel() % 32, xx.ravel() // 32,
                        yy.ravel() // 32))
    n = side * side
    return (bvh_mod.refit_bvh(topo, *tris),
            torch.tensor([[0.0, 0.0, 3.0]], device=dev).expand(n, 3)
            .contiguous(), torch.as_tensor(d[order], device=dev),
            torch.ones((n,), dtype=torch.bool, device=dev),
            torch.full((n,), float("inf"), device=dev)), m.num_faces


def k3_phase(intersect, bvh_mod, dev, k1_bound):
    """Phase 7: K3's entry point over the icospheres and a bench-scene
    camera chunk, with the launch counts set to 0 just before and read
    just after; then each result against k1_plain and K1, bit for bit,
    the camera chunk also at a second blocking, and timed. ``k1_bound``
    is K1's (bound ms, side) on the same chunk, which K3 shares. Returns
    (K3 launches on its path, [(max |dt|, valid mismatches), ...], dict of
    K3 ms, plain ms, K1 ms, the second blocking's ms and the floor of K3's
    own dense arithmetic)."""
    from psdr_tpu_torch.testing.scenes import tiled_camera_rays
    cases = [icosphere_case(bvh_mod, dev, s) for s in (3, 5)]
    sc, flat = bench_scene(dev)
    cam_args = k1_args(flat, *tiled_camera_rays(sc, flat, N_TIME,
                                                BENCH["spp"], 2)[0])
    labels = [f"icosphere {f} tris, {N_ICO} rays" for _, f in cases] + [
        f"bench camera chunk, {N_TIME} rays"]
    all_args = [a for a, _ in cases] + [cam_args]
    torch.cuda.synchronize()
    intersect.reset_launch_counts()
    hits = [intersect.ray_intersect_k3(*a) for a in all_args]
    torch.cuda.synchronize()
    launches = intersect.LAUNCHES["k3"]
    if launches != len(all_args):
        raise AssertionError(f"phase 7: K3 launched {launches} times on "
                             f"its path, expected {len(all_args)}")
    err = []
    for label, args, hk in zip(labels[:-1], all_args[:-1], hits[:-1]):
        hp = intersect.k1_plain(*args)
        err.append(exact(f"{label}: K3 vs k1_plain", hk, hp))
        exact(f"{label}: K1 vs k1_plain", intersect.k1_cuda(*args), hp)
    # the camera chunk, timed: K3, plain (once), K3, with K1 and K3 at a
    # second blocking beside
    second = dict(ray_block=128, tri_block=256)
    t1, _ = time_ms(lambda: intersect.k3_cuda(*cam_args), 20)
    p1, hp = time_ms(lambda: intersect.k1_plain(*cam_args), 1, warmup=False)
    t2, _ = time_ms(lambda: intersect.k3_cuda(*cam_args), 20)
    s1, h2 = time_ms(lambda: intersect.k3_cuda(*cam_args, **second), 20)
    m1, h1 = time_ms(lambda: intersect.k1_cuda(*cam_args), 20)
    # the floor of K3's design: every ray against every non-empty
    # leaf-block box, and for every (ray block, leaf block) pair that the
    # plain cull over (RayEpsilon, tmax) leaves occupied, every ray against
    # every valid slot at least as far as u
    bvh = flat.accel
    n_boxes = bvh.num_leaves * bvh.leaf_size // 128
    occupied = intersect._block_cull(*cam_args, 512, 128)[4]
    pairs = int(occupied.sum())
    pair_slots = int((occupied.double()
                      @ bvh.tri_valid.reshape(n_boxes, 128).sum(1).double())
                     .sum())
    full_boxes = int(bvh.node_mask[n_boxes:2 * n_boxes].sum())
    floor_ms = (N_TIME * full_boxes * K3_SLAB_FLOPS
                + pair_slots * 512 * MT_FLOPS[0]) / FP32_FLOPS * 1e3
    ms = min(t1, t2)
    log(f"  {labels[-1]}: K3 {t1:.3f} / {t2:.3f} ms at 512 x 128, {s1:.3f} ms "
        f"at {second['ray_block']} x {second['tri_block']}; K1 {m1:.3f} ms; "
        f"plain {p1:.1f} ms; bound {k1_bound[0]:.4f} ms by {k1_bound[1]} "
        f"(K1's, same rays), reached {k1_bound[0] / ms:.4f}; its own dense "
        f"arithmetic ({pairs} occupied pairs with {pair_slots} valid slots "
        f"over {N_TIME // 512} ray blocks and {full_boxes} non-empty of "
        f"{n_boxes} leaf blocks) at least {floor_ms:.3f} ms")
    err.append(exact(f"{labels[-1]}: K3 vs k1_plain", hits[-1], hp))
    err.append(exact(f"{labels[-1]}: K3 at {second['ray_block']} x "
                     f"{second['tri_block']} vs k1_plain", h2, hp))
    exact(f"{labels[-1]}: K1 vs k1_plain", h1, hp)
    return launches, err, dict(ms=ms, plain_ms=p1, k1_ms=m1, second_ms=s1,
                               dense_floor_ms=floor_ms)


def int_bound(n_bytes, ops):
    """(bound ms, the side that sets it) for integer work: ``ops`` 32-bit
    operations at INT32_OPS."""
    by, op = n_bytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS * 1e3
    return (by, "bytes") if by >= op else (op, "operations")


def rng_shape(intersect, name, what, n, fn, plain):
    """One of the random stream's kernels on ``n`` elements: ``fn()``
    launched twice, each one launch of ``launches.rng`` and equal to
    ``plain()`` (its plain version, the tensor code, on the card on the
    same inputs) bit for bit; both timed (the kernel as 20 launches behind
    the spin kernel), with the kernel's bound (RNG_BYTES and RNG_OPS of
    ``what``). Returns its dict."""
    def launch():
        before = intersect.RNG_LAUNCHES["rng"]
        out = fn()
        if intersect.RNG_LAUNCHES["rng"] - before != 1:
            raise AssertionError(f"phase 5: rng {name}: not one launch")
        return out

    def bits(x):
        return x.view(torch.int32) if x.dtype == torch.float32 else x
    got, again, want = launch(), launch(), plain()
    if not (got.is_cuda and want.is_cuda and got.dtype == want.dtype
            and torch.equal(bits(got), bits(want))
            and torch.equal(bits(again), bits(got))):
        raise AssertionError(f"phase 5: rng {name}: the kernel differs from "
                             "the tensor code or from itself")
    ms, _ = time_ms(fn, 20, spin=True)
    plain_ms, _ = time_ms(plain, 3)
    b_ms, b_by = int_bound(n * RNG_BYTES[what], n * RNG_OPS[what])
    log(f"  rng {name}: kernel = tensor code bit for bit and = itself; "
        f"{ms:.5f} ms (tensor code {plain_ms:.3f}), bound {b_ms:.5f} ms by "
        f"{b_by} ({b_ms / ms:.3f})")
    return {"elements": n, "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            "bound_share": b_ms / ms}


def rng_phase(intersect, dev):
    """Phase 5's random stream (``core/threefry.py``, ``core/sampler.py``,
    ``csrc/rng.cu``; no TPU kernel's port): each kernel against its plain
    version, the tensor code run on the card on the same inputs, bit for
    bit and against itself, one launch of ``launches.rng`` each, timed
    beside it (``rng_shape``). ``uniform`` and ``random_bits`` at
    RNG_SIZES under a key on the card (read from device memory), a host
    key (its words passed as arguments) and a row of a split block on the
    card; ``split(8)`` and ``fold_in`` (a chunk's key derivations) on the
    card's key and on the row; ``randint(6)`` (a chunk's scramble words)
    under the card's key, the host key and the row; ``ld_2d_scrambled`` at
    RNG_SIZES, words on the card and on the host, sample indices up to
    2^32 - 1 and pixel ids of a 384 x 384 film. Returns {shape: dict}; the
    first is the main shape."""
    from psdr_tpu_torch.core import sampler, threefry
    host = threefry.fold_in(threefry.PRNGKey(271828), 18)
    card = host.to(dev)
    row = threefry.split(card, 8)[5]
    out = {}
    for n in RNG_SIZES:
        for mode, key, draw_dev in (("key on the card", card, None),
                                    ("host key", host, dev),
                                    ("split row", row, None)):
            for what, fn, plain in (
                    ("uniform", threefry.uniform, threefry.uniform_plain),
                    ("random_bits", threefry.random_bits,
                     threefry.random_bits_plain)):
                out[f"{what}, {n}, {mode}"] = rng_shape(
                    intersect, f"{what}, {n}, {mode}", what, n,
                    lambda: fn(key, (n,), draw_dev),
                    lambda: plain(key, (n,), dev))
    for mode, key in (("key on the card", card), ("split row", row)):
        out[f"split(8), {mode}"] = rng_shape(
            intersect, f"split(8), {mode}", "split", 8,
            lambda: threefry.split(key, 8),
            lambda: threefry.split_plain(key, 8))
        for data in (0, 2**32 - 1):
            out[f"fold_in({data}), {mode}"] = rng_shape(
                intersect, f"fold_in({data}), {mode}", "fold_in", 1,
                lambda: threefry.fold_in(key, data),
                lambda: threefry.fold_in_plain(key, data))
    for mode, key, draw_dev in (("key on the card", card, None),
                                ("host key", host, dev),
                                ("split row", row, None)):
        out[f"randint(6), {mode}"] = rng_shape(
            intersect, f"randint(6), {mode}", "randint", 6,
            lambda: threefry.randint(key, (6,), 0, 2**31 - 1, draw_dev),
            lambda: threefry.randint_plain(key, (6,), 0, 2**31 - 1, dev))
    words = threefry.randint(host, (6,), 0, 2**31 - 1)
    g = torch.Generator(device=dev).manual_seed(31)
    for n in RNG_SIZES:
        idx = torch.randint(0, 2**32, (n,), dtype=torch.int64, device=dev,
                            generator=g)
        idx[: n // 2] %= 64                     # a lane's index in its pixel
        pix = torch.randint(0, 384 * 384, (n,), dtype=torch.int64,
                            device=dev, generator=g)
        for mode, w in (("words on the card", words.to(dev)),
                        ("host words", words)):
            out[f"ld_2d_scrambled, {n}, {mode}"] = rng_shape(
                intersect, f"ld_2d_scrambled, {n}, {mode}", "ld_2d", n,
                lambda: sampler.ld_2d_scrambled(idx, pix, w, 2),
                lambda: sampler.ld_2d_plain(idx, pix, w, 2))
    return out


def bsdf_lists(dev):
    """{name: (kinds, params_list)}: the cbox cells' four diffuse BSDFs
    (white, red, green and the light's black) and bunny_env's gold rough
    conductor (alpha 0.25), constant maps on the card."""
    def c(*v):
        return torch.tensor(v, dtype=torch.float32, device=dev).reshape(
            1, 1, -1)
    cbox = [{"reflectance": c(*v)} for v in ((0.95, 0.95, 0.95),
                                             (0.9, 0.2, 0.2), (0.2, 0.9, 0.2),
                                             (0.0, 0.0, 0.0))]
    gold = {"alpha_u": c(0.25), "alpha_v": c(0.25),
            "eta": c(0.2004, 0.9240, 1.1022), "k": c(3.9129, 2.4528, 2.1421),
            "specular_reflectance": c(1.0, 1.0, 1.0)}
    return {"cbox list": (("diffuse",) * 4, tuple(cbox)),
            "conductor": (("roughconductor",), (gold,))}


def bsdf_lanes(n, count, dev, seed):
    """n lanes on the card, all active: wi over the upper hemisphere
    (shading frames of camera hits), wo over the sphere (NEE directions,
    half below the horizon), uv and samples uniform, bsdf_id uniform over
    ``count`` BSDFs."""
    from psdr_tpu_torch.core.records import Intersection
    g = torch.Generator(device=dev).manual_seed(seed)

    def unit(upper):
        v = torch.randn((n, 3), device=dev, generator=g)
        v = v / v.norm(dim=1, keepdim=True)
        if upper:
            v[:, 2] = v[:, 2].abs()
        return v
    its = Intersection(
        valid=None, t=None, p=None, n=None, sh_frame=None,
        uv=torch.rand((n, 2), device=dev, generator=g), wi=unit(True),
        J=None, mesh_id=None, tri_id=None, emitter_id=None,
        bsdf_id=torch.randint(0, count, (n,), device=dev, generator=g,
                              dtype=torch.int32))
    return (its, unit(False), torch.rand((n, 3), device=dev, generator=g),
            torch.ones((n,), dtype=torch.bool, device=dev))


def bsdf_shape(intersect, name, mode, n, fn, plain):
    """One mode of the materials kernel on n lanes: ``fn()`` (the entry
    point under ``no_grad``) launched twice, each one launch of
    ``launches.bsdf`` and no call of the tensor code, both equal to
    ``plain()`` (its tensor code on the card on the same lanes) bit for
    bit; both timed (the kernel as 20 launches behind the spin kernel),
    with the kernel's bytes bound (BSDF_BYTES of ``mode``). Returns its
    dict."""
    def launch():
        before = (intersect.BSDF_LAUNCHES["bsdf"],
                  intersect.BSDF_PLAIN["plain"])
        with torch.no_grad():
            res = fn()
        if (intersect.BSDF_LAUNCHES["bsdf"] - before[0],
                intersect.BSDF_PLAIN["plain"] - before[1]) != (1, 0):
            raise AssertionError(f"phase 5: bsdf {name}: not one launch")
        return res

    def bits(r):
        return [t.view(torch.int32) if t.dtype == torch.float32 else t
                for t in (r if mode == "sample" else (r,))]
    got, again, want = launch(), launch(), plain()
    if not all(torch.equal(a, b) and torch.equal(a, c)
               for a, b, c in zip(bits(got), bits(again), bits(want))):
        raise AssertionError(f"phase 5: bsdf {name}: the kernel differs from "
                             "the tensor code or from itself")
    ms, _ = time_ms(launch, 20, spin=True)
    # the tensor code's best of two warmed timings: a first call at a new
    # size can grow the allocator's pool inside the timed launches
    plain_ms = min(time_ms(plain, 3)[0] for _ in range(2))
    b_ms, b_by = bound(n * BSDF_BYTES[mode], 0)
    log(f"  bsdf {name}: kernel = tensor code bit for bit and = itself; "
        f"{ms:.5f} ms (tensor code {plain_ms:.3f}), bound {b_ms:.5f} ms by "
        f"{b_by} ({b_ms / ms:.3f})")
    return {"elements": n, "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            "bound_share": b_ms / ms}


def bsdf_phase(intersect, dev):
    """Phase 5's materials kernel (``csrc/bsdf.cu``; no TPU kernel's port):
    each mode of the BSDF dispatch (``bsdf_shape``) at BSDF_SIZES lanes of
    the cbox list and of the conductor (``bsdf_lists``, ``bsdf_lanes``).
    Returns {shape: dict}; the first is the main shape."""
    from psdr_tpu_torch import bsdf
    entries = {"eval": (bsdf.eval_bsdf, bsdf.eval_bsdf_plain),
               "pdf": (bsdf.pdf_bsdf, bsdf.pdf_bsdf_plain),
               "sample": (bsdf.sample_bsdf, bsdf.sample_bsdf_plain)}
    out = {}
    for n in BSDF_SIZES:
        for list_name, (kinds, params) in bsdf_lists(dev).items():
            its, wo, s3, act = bsdf_lanes(n, len(kinds), dev, seed=n + 5)
            for mode, (fn, plain) in entries.items():
                args = (kinds, params, its, s3 if mode == "sample" else wo,
                        act)
                name = f"{mode}, {n}, {list_name}"
                out[name] = bsdf_shape(intersect, name, mode, n,
                                       lambda: fn(*args),
                                       lambda: plain(*args))
    return out


def grad_step(render, base, dev, key, image=False):
    """value_and_grad of mean(img^2) (the bench.py loss, target 0) with
    respect to every params leaf: (loss, [grad per leaf]), and the image
    last with ``image``."""
    from psdr_tpu_torch.convert import params_from_numpy
    p = params_from_numpy(base, device=dev, requires_grad=True)
    img = render(p, key)
    loss = torch.mean(img ** 2)
    loss.backward()
    leaves = [x for k in ("meshes", "bsdfs", "emitters", "sensors")
              for d in p[k] for x in d.values()]
    out = (loss.detach(), [x.grad for x in leaves])
    return (*out, img.detach()) if image else out


def grad_run(phase, make_scene, scene, integ, d, opts=None, tables=None,
             carry=None):
    """One device's run of a gradient check: the scene ``make_scene(
    **scene, device=d)`` with the ``RenderOptions`` fields ``opts``
    replaced; ``tables(integ, sc)`` builds guiding tables, and ``carry`` (a
    ``guiding_state``) then takes their place; value_and_grad of mean(img^2)
    through ``render_fn(with_boundary=...)`` at PRNGKey(7), and with
    boundary samples in ``scene`` each boundary term's image exactly zero.
    Returns (loss, [each leaf's gradient, flat numpy], the image as numpy
    (pixels, 3), the guiding state built on ``d`` or None)."""
    import dataclasses

    from psdr_tpu_torch.convert import params_from_numpy
    from psdr_tpu_torch.core import threefry
    boundary = scene.get("sppe", 0) > 0 or scene.get("sppse", 0) > 0
    sc = make_scene(**scene, device=d)
    if opts:
        sc.opts = dataclasses.replace(sc.opts, **opts)
    state = None
    if tables is not None:
        tables(integ, sc)
        state = guiding_state(integ)
        if carry is not None:
            carry_tables(integ, carry, d)
    render = integ.render_fn(sc, with_boundary=boundary)
    loss, g, img = grad_step(render, sc.params(), d, threefry.PRNGKey(7),
                             image=True)
    if boundary:
        with torch.no_grad():
            flat = sc.build(params_from_numpy(sc.params(), device=d))
            for name, term in (("primary", integ.render_primary_edges),
                               ("secondary", integ.render_secondary_edges)):
                t_img = term(sc, flat, 0, threefry.PRNGKey(7))
                if (t_img.shape != (sc.opts.num_pixels, 3)
                        or bool(t_img.any())):
                    raise AssertionError(
                        f"phase {phase}: the {name}-edge image is not "
                        f"exactly zero on {d}")
    return (float(loss), [x.cpu().numpy().ravel() for x in g],
            img.cpu().numpy().reshape(-1, 3), state)


def grad_compare(phase, runs, boundary, images=False):
    """Two card runs and a CPU run of ``grad_run`` under phase 10's bounds:
    the loss within 1e-5 relative, each leaf finite on the card and within
    GRAD_REL_L2 relative L2 of the CPU's plus the card's run-to-run spread
    (0 since the sums are fixed-order), cosine GRAD_COS; with ``images``
    the card's image against the CPU's under phase 4's gates. Returns the
    largest relative L2 difference of a leaf."""
    (l_a, g_a, img_a, _), (_, g_b, _, _), (l_c, g_c, img_c, _) = runs

    def rel(x, y):
        ny = np.linalg.norm(y)
        return 0.0 if ny == 0 and np.linalg.norm(x) == 0 else float(
            np.linalg.norm(x - y) / ny)

    spread = max(rel(a, b) for a, b in zip(g_a, g_b))
    tol = GRAD_REL_L2 + spread
    worst, worst_cos = 0.0, 1.0
    for i, (a, c) in enumerate(zip(g_a, g_c)):
        if not np.isfinite(a).all():
            raise AssertionError(f"phase {phase}: leaf {i} not finite on "
                                 "the card")
        r = rel(a, c)
        worst = max(worst, r)
        if np.linalg.norm(c) > 0:
            worst_cos = min(worst_cos, float(a @ c) / (
                np.linalg.norm(a) * np.linalg.norm(c)))
    loss_rel = abs(l_a - l_c) / l_c
    log(f"  loss card {l_a:.8f} / CPU {l_c:.8f} (relative {loss_rel:.3g}); "
        f"card run-to-run spread {spread:.3g}; card vs CPU per "
        f"leaf: worst relative L2 {worst:.3g} (bound {GRAD_REL_L2} + spread "
        f"= {tol:.3g}), worst cosine {worst_cos:.7f} (bound {GRAD_COS})")
    if images:
        image_gate(phase, "card and CPU images", img_a, img_c)
    if loss_rel > 1e-5 or worst > tol or worst_cos < GRAD_COS:
        raise AssertionError(f"phase {phase}: card and CPU gradients "
                             "disagree")
    if boundary:
        log("  the primary- and the secondary-edge image are exactly zero "
            "on the card and on the CPU")
    return worst


def rough_env(**kw):
    """Phase 17's env_scene under a rough conductor."""
    from psdr_tpu_torch import RoughConductor
    from psdr_tpu_torch.testing.scenes import env_scene
    return env_scene(RoughConductor(alpha_u=0.3, alpha_v=0.2), **kw)


def textured(**kw):
    """Phase 17's textured quad, an 8x8 texture from a seed."""
    from psdr_tpu_torch.testing.scenes import textured_quad_scene
    tex = np.random.default_rng(10).uniform(
        0.1, 0.9, (8, 8, 3)).astype(np.float32)
    return textured_quad_scene(tex, **kw)


def grad_checks():
    """The gradient checks of phases 8, 10, 13 and 17, card against CPU:
    {key: (phase, scene maker, scene, integrator maker)}."""
    from psdr_tpu_torch import DirectIntegrator, PathTracer
    from psdr_tpu_torch.testing.scenes import cbox_scene
    return {
        "8": (8, cbox_scene, SMALL, lambda: DirectIntegrator(1, 1)),
        "10": (10, cbox_scene, SMALL_BOUNDARY,
               lambda: DirectIntegrator(1, 1)),
        "13 interior": (13, cbox_scene, SMALL, lambda: PathTracer(3)),
        "13 boundary": (13, cbox_scene, SMALL_BOUNDARY,
                        lambda: PathTracer(max_depth=2, camera_depth=2)),
        "17 rough interior": (17, rough_env, ENV_SMALL, lambda: PathTracer(2)),
        "17 rough boundary": (17, rough_env, ENV_SMALL_BOUNDARY,
                              lambda: PathTracer(2)),
        "17 textured": (17, textured, ENV_SMALL,
                        lambda: DirectIntegrator(1, 1)),
    }


def accel_scene(mode):
    """Phase 30's scene maker: ``cbox_scene`` under ``Scene.accel_mode``
    ``mode``."""
    def make(**kw):
        from psdr_tpu_torch.testing.scenes import cbox_scene
        sc = cbox_scene(**kw)
        sc.accel_mode = mode
        return sc
    return make


def render_checks():
    """The renders of phases 4, 17 and 30, card against CPU (``renderC`` at
    seed 7): {key: (scene maker, scene, integrator maker)}."""
    from psdr_tpu_torch import DirectIntegrator, FieldExtractionIntegrator
    from psdr_tpu_torch.scene.scene import ACCEL_MODES
    from psdr_tpu_torch.testing.scenes import cbox_scene
    return {
        "4": (cbox_scene, SMALL, lambda: DirectIntegrator(1, 1)),
        "17 rough": (rough_env, ENV_SMALL, lambda: DirectIntegrator(1, 1)),
        "17 textured": (textured, ENV_SMALL, lambda: DirectIntegrator(1, 1)),
        **{f"17 AOV {field}": (cbox_scene, AOV,
                               lambda f=field: FieldExtractionIntegrator(f))
           for field in AOV_FIELDS},
        **{f"30 {mode}": (accel_scene(mode), SMALL,
                          lambda: DirectIntegrator(1, 1))
           for mode in ACCEL_MODES}}


def render_run(make_scene, scene, integ, d) -> np.ndarray:
    """``renderC`` of ``make_scene(**scene, device=d)`` at seed 7, as numpy
    (pixels, 3)."""
    return integ.renderC(make_scene(**scene, device=d), seed=7).cpu() \
        .numpy().reshape(-1, 3)


def grad_phase(dev, reference, key):
    """Phases 8, 10, 13 and 17: the gradient check ``grad_checks()[key]``,
    ``make_scene(**scene, device=...)`` under the integrator, on the card
    (twice, to read its run-to-run spread, which is 0 since the sums are
    fixed-order) against the CPU's run from ``reference`` (a
    ``CpuReference``), the same key (``grad_run``, ``grad_compare``); with
    boundary samples in ``scene``, through ``render_fn(with_boundary=
    True)``, and each boundary term's image must be exactly zero on both
    devices. The comparison waits for the CPU's run in phase 34
    (``CpuReference.later``)."""
    phase, make_scene, scene, integ = grad_checks()[key]
    boundary = scene.get("sppe", 0) > 0 or scene.get("sppse", 0) > 0
    integ = integ()
    runs = [grad_run(phase, make_scene, scene, integ, dev) for _ in range(2)]
    reference.later(phase, f"the gradient {key}", f"grad {key}",
                    lambda cpu: grad_compare(phase, runs + [cpu], boundary))


def grad_match(dev, phase, scene, integ, make_scene=None):
    """A gradient check of phases 23 and 24, both sides in this process:
    ``grad_run`` on the card twice and on the CPU, ``grad_compare``."""
    from psdr_tpu_torch.testing.scenes import cbox_scene
    make_scene = make_scene or cbox_scene
    boundary = scene.get("sppe", 0) > 0 or scene.get("sppse", 0) > 0
    runs = [grad_run(phase, make_scene, scene, integ, d)
            for d in (dev, dev, torch.device("cpu"))]
    return grad_compare(phase, runs, boundary)


def guiding_phase(dev):
    """Phase 11: ``preprocess_secondary_edges`` at GUIDING's size on the
    card (twice: the first call warms up, the second is timed) against the
    CPU: the cell masses within rtol 1e-4 (atol 1e-4 of the largest cell:
    the per-cell sums add in one fixed order on both, but the lanes'
    values round apart between the card's ops and the CPU's). Then one guided
    boundary step on the card under that table: every leaf finite, the
    gradient unlike the unguided one."""
    from psdr_tpu_torch import DirectIntegrator
    from psdr_tpu_torch.core import threefry
    from psdr_tpu_torch.testing.scenes import cbox_scene
    masses, integs = [], []
    for d in (dev, dev, torch.device("cpu")):
        sc = cbox_scene(**SMALL_BOUNDARY, device=d)
        integ = DirectIntegrator(1, 1)
        t0 = time.perf_counter()
        integ.preprocess_secondary_edges(sc, 0, **GUIDING)
        if d.type == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        masses.append((integ.warpper[0].distrb.pmf.cpu().numpy(), dt))
        integs.append((sc, integ))
    (_, t_warm), (m_card, t_card), (m_cpu, t_cpu) = masses
    n_cells = int(np.prod(GUIDING["reso"][:3]))
    lanes = n_cells * GUIDING["reso"][3]
    log(f"  {n_cells} cells x {GUIDING['reso'][3]} samples x "
        f"{GUIDING['nrounds']} rounds ({lanes} lanes a round): card "
        f"{t_card:.3f} s (first call {t_warm:.3f} s), CPU {t_cpu:.3f} s; "
        f"{int((m_card > 0).sum())} cells with mass; largest |card - CPU| "
        f"{np.abs(m_card - m_cpu).max():.3g} of a largest cell "
        f"{m_cpu.max():.3g}")
    if m_card.shape != (n_cells,) or not (m_card > 0).any():
        raise AssertionError("phase 11: no cell got any mass")
    np.testing.assert_allclose(m_card, m_cpu, rtol=1e-4,
                               atol=1e-4 * m_cpu.max(),
                               err_msg="phase 11: card and CPU masses differ")
    sc, guided = integs[1]
    key = threefry.PRNGKey(7)
    _, g_guided = grad_step(guided.render_fn(sc, with_boundary=True),
                            sc.params(), dev, key)
    _, g_plain = grad_step(DirectIntegrator(1, 1).render_fn(
        sc, with_boundary=True), sc.params(), dev, key)
    if not all(bool(torch.isfinite(g).all()) for g in g_guided):
        raise AssertionError("phase 11: a guided leaf is not finite")
    moved = max(float((a - b).abs().max()) for a, b in zip(g_guided, g_plain))
    log(f"  guided boundary step on the card: every leaf finite; largest "
        f"|guided - unguided| entry {moved:.3g}")
    if not moved > 0.0:
        raise AssertionError("phase 11: guiding changed no gradient")
    return t_card


def guiding_state(integ) -> dict:
    """The guiding tables ``integ`` holds as numpy, ``{(attribute,
    sensor): (resolution, pmf, cmf)}``: the secondary-edge ones
    (``warpper``) and the PathTracer's indirect ones (``ind_warpper``)."""
    return {(attr, k): (hc.resolution, host(hc.distrb.pmf),
                        host(hc.distrb.cmf))
            for attr in ("warpper", "ind_warpper")
            for k, hc in getattr(integ, attr, {}).items()}


def tables_match(phase, mine, theirs):
    """Two devices' guiding tables (``guiding_state``s): the same tables,
    their masses within rtol 1e-4 (atol 1e-4 of the largest cell), as
    phase 11."""
    if mine.keys() != theirs.keys():
        raise AssertionError(f"phase {phase}: tables {sorted(mine)} on the "
                             f"card, {sorted(theirs)} on the CPU")
    for key, (reso, pmf, _) in mine.items():
        ref = theirs[key][1]
        np.testing.assert_allclose(
            pmf, ref, rtol=1e-4, atol=1e-4 * ref.max(),
            err_msg=f"phase {phase}: card and CPU masses of {key} differ")
        log(f"  {key[0]}[{key[1]}] {reso}: {int((pmf > 0).sum())} of "
            f"{pmf.size} cells with mass, card = CPU within rtol 1e-4")


def carry_tables(integ, state, device):
    """Put the tables of ``state`` (a ``guiding_state``, cmf and all) into
    ``integ`` on ``device``, so that it draws the other device's
    samples."""
    from psdr_tpu_torch.convert import hypercube_from_numpy
    for (attr, k), (reso, pmf, cmf) in state.items():
        getattr(integ, attr)[k] = hypercube_from_numpy(reso, pmf, cmf,
                                                       device=device)


def counted(intersect) -> dict:
    """The launches counted since the last ``reset_launch_counts``: K1-K3
    and segsum (``intersect.LAUNCHES``), the random stream's kernels
    (``launches.rng``) and the materials kernel (``launches.bsdf``)."""
    return {**dict(intersect.LAUNCHES), **dict(intersect.RNG_LAUNCHES),
            **dict(intersect.BSDF_LAUNCHES)}


def require_launches(phase, launches):
    """A render path's run must have launched K1 in both modes and K2, and
    K3, which is off the render path, not at all."""
    if launches["closest"] == 0 or launches["any"] == 0 or launches["k2"] == 0:
        raise AssertionError(f"phase {phase}: K1 (both modes) and K2 must "
                             f"launch ({launches})")
    if launches["k3"] != 0:
        raise AssertionError(f"phase {phase}: K3 is off the render path, yet "
                             f"it launched ({launches})")


def timed_steps(intersect, render, base, dev, first_key=0, n_steps=3):
    """One warm-up step with PRNGKey(first_key), the peak-memory mark and
    the launch counts set to 0, then ``n_steps`` timed steps with the next
    keys (host clock around a synchronize). Returns (seconds per step, the
    last step's loss and gradients, the launch counts, peak bytes)."""
    from psdr_tpu_torch.core import threefry
    grad_step(render, base, dev, threefry.PRNGKey(first_key))     # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    intersect.reset_launch_counts()
    times = []
    for i in range(n_steps):
        t0 = time.perf_counter()
        loss, grads = grad_step(render, base, dev,
                                threefry.PRNGKey(first_key + 1 + i))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return (times, loss, grads, dict(intersect.LAUNCHES),
            torch.cuda.max_memory_allocated())


def device_work(prof):
    """The card's work in the trace of ``prof`` (a finished
    ``torch.profiler.profile``), read from its raw events: ({kernel or copy
    name: (launches, device ms)}, the host's launch calls:
    ``cudaLaunchKernel``, ``cuLaunchKernel``, ``cudaGraphLaunch`` and their
    kind). ``key_averages()`` would first build the host's event tree, which
    takes about a second for every few thousand events: longer than the
    frame it describes."""
    kern, calls = {}, 0
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if str(e.device_type()).endswith("CUDA"):
            n, ns = kern.get(name, (0, 0))
            kern[name] = (n + 1, ns + e.duration_ns())
        elif "Launch" in name and name.startswith("cu"):
            calls += 1
    return {k: (n, ns / 1e6) for k, (n, ns) in kern.items()}, calls


def top_kernels(kern):
    """The ten entries of ``device_work``'s kernels with the most device
    time: [(name, (launches, ms))]."""
    return sorted(kern.items(), key=lambda kv: -kv[1][1])[:10]


def profile_step(fn, label):
    """One profiled run of ``fn``: wall and device-busy ms, idle share, the
    intersection kernels' and the ``index_add_`` kernels' device ms and the
    top kernels, logged. Returns (the ten top kernels' names, device-busy
    ms, the ``index_add_`` kernels' ms)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kern, _ = device_work(prof)
    busy = sum(ms for _, ms in kern.values())
    mine = {name: sum(ms for k, (_, ms) in kern.items() if name in k)
            for name in ("k1_kernel", "k2_kernel", "k3_kernel")}
    adds = [v for k, v in kern.items()
            if "indexFunc" in k or "index_add" in k]
    adds_ms = sum(ms for _, ms in adds)
    log(f"  profiled {label}: wall {wall:.1f} ms, device busy {busy:.1f} ms "
        f"(idle {1 - busy / wall:.3f} of wall), K1 {mine['k1_kernel']:.2f} "
        f"ms, K2 {mine['k2_kernel']:.3f} ms, index_add kernels "
        f"{adds_ms:.2f} ms in {sum(n for n, _ in adds)} launches, "
        f"{sum(n for n, _ in kern.values())} kernel launches; top kernels:")
    top = top_kernels(kern)
    for k, (n, ms) in top:
        log(f"    {ms:9.2f} ms {n:6d}x  {k[:100]}")
    return [k for k, _ in top], busy, adds_ms


def forward_phase(intersect, dev, integ, phase, rays_per_sample, sc=None,
                  profile=True):
    """Phases 5, 14, 18, 21 and 24: the forward of ``integ`` on ``sc``
    (default: the bench scene at bench.py's config): one warm-up frame,
    three timed frames (host clock around a synchronize), then, with
    ``profile``, one profiled frame (phases 21 and 24, which repeat phase
    5's and 18's configurations, skip it). Returns (the launch counts of the three timed frames, the last frame's
    image mean, the median frame seconds)."""
    from psdr_tpu_torch.core import threefry
    from psdr_tpu_torch.testing.scenes import cbox_scene
    sc = sc or cbox_scene(**BENCH, device=dev)
    opts = sc.opts
    render = integ.render_fn(sc, with_boundary=False, detached=True)
    params = sc.params()
    img = render(params, threefry.PRNGKey(0))            # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    intersect.reset_launch_counts()
    times = []
    for i in range(3):
        t0 = time.perf_counter()
        img = render(params, threefry.PRNGKey(i + 1))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = dict(intersect.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    img = img.cpu().numpy()
    if (img.shape != (opts.num_pixels, 3) or not np.isfinite(img).all()):
        raise AssertionError(f"phase {phase}: image not finite or misshapen")
    if not img.mean() > 0.0:
        raise AssertionError(f"phase {phase}: image mean is not positive")
    require_launches(phase, launches)
    rays = opts.num_pixels * opts.spp * rays_per_sample
    dt = float(np.median(times))
    log(f"  frames {', '.join(f'{t:.3f}' for t in times)} s; median {dt:.3f}"
        f" s -> {rays / dt / 1e6:.2f} M rays/s ({rays_per_sample} rays a "
        f"sample); image mean {img.mean():.6f}; peak memory "
        f"{peak / 2**30:.2f} GiB; launches over 3 frames {launches}")
    # where the time goes: one profiled frame, device time by kernel
    if profile:
        profile_step(lambda: render(params, threefry.PRNGKey(9)), "frame")
    return launches, float(img.mean()), dt


def backward_phase(intersect, dev, integ, phase=9, sc=None):
    """Phases 9, 15 and 19: the backward of ``integ`` on ``sc`` (default:
    the bench scene at bench.py's config). Returns (the launch counts of
    the three timed steps, the profiled step's ten top kernels)."""
    from psdr_tpu_torch.core import threefry
    from psdr_tpu_torch.testing.scenes import cbox_scene
    sc = sc or cbox_scene(**BWD, device=dev)
    render = integ.render_fn(sc, with_boundary=False)
    base = sc.params()
    log(f"  remat: {sc.opts.remat_passes!r} -> "
        f"{sc.opts.resolve_remat(sc.opts.num_pixels * sc.opts.spp)} at "
        f"{sc.opts.num_pixels * sc.opts.spp} lanes")
    times, loss, grads, launches, peak = timed_steps(intersect, render, base,
                                                     dev)
    bad = [i for i, g in enumerate(grads)
           if g is None or not bool(torch.isfinite(g).all())]
    if bad or not bool(torch.isfinite(loss)) or not float(loss) > 0.0:
        raise AssertionError(f"phase {phase}: loss {float(loss)}, leaves "
                             f"without a finite gradient: {bad}")
    require_launches(phase, launches)
    dt = float(np.median(times))
    samples = sc.opts.num_pixels * sc.opts.spp
    log(f"  steps {', '.join(f'{t:.3f}' for t in times)} s; median {dt:.3f} "
        f"s -> {samples / dt / 1e6:.3f} M grad-samples/s; loss "
        f"{float(loss):.6f}; {len(grads)} leaves, all finite; peak memory "
        f"{peak / 2**30:.2f} GiB; launches over 3 steps {launches}")
    top, _, _ = profile_step(lambda: grad_step(render, base, dev,
                                               threefry.PRNGKey(9)), "step")
    return launches, top


def boundary_phase(intersect, dev):
    """Phase 12: the boundary step at scripts/bench_renderD.py's config.
    Returns (the launch counts of the three timed steps, {shape: dict} of
    K1 at this path's shapes, the same of K2, {mode: [(max |dt|, valid
    mismatches), ...]} of those comparisons with K2's under "k2")."""
    import dataclasses

    from psdr_tpu_torch import DirectIntegrator
    from psdr_tpu_torch.core import threefry
    from psdr_tpu_torch.testing.scenes import cbox_scene
    sc = cbox_scene(**RENDERD, device=dev)
    opts = sc.opts
    integ = DirectIntegrator(1, 1)
    base = sc.params()
    render = integ.render_fn(sc, with_boundary=True)
    lanes = {t: opts.num_pixels * getattr(opts, t)
             for t in ("spp", "sppe", "sppse")}
    log(f"  lanes a step: interior {lanes['spp']}, primary edges "
        f"{lanes['sppe']} (x2 rays), secondary edges {lanes['sppse']}; "
        f"pass_lanes {opts.pass_lanes}; remat "
        f"{[opts.resolve_remat(v) for v in lanes.values()]}")
    times, loss, grads, launches, peak = timed_steps(intersect, render, base,
                                                     dev)
    bad = [i for i, g in enumerate(grads)
           if g is None or not bool(torch.isfinite(g).all())]
    if bad or not bool(torch.isfinite(loss)) or not float(loss) > 0.0:
        raise AssertionError(f"phase 12: loss {float(loss)}, leaves without "
                             f"a finite gradient: {bad}")
    require_launches(12, launches)
    # the interior-only gradient of the last step's key: same loss, another
    # gradient
    nb_loss, nb_grads = grad_step(integ.render_fn(sc, with_boundary=False),
                                  base, dev, threefry.PRNGKey(3))
    rel = [float((a - b).norm() / b.norm()) for a, b in zip(grads, nb_grads)
           if float(b.norm()) > 0]
    if (abs(float(nb_loss) - float(loss)) > 1e-6 * float(loss)
            or not max(rel) > 1e-3):
        raise AssertionError(
            f"phase 12: loss {float(loss)} / interior-only {float(nb_loss)}"
            f"; the boundary terms moved no leaf by more than {max(rel)}")
    dt = float(np.median(times))
    samples = opts.num_pixels * (opts.spp + opts.sppe + opts.sppse)
    log(f"  steps {', '.join(f'{t:.3f}' for t in times)} s; median {dt:.3f} "
        f"s -> {samples / dt / 1e6:.3f} M grad-samples/s (pixels x (spp + "
        f"sppe + sppse)); loss {float(loss):.6f}; {len(grads)} leaves, all "
        f"finite; boundary terms move a leaf by up to {max(rel):.3g} "
        f"relative L2 (median leaf {float(np.median(rel)):.3g}); peak memory "
        f"{peak / 2**30:.2f} GiB; launches over 3 steps {launches}")
    profile_step(lambda: grad_step(render, base, dev, threefry.PRNGKey(9)),
                 "boundary step")
    # the split by term, as the script's probes: each term off in turn
    for label, off in (("sppe 0", dict(sppe=0)), ("sppse 0", dict(sppse=0)),
                       ("interior only", dict(sppe=0, sppse=0))):
        sc_t = cbox_scene(**RENDERD, device=dev)
        sc_t.opts = dataclasses.replace(sc_t.opts, **off)
        t_times = timed_steps(
            intersect,
            DirectIntegrator(1, 1).render_fn(sc_t, with_boundary=True),
            base, dev, first_key=20)[0]
        log(f"  {label}: steps {', '.join(f'{t:.3f}' for t in t_times)} s; "
            f"median {float(np.median(t_times)):.3f} s")
    k1_shapes, k2_shapes, err, _ = boundary_shapes(intersect, sc, dev)
    return launches, k1_shapes, k2_shapes, err


def boundary_shapes(intersect, sc, dev, warp=None, tally=None):
    """K1 and K2 at the boundary step's shapes, each compared with its
    plain version, timed, and counted for its bound: the concatenated -/+
    camera sweep of one primary-edge chunk (K1 closest), and on the
    compacted wavefront of one secondary-edge chunk the emitter-first sweep
    (K2), its occlusion sweep (K1 any) and the opposite closest hit (K1
    closest). The rays are made as ``render_primary_edges`` and
    ``render_secondary_edges`` make them. With ``warp`` (a guiding table)
    only the secondary-edge chunk, its samples warped by the table and
    compacted at the guided keep, as ``_boundary_pass`` does, the shapes
    named "guided ...", and K1 held through ``tolerant`` (its lanes unlike
    ``k1_plain`` counted into ``tally``). Returns ({shape: dict} of K1, the
    same of K2, {mode: [(max |dt|, valid mismatches), ...]} with K2's under
    "k2", the share of the secondary-edge chunk's lanes that are valid)."""
    from psdr_tpu_torch.core.constants import ShadowEpsilon
    from psdr_tpu_torch.core.math import normalize
    from psdr_tpu_torch.core.records import Ray
    from psdr_tpu_torch.integrator.direct import (_compact_boundary_lanes,
                                                  _compact_eligibility,
                                                  _emitter_meta)
    from psdr_tpu_torch.scene.scene import (detach_flat,
                                            sample_boundary_segment_direct)
    err = {"closest": [], "any": [], "k2": []}
    k1_shapes, k2_shapes = {}, {}
    guided = "" if warp is None else "guided "
    with torch.no_grad():
        flat = detach_flat(sc.build(sc.params()))
        tris = (flat.tri.p0, flat.tri.e1, flat.tri.e2)
        compare = (comparer(err, tris) if warp is None
                   else tolerant(intersect, err, tris, tally))
        if warp is None:
            primary_edge_shape(intersect, sc, flat, dev, compare, k1_shapes)
        # one secondary-edge chunk, compacted
        sample3, bss_v, rng = secondary_chunk(sc, flat, dev, warp)
        m = bss_v.numel()
        s, ks = _compact_eligibility(m, guided=warp is not None)
        idx, weight, live = _compact_boundary_lanes(
            bss_v, sample3[:, 0], rng.next_1d(m), s, ks)
        bss = sample_boundary_segment_direct(
            flat, sc.face_offset, _emitter_meta(sc), sample3[idx],
            torch.ones_like(idx, dtype=torch.bool))
        share = float(bss_v.float().mean())
        log(f"  {guided}secondary edges: {int(flat.sec_edge.valid.sum())} "
            f"candidate edges of {flat.sec_edge.valid.numel()}; "
            f"{int(bss_v.sum())} of {m} lanes valid ({share:.4f}); segments "
            f"of {s} keep {ks}: {idx.numel()} lanes, {int(live.sum())} live, "
            f"largest weight {float(weight.max()):.3f}")
        p0 = bss.p0.contiguous()
        direction = normalize(bss.p2 - p0).contiguous()
        idxs = flat.em_tri_idx
        inf = torch.full((idx.numel(),), float("inf"), device=dev)
        k2_args = (*(x[idxs].contiguous() for x in (flat.tri.p0, flat.tri.e1,
                                                    flat.tri.e2)),
                   p0, direction, bss.valid, inf)
        name = f"{guided}secondary-edge emitter-first sweep, compacted"
        e, k2_shapes[name] = k2_timed(intersect, k2_args, name,
                                      f"{idx.numel()} segment rays")
        err["k2"].append(e)
        hit_e = intersect.k2_cuda(*k2_args)
        valid_e = hit_e.valid & bss.valid
        tmax = torch.where(valid_e, hit_e.t, 0.0) - ShadowEpsilon
        name = f"{guided}secondary-edge occlusion sweep, compacted"
        k1_shapes[name] = k1_shape(
            intersect, name, True,
            k1_args(flat, Ray(p0, direction), valid_e, tmax), compare)
        name = f"{guided}secondary-edge opposite closest hit, compacted"
        k1_shapes[name] = k1_shape(
            intersect, name, False,
            k1_args(flat, Ray(p0, -direction), valid_e, None), compare)
    return k1_shapes, k2_shapes, err, share


def primary_edge_shape(intersect, sc, flat, dev, compare, k1_shapes):
    """K1 on the concatenated -/+ camera sweep of one primary-edge chunk
    of ``sc`` (``boundary_shapes``), into ``k1_shapes``."""
    from psdr_tpu_torch.core import threefry
    from psdr_tpu_torch.core.records import Ray
    from psdr_tpu_torch.core.sampler import RngStream
    from psdr_tpu_torch.sensor.perspective import sample_primary_edge
    opts = sc.opts
    m = min(max(1, opts.pass_lanes // 2), opts.num_pixels * opts.sppe)
    rng = RngStream(threefry.PRNGKey(11), salt=1, device=dev)
    pes = sample_primary_edge(flat.sensors[0],
                              torch.sort(rng.next_1d(m)).values)
    valid = pes.idx >= 0
    edges = flat.sensors[0].edges
    log(f"  primary edges: {int(edges.valid.sum())} silhouette edges of "
        f"{edges.valid.numel()}; {int(valid.sum())} of {m} lanes valid")
    rays = Ray(torch.cat([pes.ray_n.o, pes.ray_p.o]),
               torch.cat([pes.ray_n.d, pes.ray_p.d]))
    name = "primary-edge -/+ camera sweep"
    k1_shapes[name] = k1_shape(
        intersect, name, False,
        k1_args(flat, rays, torch.cat([valid, valid]), None), compare)


def path_forward_shapes(intersect, dev):
    """K1 and K2 on the later bounces of phase 14's first chunk
    (``tiled_path_rays``: 2^21 lanes in tile order, spp 64), each compared
    with its plain version, timed, and counted for its bound: the depth-2
    bounce (K1 closest), the depth-2 and depth-3 shadow sweeps (K1 any) and
    the depth-3 emitter-first sweep (K2). Returns ({shape: dict} of K1, the
    same of K2, {mode: [(max |dt|, valid mismatches), ...]} with K2's under
    "k2")."""
    from psdr_tpu_torch.testing.scenes import tiled_path_rays
    err = {"closest": [], "any": [], "k2": []}
    sc, flat = bench_scene(dev)
    compare = comparer(err, (flat.tri.p0, flat.tri.e1, flat.tri.e2))
    sweeps = tiled_path_rays(sc, flat, N_TIME, BENCH["spp"], 2, depth=3)
    k1_shapes = {}
    for name, any_hit in (("depth 2 bounce", False), ("depth 2 shadow", True),
                          ("depth 3 shadow", True)):
        label = f"path {name} sweep"
        k1_shapes[label] = k1_shape(intersect, label, any_hit,
                                    k1_args(flat, *sweeps[name]), compare,
                                    PLAIN_RAYS)
    bounce, alive, _ = sweeps["depth 3 bounce"]
    idxs = flat.em_tri_idx
    args = (*(x[idxs].contiguous() for x in (flat.tri.p0, flat.tri.e1,
                                             flat.tri.e2)),
            bounce.o.contiguous(), bounce.d.contiguous(), alive,
            torch.full((N_TIME,), float("inf"), device=dev))
    name = "path depth 3 emitter-first sweep"
    e, timed = k2_timed(intersect, args, name, f"{N_TIME} bounce rays")
    err["k2"].append(e)
    return k1_shapes, {name: timed}, err


def path_boundary_phase(intersect, dev):
    """Phase 16: the full boundary step of ``PathTracer(max_depth=2,
    camera_depth=2)`` at scripts/bench_renderD.py's config (the fused
    pass), the same step with ``PSDR_TPU_FUSED_BOUNDARY=0`` beside it, and
    K1 on the direction side's compacted wavefront. Returns (the launch
    counts of the three timed fused steps, {shape: dict} of K1 at this
    path's shapes, {mode: [(max |dt|, valid mismatches), ...]})."""
    from psdr_tpu_torch import PathTracer
    from psdr_tpu_torch.core import threefry
    from psdr_tpu_torch.testing.scenes import cbox_scene
    sc = cbox_scene(**RENDERD, device=dev)
    opts = sc.opts
    integ = PathTracer(max_depth=2, camera_depth=2)
    base = sc.params()
    render = integ.render_fn(sc, with_boundary=True)
    samples = opts.num_pixels * (opts.spp + opts.sppe + opts.sppse)

    def steps(label):
        times, loss, grads, launches, peak = timed_steps(intersect, render,
                                                         base, dev)
        bad = [i for i, g in enumerate(grads)
               if g is None or not bool(torch.isfinite(g).all())]
        if bad or not bool(torch.isfinite(loss)) or not float(loss) > 0.0:
            raise AssertionError(f"phase 16 ({label}): loss {float(loss)}, "
                                 f"leaves without a finite gradient: {bad}")
        require_launches(16, launches)
        dt = float(np.median(times))
        log(f"  {label}: steps {', '.join(f'{t:.3f}' for t in times)} s; "
            f"median {dt:.3f} s -> {samples / dt / 1e6:.3f} M grad-samples/s "
            f"(pixels x (spp + sppe + sppse)); loss {float(loss):.6f}; "
            f"{len(grads)} leaves, all finite; peak memory "
            f"{peak / 2**30:.2f} GiB; launches over 3 steps {launches}")
        return loss, grads, launches

    if os.environ.get("PSDR_TPU_FUSED_BOUNDARY", "1") != "1":
        raise AssertionError("phase 16 needs PSDR_TPU_FUSED_BOUNDARY unset")
    loss, grads, launches = steps("fused")
    # the interior-only gradient of the last step's key: same loss (the
    # boundary terms are zero in the primal), another gradient
    nb_loss, nb_grads = grad_step(integ.render_fn(sc, with_boundary=False),
                                  base, dev, threefry.PRNGKey(3))
    rel = [float((a - b).norm() / b.norm()) for a, b in zip(grads, nb_grads)
           if float(b.norm()) > 0]
    if (abs(float(nb_loss) - float(loss)) > 1e-6 * float(loss)
            or not max(rel) > 1e-3):
        raise AssertionError(
            f"phase 16: loss {float(loss)} / interior-only {float(nb_loss)}"
            f"; the boundary terms moved no leaf by more than {max(rel)}")
    log(f"  the boundary terms move a leaf by up to {max(rel):.3g} relative "
        f"L2 (median leaf {float(np.median(rel)):.3g})")
    top, _, _ = profile_step(lambda: grad_step(render, base, dev,
                                               threefry.PRNGKey(9)),
                             "fused boundary step")
    if any("indexing_backward" in k for k in top):
        raise AssertionError("phase 16: an indexing_backward kernel is among "
                             "the step's top ten")
    with switches({"PSDR_TPU_FUSED_BOUNDARY": "0"}):
        steps("separate passes (PSDR_TPU_FUSED_BOUNDARY=0)")
    k1_shapes, err = path_boundary_shapes(intersect, sc, dev)
    return launches, k1_shapes, err


def path_boundary_shapes(intersect, sc, dev):
    """The compacted wavefronts of one chunk of phase 16's fused passes, made
    as ``_boundary_pass`` makes them: the valid lanes of those drawn and the
    largest compaction weight of the emitter side (salt 2) and the direction
    side (salt 3), and K1 (closest) on the direction side's far trace and
    anchor trace, each compared with its plain version, timed and counted.
    (The emitter side's traces are phase 12's shapes.)"""
    from psdr_tpu_torch import PathTracer
    from psdr_tpu_torch.core import threefry
    from psdr_tpu_torch.core.records import Ray
    from psdr_tpu_torch.core.sampler import RngStream
    from psdr_tpu_torch.integrator.direct import (_compact_boundary_lanes,
                                                  _compact_eligibility)
    from psdr_tpu_torch.integrator.path import _sample_edge_direction
    from psdr_tpu_torch.scene.scene import detach_flat
    opts = sc.opts
    err = {"closest": [], "any": []}
    k1_shapes = {}
    with torch.no_grad():
        flat = detach_flat(sc.build(sc.params()))
        compare = comparer(err, (flat.tri.p0, flat.tri.e1, flat.tri.e2))
        m = min(opts.pass_lanes, opts.num_pixels * opts.sppse)
        s, ks = _compact_eligibility(m)
        live_all = torch.ones((m,), dtype=torch.bool, device=dev)
        for far, salt in (("emitter", 2), ("direction", 3)):
            rng = RngStream(threefry.PRNGKey(12), salt=salt, device=dev)
            sample3 = rng.next_3d(m)
            sample3 = sample3[torch.argsort(sample3[:, 0], stable=True)]
            v = PathTracer._prepass_valid(sc, flat, far)(sample3, live_all)
            idx, weight, live = _compact_boundary_lanes(
                v, sample3[:, 0], rng.next_1d(m), s, ks)
            log(f"  {far} side: {int(v.sum())} of {m} lanes valid "
                f"({float(v.float().mean()):.4f}); segments of {s} keep {ks}: "
                f"{idx.numel()} lanes, {int(live.sum())} live, largest "
                f"weight {float(weight.max()):.3f}")
        # the direction side's wavefront (the loop's last)
        eds = _sample_edge_direction(flat, sample3[idx])
        p0, d = eds.p0.contiguous(), eds.d.contiguous()
        name = "direction-side far trace, compacted"
        args = k1_args(flat, Ray(p0, d), eds.valid, None)
        k1_shapes[name] = k1_shape(intersect, name, False, args,
                                   compare)
        far_hit = intersect.k1_cuda(*args)
        name = "direction-side anchor trace, compacted"
        k1_shapes[name] = k1_shape(
            intersect, name, False,
            k1_args(flat, Ray(p0, -d), eds.valid & far_hit.valid, None),
            compare)
    return k1_shapes, err


def render_match(dev, phase, label, make_scene, scene, integ, tiers):
    """renderC of ``make_scene(**scene)`` under ``integ`` on the card
    against the CPU, same key: for each (rtol, share) of ``tiers`` at least
    ``share`` of the pixels within rtol (atol IMG_ATOL), the image means
    within IMG_MEAN_REL."""
    imgs = [integ.renderC(make_scene(**scene, device=d), seed=7).cpu()
            .numpy().reshape(-1, 3) for d in (dev, torch.device("cpu"))]
    image_gate(phase, f"card and CPU renders of {label}", *imgs, tiers)


def render_check(dev, reference, phase, label, key, tiers):
    """``render_match`` of the render ``render_checks()[key]``, its CPU side
    from ``reference`` (a ``CpuReference``), compared in phase 34."""
    make_scene, scene, integ = render_checks()[key]
    img = render_run(make_scene, scene, integ(), dev)
    reference.later(phase, f"the render {key}", f"render {key}",
                    lambda cpu: image_gate(
                        phase, f"card and CPU renders of {label}", img, cpu,
                        tiers))


def image_gate(phase, label, got, want, tiers=((IMG_RTOL, IMG_CLOSE_FRAC),)):
    """Image ``got`` against ``want`` (numpy, (pixels, 3)) under phase 4's
    gates: for each (rtol, share) of ``tiers`` at least ``share`` of the
    pixels within rtol (atol IMG_ATOL), the means within IMG_MEAN_REL, every
    pixel of ``got`` finite. Returns the share at the first tier."""
    mean_rel = abs(got.mean() - want.mean()) / abs(want.mean())
    shares = [(rtol, share, float(np.isclose(
        got, want, rtol=rtol, atol=IMG_ATOL).all(axis=-1).mean()))
        for rtol, share in tiers]
    log(f"  {label}: " + ", ".join(
        f"{s:.6f} of pixels within rtol {rtol} (bound {share})"
        for rtol, share, s in shares)
        + f"; image means {got.mean():.6f} / {want.mean():.6f}, "
        f"relative difference {mean_rel:.3g}")
    if (not np.isfinite(got).all() or mean_rel >= IMG_MEAN_REL
            or any(s < share for _, share, s in shares)):
        raise AssertionError(f"phase {phase}: {label} disagree")
    return shares[0][2]


def material_phase(dev, reference):
    """Phase 17: the materials and lights on the card against the CPU
    (``reference``, a ``CpuReference``), and the six AOVs on the bench
    scene."""
    render_check(dev, reference, 17, "env_scene, rough conductor, "
                 "DirectIntegrator(1, 1)", "17 rough", ROUGH_IMG_TIERS)
    render_check(dev, reference, 17, "textured quad, DirectIntegrator(1, 1)",
                 "17 textured", ((IMG_RTOL, IMG_CLOSE_FRAC),))
    log("  env_scene, rough conductor, PathTracer(2): interior gradient")
    grad_phase(dev, reference, "17 rough interior")
    log("  the same with the boundary terms (sppe 2, sppse 4)")
    grad_phase(dev, reference, "17 rough boundary")
    log("  textured quad, DirectIntegrator(1, 1): interior gradient")
    grad_phase(dev, reference, "17 textured")
    def aov_gate(field, a, b):
        close = np.isclose(a, b, rtol=1e-5, atol=1e-5).all(axis=-1).mean()
        log(f"  AOV {field}: {close:.6f} of {a.shape[0]} pixels within rtol "
            f"1e-5, atol 1e-5; mean |value| {np.abs(a).mean():.6f}")
        if not np.isfinite(a).all() or close < 0.999:
            raise AssertionError(f"phase 17: AOV {field} differs between the "
                                 "card and the CPU")
        if field == "silhouette" and not (a == b).all():
            raise AssertionError("phase 17: the silhouette AOV must be equal")
    for field in AOV_FIELDS:
        make_scene, scene, integ = render_checks()[f"17 AOV {field}"]
        a = render_run(make_scene, scene, integ(), dev)
        reference.later(17, f"the AOV {field}", f"render 17 AOV {field}",
                        lambda b, f=field, a=a: aov_gate(f, a, b))


def texel_backward_ms(dev, shape, label):
    """The bilinear lookup alone on one 2^21-lane chunk of uniform uv into
    a ``shape`` image: forward (four row gathers) and backward (four
    ``index_add_`` into the texels), CUDA events over 5 runs."""
    from psdr_tpu_torch.core.bitmap import Bitmap, eval_bitmap
    g = torch.Generator(device=dev).manual_seed(5)
    data = torch.rand(shape, device=dev, generator=g, requires_grad=True)
    uv = torch.rand((N_TIME, 2), device=dev, generator=g)

    def fwd():
        return eval_bitmap(Bitmap(data), uv)

    def both():
        data.grad = None
        fwd().sum().backward()

    f_ms, _ = time_ms(fwd, 5)
    b_ms, _ = time_ms(both, 5)
    if not bool(torch.isfinite(data.grad).all()):
        raise AssertionError(f"phase 19: {label} texel gradient not finite")
    log(f"  eval_bitmap, {N_TIME} lanes into {label} {tuple(shape)}: forward "
        f"{f_ms:.3f} ms, forward + backward {b_ms:.3f} ms")
    return b_ms - f_ms


def masked_texel_reads(dev, sc):
    """Phase 19: one profiled ``PathTracer(3)`` step on ``sc`` as it is,
    where the lanes a material's mask discards read texels spread over the
    image (``eval_bitmap``'s ``active``), and one with that argument
    ignored, where the lanes of meshes without uv all read texel 0 and the
    backward piles their zero cotangents' atomic adds onto four rows. The
    loss must not move; the ``index_add_`` kernels' time must not be longer
    spread than piled."""
    from psdr_tpu_torch import PathTracer
    from psdr_tpu_torch.bsdf import diffuse, roughconductor
    from psdr_tpu_torch.core import bitmap, threefry
    render = PathTracer(3).render_fn(sc, with_boundary=False)
    base = sc.params()

    def step(label):
        out = {}

        def fn():
            out["loss"] = float(grad_step(render, base, dev,
                                          threefry.PRNGKey(9))[0])
        _, busy, adds = profile_step(fn, label)
        return out["loss"], busy, adds

    spread = step("step, masked lanes' texel reads spread")
    mods = (diffuse, roughconductor)
    try:
        for m in mods:
            m.eval_bitmap = (lambda bm, uv, flip_v=False, active=None:
                             bitmap.eval_bitmap(bm, uv, flip_v))
        piled = step("step, masked lanes' texel reads piled on texel 0")
    finally:
        for m in mods:
            m.eval_bitmap = bitmap.eval_bitmap
    log(f"  index_add kernels: {spread[2]:.2f} ms spread, {piled[2]:.2f} ms "
        f"piled; device busy {spread[1]:.1f} / {piled[1]:.1f} ms; loss "
        f"{spread[0]:.8f} / {piled[0]:.8f}")
    if abs(spread[0] - piled[0]) > 1e-6 * abs(piled[0]) or spread[2] > piled[2]:
        raise AssertionError("phase 19: spreading the masked lanes' texel "
                             "reads moved the loss or lengthened the "
                             "index_add kernels")


def tolerant(intersect, err, tris, tally):
    """``comparer``'s twin for rays that may be badly conditioned (``tris``
    None: each launch's own tree's triangles): lanes on
    which K1 and ``k1_plain`` differ are counted into ``tally[label]``, and
    on those lanes K1 must equal its own walk in tensor code
    (``k1_walk_plain``), which differs from ``k1_plain`` only where a hit's
    computed t is off by more than the cull margin."""
    def compare(label, args, hk, hp, any_hit):
        mode = "any" if any_hit else "closest"
        fields = ("valid",) if any_hit else ("valid", "tri_id", "t", "uv")
        bad = torch.zeros_like(hk.valid)
        for f in fields:
            a, b = getattr(hk, f), getattr(hp, f)
            d = a != b
            bad |= d if d.ndim == 1 else d.any(dim=-1)
        n_bad = int(bad.sum())
        tally[label] = tally.get(label, 0) + n_bad
        if n_bad:
            bvh, *rays = args
            sub = [x[bad].contiguous() for x in rays]
            hw = intersect.k1_walk_plain(bvh, *sub, any_hit=any_hit)
            for f in fields:
                if not torch.equal(getattr(hw, f), getattr(hk, f)[bad]):
                    raise AssertionError(
                        f"{label}: K1 differs from k1_plain on {n_bad} lanes "
                        f"and from its own walk in tensor code ({f})")
            log(f"  {label} {mode}: K1 and k1_plain differ on {n_bad} of "
                f"{bad.numel()} lanes; there K1 equals its walk in tensor "
                "code (the cull-margin rule)")
            keep = ~bad
            hk = type(hk)(*(getattr(hk, f)[keep] for f in hk._fields))
            hp = type(hp)(*(getattr(hp, f)[keep] for f in hp._fields))
            args = (bvh, *(x[keep].contiguous() for x in rays))
        e, _ = (check_any_hits(f"{label} {mode}", args,
                               bvh_tris(args[0]) if tris is None else tris,
                               hk, hp)
                if any_hit else exact(f"{label} {mode}", hk, hp))
        err[mode].append((e, 0))
    return compare


def env_shapes(intersect, sc, dev):
    """Phase 20: K1 and K2 at ``env_bench_scene``'s shapes, the 2^21-lane
    chunk in tile order that ends at the middle of the frame (the sphere,
    the ground and some sky): the camera rays (K1 closest; its tests a
    ray stand beside the bench scene's, for the tree that now holds the 12
    bounding faces), the BSDF-sampled bounce rays (K1 closest), the shadow
    rays toward the sky (K1 any) and the emitter-first sweep over 2 + 12
    faces (K2). Returns ({shape: dict} of K1, the same of K2, {mode: [(max
    |dt|, valid mismatches), ...]} with K2's under "k2", {label: lanes on
    which K1 and k1_plain differ})."""
    from psdr_tpu_torch.scene.scene import detach_flat
    from psdr_tpu_torch.testing.scenes import (tiled_camera_rays,
                                               tiled_material_rays)
    err = {"closest": [], "any": [], "k2": []}
    tally = {}
    with torch.no_grad():
        sc.prepare_accel()
        flat = detach_flat(sc.build(sc.params()))
        log(f"  env bench scene: {flat.tri.p0.shape[0]} tris, "
            f"{flat.accel.num_leaves} leaves, {flat.em_tri_idx.numel()} "
            f"emitter-first faces, importance grid "
            f"{flat.envmap.cell_distrb.resolution}")
        compare = tolerant(intersect, err,
                           (flat.tri.p0, flat.tri.e1, flat.tri.e2), tally)
        # the chunk in the middle of the frame: the first sees only sky
        chunk = max(0, sc.opts.num_pixels * sc.opts.spp // N_TIME // 2 - 1)
        cam = tiled_camera_rays(sc, flat, N_TIME, sc.opts.spp, 2,
                                chunk=chunk)[0]
        sweeps = tiled_material_rays(sc, flat, N_TIME, sc.opts.spp, 2,
                                     chunk=chunk)
        k1_shapes = {}
        for name, any_hit, rays in (
                ("env camera chunk", False, cam),
                ("env BSDF bounce sweep", False, sweeps["bounce"]),
                ("env sky shadow sweep", True, sweeps["sky shadow"])):
            k1_shapes[name] = k1_shape(intersect, name, any_hit,
                                       k1_args(flat, *rays), compare)
        bounce, alive, _ = sweeps["bounce"]
        idxs = flat.em_tri_idx
        args = (*(x[idxs].contiguous() for x in (flat.tri.p0, flat.tri.e1,
                                                 flat.tri.e2)),
                bounce.o.contiguous(), bounce.d.contiguous(), alive,
                torch.full((N_TIME,), float("inf"), device=dev))
        name = "env emitter-first sweep"
        e, timed = k2_timed(intersect, args, name, f"{N_TIME} bounce rays")
        err["k2"].append(e)
    return k1_shapes, {name: timed}, err, tally


def textured_cbox(cfg, device):
    """The bench scene (``cbox_scene(**cfg)``) with a TEX_SIZE^2 checker
    texture on its floor, on ``device``."""
    from psdr_tpu_torch import Diffuse
    from psdr_tpu_torch.core.bitmap import from_array
    from psdr_tpu_torch.testing.scenes import cbox_scene, checker_texture
    sc = cbox_scene(**cfg, device=device)
    sc.meshes[0].bsdf_id = sc.add_bsdf(
        Diffuse(from_array(checker_texture(TEX_SIZE))), "floor")
    return sc


def leaf_list(tree):
    """((group, index, name), leaf) in the params tree's order."""
    from psdr_tpu_torch.opt import leaf_items
    return list(leaf_items(tree))


def host(x) -> np.ndarray:
    return (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


def bench_files(tmp):
    """The bench scene (``textured_cbox(BENCH)``, on the CPU) written as
    files into the new directory ``tmp``: (the scene, the XML's path, the
    seconds the writing took, a digest of every file's name and bytes)."""
    import hashlib

    from psdr_tpu_torch.testing.scenes import write_scene
    os.makedirs(tmp)
    written = textured_cbox(BENCH, "cpu")
    t0 = time.perf_counter()
    path = write_scene(written, tmp, name="bench.xml")
    t_write = time.perf_counter() - t0
    h = hashlib.sha256()
    for name in sorted(os.listdir(tmp)):
        with open(os.path.join(tmp, name), "rb") as f:
            h.update(name.encode() + f.read())
    return written, path, t_write, h.hexdigest()


def loaded_small(path):
    """Phase 21's scene maker: the files at ``path`` loaded on the device
    asked for, at SMALL's size."""
    def small(**kw):
        import dataclasses

        from psdr_tpu_torch import load_file
        sc = load_file(path, device=kw["device"])
        sc.opts = dataclasses.replace(sc.opts, **{
            k: v for k, v in SMALL.items() if k != "occluder_subdiv"})
        return sc
    return small


def loaded_render(d):
    """Phase 21's render on ``d``: the bench scene written as files into a
    temporary directory (``bench_files``), loaded at SMALL's size and
    rendered (``render_run``): (the files' digest, the image)."""
    from psdr_tpu_torch import DirectIntegrator
    with tempfile.TemporaryDirectory() as tmp:
        _, path, _, digest = bench_files(os.path.join(tmp, "bench"))
        return digest, render_run(loaded_small(path), {},
                                  DirectIntegrator(1, 1), d)


def loader_phase(intersect, dev, tmp, fwd_launches, reference):
    """Phase 21: the bench scene written as files into the new directory
    ``tmp`` and loaded on the card: params, the card-vs-CPU render (the
    CPU's from ``reference``, which writes the same files, compared in
    phase 34), and the forward at phase 5's config, whose launch counts
    must equal phase 5's (``fwd_launches``). Returns those counts and the
    median frame seconds."""
    from psdr_tpu_torch import DirectIntegrator, load_file, load_integrator
    written, path, t_write, digest = bench_files(tmp)
    t0 = time.perf_counter()
    sc = load_file(path, device=dev)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    sizes = sum(os.path.getsize(os.path.join(tmp, f)) for f in os.listdir(tmp))
    log(f"  wrote {len(os.listdir(tmp))} files ({sizes / 2**20:.1f} MiB) in "
        f"{t_write:.2f} s; load_file on the card (parse, {len(sc.meshes)} "
        f"meshes, BVH topology, first build) {t_load:.2f} s; "
        f"{sum(m.num_faces for m in sc.meshes)} faces, integrator "
        f"{type(load_integrator(sc)).__name__}")
    if sc.flat.tri.p0.device.type != dev.type or sc.flat.accel is None:
        raise AssertionError("phase 21: the loaded scene is not on the card "
                             "or has no BVH")
    worst = 0.0
    for (p, a), (q, b) in zip(leaf_list(written.params()),
                              leaf_list(sc.params())):
        a, b = host(a), host(b)
        if p != q or a.shape != b.shape:
            raise AssertionError(f"phase 21: leaf {p} / {q} differs in shape")
        if p[2] == "vertex_positions":      # written with %.6e
            ok = np.allclose(b, a, rtol=6e-7, atol=1e-7)
            worst = max(worst, float(np.abs(b - a).max()))
        else:
            ok = np.array_equal(a, b)
        if not ok:
            raise AssertionError(f"phase 21: loaded leaf {p} differs")
    log(f"  every params leaf equals the written scene's (vertices within "
        f"%.6e's rounding: largest |difference| {worst:.3g}); "
        f"{len(leaf_list(sc.params()))} leaves")

    img = render_run(loaded_small(path), {}, DirectIntegrator(1, 1), dev)

    def compare(cpu):
        theirs, want = cpu
        if theirs != digest:
            raise AssertionError("phase 21: the CPU process wrote other "
                                 "files than this one")
        image_gate(21, "card and CPU renders of the loaded scene, "
                   "DirectIntegrator(1, 1), 64x64 spp 4 (the same files)",
                   img, want)
    reference.later(21, "the loaded scene's render", "render 21", compare)
    launches, _, dt = forward_phase(intersect, dev, DirectIntegrator(1, 1),
                                    21, 3, sc=sc, profile=False)
    if launches != fwd_launches:
        raise AssertionError(f"phase 21: launches {launches}, phase 5 "
                             f"{fwd_launches}")
    log(f"  launches equal phase 5's: {launches}")
    return launches, dt


class QueryRecorder:
    """While it stands, the inputs of K1's and K2's launches are recorded,
    one record a distinct (mode, caller, rays, active rays): a checkpointed
    pass's recompute repeats its launches. The caller names the render
    term, the estimator and, after a slash, the scene query that launched
    the kernel. ``stop()`` ends the recording (a second call does nothing)
    and returns [(mode, caller, kernel args)], mode "closest", "any" or
    "k2"; K1's args are (bvh, ray_o, ray_d, active, tmax), K2's (p0, e1,
    e2, ray_o, ray_d, active, tmax)."""

    def __init__(self, intersect):
        self.intersect = intersect
        self.k1, self.k2 = intersect.k1_cuda, intersect.k2_cuda
        self.seen = {}
        intersect.k1_cuda, intersect.k2_cuda = self.k1_rec, self.k2_rec

    @staticmethod
    def caller():
        query = estimator = None
        f = sys._getframe(3)
        while f is not None:
            mod, name = f.f_globals.get("__name__", ""), f.f_code.co_name
            if mod == "psdr_tpu_torch.scene.scene":
                if estimator is None:
                    query = name
            elif (mod.startswith("psdr_tpu_torch.")
                  and not mod.startswith("psdr_tpu_torch.accel")):
                estimator = estimator or name
                if name.startswith("render_"):
                    return f"{name}: {estimator} / {query}"
            f = f.f_back
        return f"{estimator} / {query}"

    def record(self, mode, args):
        if torch.cuda.is_current_stream_capturing():
            return      # a capture's launches are its warm-up's again
        key = (mode, self.caller(), args[-4].shape[0], int(args[-2].sum()))
        self.seen.setdefault(key, args)

    def k1_rec(self, bvh, ray_o, ray_d, active, tmax, any_hit=False,
               counts=None):
        args = (bvh, ray_o, ray_d, active, tmax)
        self.record("any" if any_hit else "closest", args)
        return self.k1(*args, any_hit=any_hit, counts=counts)

    def k2_rec(self, *args):
        self.record("k2", args)
        return self.k2(*args)

    def stop(self) -> list:
        if self.intersect.k1_cuda == self.k1_rec:
            self.intersect.k1_cuda, self.intersect.k2_cuda = self.k1, self.k2
        return [(mode, label, args)
                for (mode, label, _, _), args in self.seen.items()]


def capture_queries(intersect, fn):
    """(``fn()``, the records of ``QueryRecorder`` over its run)."""
    recorder = QueryRecorder(intersect)
    try:
        out = fn()
    finally:
        records = recorder.stop()
    return out, records


def bvh_tris(bvh):
    """The triangles (p0, e1, e2), each (faces, 3), that K1 reads from the
    leaf rows of ``bvh``, by original triangle id."""
    P, L = bvh.num_leaves, bvh.leaf_size
    slots = bvh.leaf_tris.reshape(P, 9, L).permute(0, 2, 1).reshape(P * L, 9)
    perm = bvh.perm.long()
    real = perm >= 0
    tris = torch.zeros((int(perm.max()) + 1, 9), dtype=slots.dtype,
                       device=slots.device)
    tris[perm[real]] = slots[real]
    return tris[:, 0:3], tris[:, 3:6], tris[:, 6:9]


def captured_shapes(intersect, records, tris, prefix):
    """K1 and K2 on a step's own inputs (``records`` of ``QueryRecorder``),
    each shape named ``prefix`` and its caller, over the step's triangles
    ``tris`` (p0, e1, e2; None: those of each launch's tree): each against
    its plain version (K1 through ``tolerant``), timed and counted for its
    bound. Returns ({shape: dict} of K1, the same of K2, {mode: [(max |dt|,
    valid mismatches), ...]} with K2's under "k2", {label: lanes on which
    K1 and k1_plain differ}, {mode: the shape with the most active
    rays})."""
    err = {"closest": [], "any": [], "k2": []}
    tally, k1_shapes, k2_shapes, main = {}, {}, {}, {}
    compare = tolerant(intersect, err, tris, tally)
    for mode, label, args in records:
        n, active = args[-4].shape[0], int(args[-2].sum())
        name = f"{prefix}, {label}"
        same = sum(k == name or k.startswith(f"{name} #")
                   for k in (k2_shapes if mode == "k2" else k1_shapes))
        if same:
            name = f"{name} #{same + 1}"
        if mode == "k2":
            e, k2_shapes[name] = k2_timed(intersect, args, name,
                                          f"{n} rays")
            err["k2"].append(e)
        else:
            k1_shapes[name] = k1_shape(intersect, name, mode == "any", args,
                                       compare)
        best = main.get(mode)
        if best is None or active > best[1]:
            main[mode] = (name, active)
    return (k1_shapes, k2_shapes, err, tally,
            {mode: name for mode, (name, _) in main.items()})


def trainer_phase(intersect, dev, tmp):
    """Phase 22: the trainer at full width (see the module docstring).
    Returns (the launch counts of the five timed steps, a dict of the
    measures, and K1 and K2 on a step's own inputs as ``captured_shapes``
    gives them for the refit tree and the rebuilt tree together, with the
    refit tree's shapes of the most active rays as the main ones)."""
    import dataclasses

    from psdr_tpu_torch import load_file, load_integrator
    from psdr_tpu_torch.convert import params_from_numpy
    from psdr_tpu_torch.core import threefry
    from psdr_tpu_torch.opt import GROUPS, Optimizer
    from psdr_tpu_torch.scene.scene import detach_flat
    from psdr_tpu_torch.testing.scenes import flagship_deform, write_scene
    os.makedirs(tmp)
    path = write_scene(textured_cbox(TRAIN, "cpu"), tmp, name="train.xml")
    sc = load_file(path, device=dev)
    # the XML carries the film and the sampler; the boundary sample counts
    # are set as the flagship sets them
    sc.opts = dataclasses.replace(sc.opts, sppe=TRAIN["sppe"],
                                  sppse=TRAIN["sppse"])
    integ = load_integrator(sc)
    opts = sc.opts
    truth = sc.params()
    with torch.no_grad():
        target = integ.render_fn(sc, with_boundary=False, detached=True)(
            params_from_numpy(truth, device=dev), threefry.PRNGKey(1000))
    mesh = sc.meshes[OCCLUDER]
    v_true = host(truth["meshes"][OCCLUDER]["vertex_positions"])
    mesh.vertex_positions = flagship_deform(v_true)
    leaf = ("meshes", OCCLUDER, "vertex_positions")
    opt = Optimizer(sc, [f"Mesh[{OCCLUDER}].vertex_positions"], lr=1e-2)
    render = integ.render_fn(sc, with_boundary=True)

    def loss_fn(p, key):
        return torch.mean((render(p, key) - target) ** 2)

    def rmse():
        v = host(opt.params[leaf[0]][leaf[1]][leaf[2]])
        return float(np.sqrt(np.mean(np.sum((v - v_true) ** 2, axis=1))))

    lanes = {t: opts.num_pixels * getattr(opts, t)
             for t in ("spp", "sppe", "sppse")}
    log(f"  {opts.width}x{opts.height}, lanes a step: interior "
        f"{lanes['spp']}, primary edges {lanes['sppe']} (x2 rays), "
        f"secondary edges {lanes['sppse']}; remat "
        f"{[opts.resolve_remat(v) for v in lanes.values()]}; "
        f"{int(sc.flat.sec_edge.valid.sum())} candidate edges; vertex RMSE "
        f"to the truth at the start {rmse():.5f}")

    # the gradient must lead toward the truth: along v(s) = v + s (v_true -
    # v), the derivative at 0 of the loss linearized at v, mean(w * img)
    # with w the loss's gradient in the image, w = 2 (img - target) / size,
    # drawn with another key (so that w and the image's derivative do not
    # share samples): by the gradient (every boundary term) and by a central
    # difference with the same keys, over DESCENT_KEYS
    with torch.no_grad():
        w = 2 * (render(opt.params, threefry.PRNGKey(DESCENT_KEYS[0] - 1))
                 - target) / target.numel()

    def linear(p, key):
        return torch.sum(w * render(p, key))

    v0 = opt.params[leaf[0]][leaf[1]][leaf[2]].detach().clone()
    u = torch.as_tensor(v_true, device=dev) - v0
    ads, fds, coss = [], [], []
    for k in DESCENT_KEYS:
        live = {grp: [dict(e) for e in opt.params[grp]] for grp in GROUPS}
        x = v0.clone().requires_grad_(True)
        live[leaf[0]][leaf[1]][leaf[2]] = x
        (g,) = torch.autograd.grad(linear(live, threefry.PRNGKey(k)), [x])
        ads.append(float((g * u).sum()))
        coss.append(-float((g * u).sum() / (g.norm() * u.norm())))
        with torch.no_grad():
            ends = []
            for s in (DESCENT_EPS, -DESCENT_EPS):
                live[leaf[0]][leaf[1]][leaf[2]] = v0 + s * u
                ends.append(float(linear(live, threefry.PRNGKey(k))))
        fds.append((ends[0] - ends[1]) / (2 * DESCENT_EPS))
    ad, fd = float(np.mean(ads)), float(np.mean(fds))
    log(f"  toward the truth, dL/ds over {len(DESCENT_KEYS)} keys: by the "
        f"gradient {ad:.6g}, by central differences (s = +-{DESCENT_EPS}) "
        f"{fd:.6g}, relative difference {abs(ad - fd) / abs(fd):.3g} (bound "
        f"{DESCENT_REL}); by key (gradient, difference, cosine of -gradient "
        f"with v_true - v): "
        + ", ".join(f"({a:.4g}, {f:.4g}, {c:.3f})"
                    for a, f, c in zip(ads, fds, coss)))
    if not (ad < 0 and fd < 0 and abs(ad - fd) <= DESCENT_REL * abs(fd)):
        raise AssertionError("phase 22: the gradient does not lead toward "
                             "the truth as the rendered images do")

    def step(key, label):
        """One checked step: (seconds, loss, launches of the step)."""
        before = {p: v.clone() for p, v in leaf_list(opt.params)}
        seen = {}
        update = opt.update
        opt.update = lambda grads: (seen.update(grads), update(grads))[1]
        counts = dict(intersect.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = opt.step(loss_fn, threefry.PRNGKey(key))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        opt.update = update
        launches = {k: v - counts[k] for k, v in intersect.LAUNCHES.items()}
        moved = [p for p, v in leaf_list(opt.params)
                 if not torch.equal(v, before[p])]
        g = seen.get(leaf)
        if (not np.isfinite(loss) or g is None
                or not bool(torch.isfinite(g).all()) or moved != [leaf]):
            raise AssertionError(f"phase 22 ({label}): loss {loss}, "
                                 f"gradient finite: {g is not None and bool(torch.isfinite(g).all())}, "
                                 f"moved {moved}")
        require_launches(22, launches)
        return dt, loss, launches

    step(0, "warm-up")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    intersect.reset_launch_counts()
    times, losses, per_step = [], [], []
    for i in range(TRAIN_STEPS):
        dt, loss, launches = step(1 + i, f"step {i + 1}")
        times.append(dt)
        losses.append(loss)
        per_step.append(launches)
    launches = dict(intersect.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    dt = float(np.median(times))
    samples = opts.num_pixels * (opts.spp + opts.sppe + opts.sppse)
    log(f"  steps {', '.join(f'{t:.3f}' for t in times)} s; median "
        f"{dt:.3f} s -> {samples / dt / 1e6:.3f} M grad-samples/s (pixels x "
        f"(spp + sppe + sppse) = {samples}); losses "
        f"{', '.join(f'{l:.6g}' for l in losses)}; vertex RMSE "
        f"{rmse():.5f}; peak memory {peak / 2**30:.2f} GiB; launches over "
        f"{TRAIN_STEPS} steps {launches}, a step {per_step[-1]}")
    if any(p != per_step[0] for p in per_step):
        raise AssertionError(f"phase 22: launches vary by step: {per_step}")
    top, busy, adds = profile_step(
        lambda: opt.step(loss_fn, threefry.PRNGKey(7)), "trainer step")
    if any("indexing_backward" in k for k in top):
        raise AssertionError("phase 22: an indexing_backward kernel is among "
                             "the step's top ten")

    def captured(key, tree):
        """One step with its K1 and K2 inputs recorded, then K1 and K2 on
        them (``captured_shapes``)."""
        params = {grp: [{n: v.detach().clone() for n, v in e.items()}
                        for e in opt.params[grp]] for grp in GROUPS}
        _, records = capture_queries(intersect,
                                     lambda: step(key, f"captured, {tree}"))
        with torch.no_grad():
            flat = detach_flat(sc.build(params))
        log(f"  K1 and K2 on a step's own inputs, {tree}: {len(records)} "
            "distinct launches")
        return captured_shapes(intersect, records,
                               (flat.tri.p0, flat.tri.e1, flat.tri.e2),
                               f"trainer {tree}")

    k1_refit, k2_refit, err, tally, main = captured(20, "refit tree")
    # the step as a program, captured on the refit tree: the rebuild below
    # makes it capture again (Program(retrace_on=...)), and its replay then
    # equals the eager step on the new tree
    from psdr_tpu_torch.program import Program, value_and_grad
    prog = Program(value_and_grad(loss_fn), "trainer step", grad=True,
                   retrace_on=lambda: sc.accel_version)
    prog(opt.params, threefry.PRNGKey(30, device=dev))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    q = sc.refit_quality(opt.params)
    t_refit = time.perf_counter() - t0
    perm = sc._bvh_topo.perm.copy()
    t0 = time.perf_counter()
    rebuilt = opt.maybe_rebuild_accel(threshold=q * 0.999)
    t_rebuild = time.perf_counter() - t0
    if not rebuilt or np.array_equal(perm, sc._bvh_topo.perm):
        raise AssertionError("phase 22: the forced rebuild made no new tree")
    q2 = sc.refit_quality(opt.params)
    dt_new, loss_new, launches_new = step(8, "after the rebuild")
    log(f"  refit_quality {q:.5f} in {t_refit:.3f} s ({t_refit / dt:.2f} of "
        f"a step); forced rebuild (threshold {q * 0.999:.5f}) in "
        f"{t_rebuild:.3f} s, a new Morton order, quality now {q2:.5f}; a "
        f"step on the new tree {dt_new:.3f} s, loss {loss_new:.6g}, launches "
        f"{launches_new}")
    got = prog(opt.params, threefry.PRNGKey(30, device=dev))
    with torch.enable_grad():
        want = [_floats(prog.fn(opt.params, threefry.PRNGKey(30)))
                for _ in range(2)]
    spread = max(rel_l2(host(y), host(x)) for x, y in zip(*want))
    if prog.captures != 2:
        raise AssertionError(f"phase 22: the step program captured "
                             f"{prog.captures} times across the rebuild, "
                             "not 2")
    d = gate_replay(22, "the step program after the rebuild", _floats(got),
                    want[0], spread)
    log(f"  the step as a program: captured on the refit tree, captured "
        f"again after the rebuild; its replay within {d:.3g} relative L2 "
        f"of the eager step on the new tree (eager spread {spread:.3g})")
    del prog, got, want
    k1_new, k2_new, err_new, tally_new, _ = captured(21, "rebuilt tree")
    for mode in err:
        err[mode] += err_new[mode]
    tally.update(tally_new)
    return launches, dict(step_s=dt, samples=samples, peak=peak, busy=busy,
                          refit_s=t_refit), (
        {**k1_refit, **k1_new}, {**k2_refit, **k2_new}, err, tally, main)


def small_trainer_phase(dev, tmp):
    """Phase 23: the trainer and the harness at SMALL_TRAIN on the card
    against the CPU."""
    from psdr_tpu_torch import DirectIntegrator
    from psdr_tpu_torch.core import threefry
    from psdr_tpu_torch.opt import Optimizer
    from psdr_tpu_torch.testing import run_ad, run_fd
    from psdr_tpu_torch.testing.scenes import sphere_light_scene
    paths = ["Mesh[0]", "BSDF[id=white].reflectance", "Emitter[0].radiance"]

    def one_step(d):
        sc = sphere_light_scene(**SMALL_TRAIN, device=d)
        opt = Optimizer(sc, paths, lr=1e-2)
        render = DirectIntegrator(1, 1).render_fn(sc, with_boundary=True)
        seen = {}
        update = opt.update
        opt.update = lambda grads: (seen.update(grads), update(grads))[1]
        loss = opt.step(lambda p, key: torch.mean(render(p, key) ** 2),
                        threefry.PRNGKey(3))
        opt.update = update
        return opt, loss, {k: host(v).ravel() for k, v in seen.items()}

    (card, l_a, g_a), (_, _, g_b), (cpu, l_c, g_c) = (
        one_step(d) for d in (dev, dev, torch.device("cpu")))
    keys = sorted(g_c)

    def rel(x, y):
        ny = np.linalg.norm(y)
        return 0.0 if ny == 0 and np.linalg.norm(x) == 0 else float(
            np.linalg.norm(x - y) / ny)

    spread = max(rel(g_a[k], g_b[k]) for k in keys)
    worst = max(rel(g_a[k], g_c[k]) for k in keys)
    cos = min(float(g_a[k] @ g_c[k]) / (np.linalg.norm(g_a[k])
                                          * np.linalg.norm(g_c[k]))
              for k in keys if np.linalg.norm(g_c[k]) > 0)
    finite = all(np.isfinite(g_a[k]).all() for k in keys)
    loss_rel = abs(l_a - l_c) / l_c
    # the CPU's Adam update given the card's gradients
    host_opt = Optimizer(sphere_light_scene(**SMALL_TRAIN, device="cpu"),
                         paths, lr=1e-2)
    host_opt.update({k: torch.as_tensor(g_a[k]).reshape(
        host_opt.params[k[0]][k[1]][k[2]].shape) for k in keys})
    upd = max(float(np.abs(host(v) - host(host_opt.params[g][i][n])).max())
              for (g, i, n), v in card.trainable())
    log(f"  optimizer step, {len(keys)} leaves: loss card {l_a:.8f} / CPU "
        f"{l_c:.8f} (relative {loss_rel:.3g}); card spread {spread:.3g}; "
        f"worst leaf {worst:.3g} (bound {GRAD_REL_L2} + spread), worst "
        f"cosine {cos:.7f}; the CPU's Adam update from the card's gradients "
        f"differs from the card's by at most {upd:.3g}")
    if (loss_rel > 1e-5 or worst > GRAD_REL_L2 + spread or cos < GRAD_COS
            or not finite or upd > 1e-6):
        raise AssertionError("phase 23: the optimizer step on the card and "
                             "on the CPU disagree")
    # save -> load -> step equals the step without the round trip
    render = DirectIntegrator(1, 1).render_fn(card.scene, with_boundary=True)

    def loss_fn(p, key):
        return torch.mean(render(p, key) ** 2)

    ck = os.path.join(tmp, "ckpt.npz")
    card.save(ck)
    again = Optimizer(card.scene, paths, lr=1e-2)
    again.load(ck)
    for o in (card, again):
        o.step(loss_fn, threefry.PRNGKey(4))
    resume = max(float((a - b).abs().max()) for (_, a), (_, b) in
                 zip(card.trainable(), again.trainable()))
    log(f"  save / load / step against the step without the round trip: "
        f"largest |difference| {resume:.3g} (fixed-order sums)")
    if resume > 1e-5:
        raise AssertionError("phase 23: the resumed step differs")
    # the harness: a sphere translation along x
    kw = dict(direction=(1.0, 0.0, 0.0))
    imgs = []
    for d in (dev, dev, torch.device("cpu")):
        sc = sphere_light_scene(**SMALL_TRAIN, device=d)
        t0 = time.perf_counter()
        ad = run_ad(sc, DirectIntegrator(1, 1), "mesh_transform", npass=2,
                    **kw)
        fd = run_fd(sc, DirectIntegrator(1, 1), "mesh_transform", eps=0.05,
                    npass=2, **kw)
        imgs.append((ad, fd, time.perf_counter() - t0))
    (ad_a, fd_a, t_a), (ad_b, fd_b, _), (ad_c, fd_c, t_c) = imgs
    ad_tol = HARNESS_REL_L2 + rel(ad_a, ad_b)
    fd_tol = HARNESS_REL_L2 + rel(fd_a, fd_b)
    ad_rel, fd_rel = rel(ad_a, ad_c), rel(fd_a, fd_c)
    l1 = float(np.abs(ad_a - fd_a).sum() / np.abs(fd_a).sum())
    log(f"  run_ad / run_fd of a sphere translation: card {t_a:.2f} s, CPU "
        f"{t_c:.2f} s; card against CPU relative L2: AD {ad_rel:.3g} (bound "
        f"{HARNESS_REL_L2} + the card's spread = {ad_tol:.3g}), FD "
        f"{fd_rel:.3g} (bound {fd_tol:.3g}); AD against FD on the card, L1 "
        f"{l1:.3g} of FD's")
    if (not np.isfinite(ad_a).all() or ad_rel > ad_tol or fd_rel > fd_tol
            or not np.abs(ad_a).max() > 0):
        raise AssertionError("phase 23: the harness on the card and on the "
                             "CPU disagree")
    log("  the 1D vertex offset: value_and_grad of every leaf, card vs CPU")
    grad_match(dev, 23, dict(SMALL_TRAIN, sppe=0, sppse=0),
               DirectIntegrator(1, 1),
               make_scene=lambda **k: sphere_light_scene(vertex_offset=True,
                                                         **k))


def env_opt_in_phase(intersect, dev):
    """Phase 24: the envmap's alias and Hier2D tables, card vs CPU on
    env_scene under a 100 x 200 sky, then env_bench_scene's forward under
    the frozen cmf (phase 18's table) and under each. Returns {table:
    (launches, median frame seconds)}."""
    from psdr_tpu_torch import DirectIntegrator, PathTracer
    from psdr_tpu_torch.testing.scenes import (env_bench_scene, env_scene,
                                               sun_sky)
    log("  env_bench_scene, the frozen cmf:")
    out = {"cmf": forward_phase(intersect, dev, DirectIntegrator(1, 1), 24, 3,
                                sc=env_bench_scene(**ENV_BENCH, device=dev),
                                profile=False)[::2]}

    def big(**kw):
        return env_scene(sky=sun_sky(*ENV_SKY, seed=4), **kw)

    for switch, kind in (("PSDR_TPU_ENV_ALIAS", "alias"),
                         ("PSDR_TPU_ENV_HIER", "hier")):
        with switches({switch: "1"}):
            hc = big(**ENV_OPT_SMALL, device=dev).flat.envmap.cell_distrb
            if getattr(hc, kind) is None:
                raise AssertionError(f"phase 24: {switch}=1 took no {kind} "
                                     "table")
            log(f"  {switch}=1: the {kind} table on the {hc.resolution} grid")
            render_match(dev, 24, f"env_scene under {switch}=1",
                         big, ENV_OPT_SMALL, DirectIntegrator(1, 1),
                         ((IMG_RTOL, IMG_CLOSE_FRAC),))
            grad_match(dev, 24, ENV_OPT_BOUNDARY, PathTracer(2),
                       make_scene=big)
            t0 = time.perf_counter()
            sc = env_bench_scene(**ENV_BENCH, device=dev)
            res = sc.flat.envmap.cell_distrb.resolution
            torch.cuda.synchronize()
            log(f"  env_bench_scene under {switch}=1: the {kind} table on "
                f"the {res} grid, built with the scene in "
                f"{time.perf_counter() - t0:.2f} s")
            launches, _, dt = forward_phase(intersect, dev,
                                            DirectIntegrator(1, 1), 24, 3,
                                            sc=sc, profile=False)
            out[kind] = (launches, dt)
    log(f"  env_bench_scene DirectIntegrator(1, 1) frame: frozen cmf "
        f"{out['cmf'][1]:.3f} s, alias {out['alias'][1]:.3f} s, Hier2D "
        f"{out['hier'][1]:.3f} s")
    return out


def rel_l2(a, b) -> float:
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def grad_close(phase, what, a, b, bound=GRAD_REL_L2) -> float:
    """Raise unless gradient ``a`` is finite and, where ``b`` is not zero,
    within ``bound`` relative L2 of ``b`` with a cosine of at least
    GRAD_COS. Returns the relative L2 error."""
    if not np.isfinite(a).all():
        raise AssertionError(f"phase {phase} {what}: not finite")
    if not np.abs(b).any():
        return 0.0
    err = rel_l2(a, b)
    x, y = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    cos = float(x @ y / max(np.linalg.norm(x) * np.linalg.norm(y), 1e-300))
    if not (err <= bound and cos >= GRAD_COS):
        raise AssertionError(f"phase {phase} {what}: {err:.3g} relative L2, "
                             f"cosine {cos:.6f} from the reference (bound "
                             f"{bound:g})")
    return err


def sharded_phase(dev):
    """Phase 25 (see the module docstring): ``testing.ranks.sharded_checks``
    on SHARD_RANKS gloo ranks sharing the card, at phase 12's config.
    Returns (launches of one budget-split step summed over the ranks,
    seconds per sharded step by mode)."""
    from psdr_tpu_torch import DirectIntegrator
    from psdr_tpu_torch.convert import params_from_numpy
    from psdr_tpu_torch.core import threefry
    from psdr_tpu_torch.opt import leaf_items
    from psdr_tpu_torch.parallel import run_ranks
    from psdr_tpu_torch.parallel.sharding import (_budgets_divisible,
                                                  per_device_render_fn)
    from psdr_tpu_torch.testing import ranks
    from psdr_tpu_torch.testing.scenes import cbox_scene
    splits = (("budget", RENDERD["spp"]), ("lanes", SHARD_LANES_SPP))
    # each split twice on each rank (a warm-up, then the timed step); the
    # train step with one bucket twice, then per leaf
    cases = tuple((mode, dict(RENDERD, spp=spp), DirectIntegrator, True,
                   SHARD_KEY) for mode, spp in splits)
    t0 = time.time()
    outs = run_ranks(ranks.sharded_checks, SHARD_RANKS, "gloo",
                     args=(dev.type, cases,
                           (RENDERD, STEP_LR, SHARD_KEY, (False, False, True)),
                           (SMALL_BOUNDARY, GUIDING, None), 2),
                     timeout=RANK_TIMEOUT)
    log(f"  {SHARD_RANKS} gloo ranks on the one card, spawned, run and "
        f"joined in {time.time() - t0:.1f} s")
    n = SHARD_RANKS
    secs, serial_grads = {}, None
    for mode, spp in splits:
        sc = cbox_scene(**dict(RENDERD, spp=spp), device=dev)
        if _budgets_divisible(sc.opts, n) != (mode == "budget"):
            raise AssertionError(f"phase 25: spp {spp} does not take the "
                                 f"{mode} split")
        img_r, grads_r, _, launches_r = outs[0][mode]
        for r in outs[1:]:
            np.testing.assert_allclose(r[mode][0], img_r, rtol=1e-6,
                                       err_msg="phase 25: ranks")
        g = per_device_render_fn(DirectIntegrator(1, 1), sc, n, mode=mode)
        p = params_from_numpy(sc.params(), dev, requires_grad=True)
        key = threefry.PRNGKey(SHARD_KEY)
        torch.cuda.synchronize()
        ts = time.perf_counter()
        img = sum(g(p, key, d) for d in range(n)) / n
        ranks.sharded_loss(img).backward()
        torch.cuda.synchronize()
        ts = time.perf_counter() - ts
        np.testing.assert_allclose(img_r, host(img), rtol=2e-5, atol=2e-6,
                                   err_msg=f"phase 25 {mode}")
        ref = [host(torch.zeros_like(x) if x.grad is None else x.grad)
               for _, x in leaf_items(p)]
        worst = max(grad_close(25, f"{mode} leaf {i}", a, b, SHARD_REL_L2)
                    for i, (a, b) in enumerate(zip(grads_r, ref)))
        require_launches(25, launches_r)
        secs[mode] = max(r[mode][2] for r in outs)
        log(f"  {mode} split (spp {spp}, sppe {RENDERD['sppe']}, sppse "
            f"{RENDERD['sppse']}): image = serial emulation (rtol 2e-5, "
            f"atol 2e-6), worst leaf {worst:.3g} relative L2 (bound "
            f"{SHARD_REL_L2:g}); a sharded step {secs[mode]:.3f} s with {n} "
            f"ranks sharing one card (not a scaling figure), the serial "
            f"emulation {ts:.3f} s; launches a rank "
            f"{[r[mode][3] for r in outs]}")
        if mode == "budget":
            serial_grads = ref

    (la, pa), (lb, pb), (lc, pc) = outs[0]["steps"]
    p0 = [host(x) for _, x in leaf_items(params_from_numpy(
        cbox_scene(**RENDERD, device="cpu").params(), "cpu"))]
    # the summed gradient each step applied, leaf by leaf (make_train_step's
    # loss: the L2 to a black target)
    ga, gb, gc = ([(a - q) / -STEP_LR for a, q in zip(p, p0)]
                  for p in (pa, pb, pc))
    spread = max(rel_l2(b, a) for a, b in zip(ga, gb) if np.abs(a).any())
    diff = max(grad_close(25, "overlapped step", c, a, SHARD_REL_L2)
               for a, c in zip(ga, gc))
    sc = cbox_scene(**RENDERD, device=dev)
    g = per_device_render_fn(DirectIntegrator(1, 1), sc, n)
    p = params_from_numpy(sc.params(), dev, requires_grad=True)
    img = sum(g(p, threefry.PRNGKey(SHARD_KEY), d) for d in range(n)) / n
    torch.mean(img * img).backward()
    to_serial = max(grad_close(25, "step against the emulation", a,
                               host(torch.zeros_like(x) if x.grad is None
                                    else x.grad), SHARD_REL_L2)
                    for a, (_, x) in zip(ga, leaf_items(p)))
    log(f"  make_train_step, sgd({STEP_LR:g}): loss {la:.6g} / {lb:.6g} / "
        f"{lc:.6g} (one bucket, again, per leaf); the gradients applied, "
        f"worst leaf: per leaf against one bucket {diff:.3g}, one bucket's "
        f"own spread {spread:.3g}, against the serial emulation "
        f"{to_serial:.3g} (relative L2)")
    if not abs(lc - la) <= 1e-5 * la:
        raise AssertionError("phase 25: the overlapped step's loss differs")

    sc = ranks.guiding_scene(dev, SMALL_BOUNDARY)
    serial = DirectIntegrator(1, 1)
    serial.preprocess_secondary_edges(sc, 0, **GUIDING)
    m_ser = host(serial.warpper[0].distrb.pmf)
    m_col = outs[0]["guiding"][0]
    np.testing.assert_allclose(m_col, m_ser, rtol=1e-5,
                               atol=1e-6 * m_ser.max(),
                               err_msg="phase 25: collective guiding mass")
    log(f"  collective guiding table {GUIDING}: {int((m_ser > 0).sum())} "
        f"cells with mass, largest |collective - serial| "
        f"{np.abs(m_col - m_ser).max():.3g} of {m_ser.max():.3g}")

    t0 = time.time()
    one = run_ranks(ranks.one_rank_render, 1, "nccl",
                    args=("cuda", (ONE_RANK_SCENE, RENDERD), FORM_REPS),
                    timeout=RANK_TIMEOUT)[0]
    (img, grads, launches), (p_img, p_grads, p_launches) = (
        one["sharded"], one["plain"])
    np.testing.assert_allclose(img, p_img, rtol=2e-5, atol=2e-6,
                               err_msg="phase 25: one NCCL rank")
    worst = max(grad_close(25, "one NCCL rank", a, b, SHARD_REL_L2)
                for a, b in zip(grads, p_grads))
    if launches != p_launches:
        raise AssertionError(f"phase 25: one NCCL rank differs from the plain "
                             f"render ({worst:.3g}, {launches} vs "
                             f"{p_launches})")
    require_launches(25, launches)
    log(f"  one NCCL rank: shard_render_fn = render_fn under fold_in(key, 0) "
        f"(32 x 32 boundary step; worst leaf {worst:.3g}), launches equal "
        f"{launches}; {time.time() - t0:.1f} s with the spawn")
    (s_loss, s_grads, s_launches), (p_loss, p_grads, p_launches) = (
        one["step"], one["step_plain"])
    progs = one["step_programs"]
    if len(progs) != 1 or not progs[0][0]:
        raise AssertionError(f"phase 25: one NCCL rank's train step is not "
                             f"one captured program: {progs}")
    worst = max(grad_close(25, "one NCCL rank's captured step", a, b,
                           SHARD_REL_L2) for a, b in zip(s_grads, p_grads))
    if (abs(s_loss - p_loss) > 1e-5 * p_loss or s_launches != p_launches):
        raise AssertionError(f"phase 25: one NCCL rank's captured step: loss "
                             f"{s_loss} vs {p_loss}, launches {s_launches} "
                             f"vs {p_launches}")
    log(f"  one NCCL rank's make_train_step, captured whole with its "
        f"all-reduces ({progs[0][1]} graph nodes, capture "
        f"{progs[0][2]:.3f} s): its replay applies the plain gradient "
        f"(worst leaf {worst:.3g} relative L2), loss {s_loss:.6g}, launches "
        f"{s_launches}")
    forms = {}
    for kw, whole, split, (l_whole, l_split) in one["forms"]:
        if not abs(l_split - l_whole) <= 1e-5 * l_whole:
            raise AssertionError(f"phase 25: one NCCL rank's step forms at "
                                 f"{kw}: loss {l_whole} whole, {l_split} "
                                 "split")
        label = f"{kw['width']}x{kw['height']}"
        forms[label] = {"whole_s": whole, "split_s": split,
                        "whole_median_s": float(np.median(whole)),
                        "split_median_s": float(np.median(split))}
        log(f"  one NCCL rank's make_train_step at {kw}: whole form (one "
            f"program) {', '.join(f'{t:.5f}' for t in whole)} s, median "
            f"{np.median(whole):.5f}; split form (three programs, eager "
            f"all-reduces) {', '.join(f'{t:.5f}' for t in split)} s, median "
            f"{np.median(split):.5f}; losses {l_whole:.6g} / {l_split:.6g}")
    log(f"    {json.dumps({'step_forms': forms})}")
    total = {k: sum(r["budget"][3][k] for r in outs)
             for k in outs[0]["budget"][3]}
    return total, secs


def flagship_start(device):
    """(The flagship's full-width scene, its params with the occluder
    deformed as the example starts it) on ``device``."""
    from psdr_tpu_torch.convert import params_from_numpy
    from psdr_tpu_torch.examples import flagship_recovery as fr
    from psdr_tpu_torch.testing.scenes import flagship_deform
    sc = fr.build_scene(False, device)
    p = params_from_numpy(sc.params(), device)
    occ = p["meshes"][fr.OCCLUDER]
    occ["vertex_positions"] = torch.as_tensor(
        flagship_deform(host(occ["vertex_positions"])), device=device)
    return sc, p


def mv_emulation(targets, repeats: int, device) -> list:
    """Phase 26's serial emulation in this process on ``device``,
    ``repeats`` times:
    rank d's view (d % views) under fold_in(PRNGKey(0), d), the mean of
    the MV_RANKS losses, backward. Returns [(loss, occluder vertex
    gradient)] a run."""
    from psdr_tpu_torch import DirectIntegrator
    from psdr_tpu_torch.core import threefry
    from psdr_tpu_torch.examples import flagship_recovery as fr
    from psdr_tpu_torch.parallel.sharding import _select_sensor
    dev = torch.device(device)
    sc, p = flagship_start(dev)
    sc.prepare_accel()
    integ = DirectIntegrator(1, 1)
    targets = [torch.as_tensor(t, device=dev) for t in targets]
    v0 = p["meshes"][fr.OCCLUDER]["vertex_positions"]
    out = []
    for _ in range(repeats):
        v = v0.clone().requires_grad_(True)
        p["meshes"][fr.OCCLUDER]["vertex_positions"] = v
        flat = sc.build(p)
        total = 0.0
        for d in range(MV_RANKS):
            view = d % sc.num_sensors
            img = integ.radiance_image(
                sc, _select_sensor(flat, view), 0,
                threefry.fold_in(threefry.PRNGKey(0), d), True)
            total = total + torch.mean((img - targets[view]) ** 2)
        total = total / MV_RANKS
        total.backward()
        out.append((total.item(), host(v.grad)))
    return out


def multiview_phase(dev):
    """Phase 26 (see the module docstring). Returns (launches of one step
    summed over the ranks, seconds per step)."""
    import functools

    from psdr_tpu_torch import DirectIntegrator
    from psdr_tpu_torch.convert import params_from_numpy
    from psdr_tpu_torch.examples import flagship_recovery as fr
    from psdr_tpu_torch.opt import leaf_items
    from psdr_tpu_torch.parallel import run_ranks
    from psdr_tpu_torch.testing import ranks
    sc = fr.build_scene(False, dev)
    sc.prepare_accel()
    truth = params_from_numpy(sc.params(), dev)
    targets = [host(t) for t in fr.render_targets(sc, DirectIntegrator(1, 1),
                                                   truth)]
    t0 = time.time()
    outs = run_ranks(ranks.multiview_step, MV_RANKS, "gloo",
                     args=(flagship_start, targets, STEP_LR, 0, dev.type,
                           MV_STEPS), timeout=RANK_TIMEOUT)
    log(f"  {MV_RANKS} gloo ranks (one view each) on the one card, spawned, "
        f"run and joined in {time.time() - t0:.1f} s")
    _, p0 = flagship_start("cpu")
    leaf = [i for i, (path, _) in enumerate(leaf_items(p0))
            if path == ("meshes", fr.OCCLUDER, "vertex_positions")][0]
    v0 = list(leaf_items(p0))[leaf][1].numpy()
    got = outs[0]
    update = (got["params"][leaf] - v0) / STEP_LR

    # the emulation's own spread, run to run: MV_SPREAD_RUNS runs in this
    # process and as many in each of two other processes
    t0 = time.time()
    here = mv_emulation(targets, MV_SPREAD_RUNS, dev)
    there = run_ranks(functools.partial(mv_emulation, targets,
                                        MV_SPREAD_RUNS, dev.type), 2, "gloo",
                      timeout=RANK_TIMEOUT)
    runs = [(0, g) for _, g in here] + [(1 + r, g) for r, out in
                                        enumerate(there) for _, g in out]
    within, across = [], []
    for i, (pa, ga) in enumerate(runs):
        for pb, gb in runs[i + 1:]:
            (within if pa == pb else across).append(rel_l2(gb, ga))
    to_rank = [rel_l2(update, -g) for _, g in runs]
    loss, g = here[0]
    log(f"  the serial emulation {len(runs)} times ({MV_SPREAD_RUNS} in each "
        f"of 3 processes, {time.time() - t0:.1f} s): vertex gradient run "
        f"against run, within a process median {np.median(within):.3g}, "
        f"max {max(within):.3g}; across processes median "
        f"{np.median(across):.3g}, max {max(across):.3g} (relative L2); "
        f"losses {sorted({l for l, _ in here + [x for o in there for x in o]})}")
    log(f"  loss {got['loss']:.6g} (serial emulation {loss:.6g}); the "
        f"ranks' vertex update against each emulation run: median "
        f"{np.median(to_rank):.3g}, min {min(to_rank):.3g}, max "
        f"{max(to_rank):.3g} (bound {SHARD_REL_L2:g}, against this "
        f"process's first)")
    if not abs(got["loss"] - loss) <= 1e-5 * loss:
        raise AssertionError("phase 26: the multi-view loss differs from its "
                             "serial emulation")
    grad_close(26, "vertex update", update, -g, SHARD_REL_L2)
    for r in outs:
        require_launches(26, r["launches"])
    secs = float(np.median([max(ts) for ts in zip(*(r["seconds"]
                                                    for r in outs))]))
    samples = MV_RANKS * TRAIN["width"] * TRAIN["height"] * (
        TRAIN["spp"] + TRAIN["sppe"] + TRAIN["sppse"])
    log(f"  seconds per multi-view step {secs:.3f} ({MV_RANKS} ranks sharing "
        f"one card, not a scaling figure; each step {samples} grad-samples); "
        f"launches a rank a step "
        f"{[r['launches'] for r in outs]}")
    total_l = {k: sum(r["launches"][k] for r in outs)
               for k in outs[0]["launches"]}
    return total_l, secs


def flagship_phase(intersect, dev, tmp):
    """Phase 27: the ported ``flagship_recovery`` at full width for
    FLAGSHIP_ITERS iterations, each iteration a replay of its step program
    (the first one's warm-up and capture included), gated at every
    iteration. Returns (launches of the run, its summary)."""
    from psdr_tpu_torch.examples import flagship_recovery as fr
    os.makedirs(tmp)
    prev = {k: 0 for k in intersect.LAUNCHES}

    def on_iter(rec, g):
        now = dict(intersect.LAUNCHES)
        step = {k: now[k] - prev[k] for k in now}
        prev.update(now)
        if not (np.isfinite(rec["loss"]) and bool(torch.isfinite(g).all())):
            raise AssertionError(f"phase 27: iteration {rec['iter']} not "
                                 "finite")
        require_launches(27, step)

    intersect.reset_launch_counts()
    summary = fr.run(FLAGSHIP_ITERS, tmp, False, dev, on_iter=on_iter)
    launches = dict(intersect.LAUNCHES)
    curve = [json.loads(s) for s in open(os.path.join(
        tmp, "flagship_recovery_log.jsonl")).read().splitlines()]
    log("  iteration, loss, vertex RMSE, Chamfer: " + "; ".join(
        f"{r['iter']} {r['loss']:.5g} {r['vertex_rmse']:.5f} "
        f"{r['chamfer']:.5f}" for r in curve if "iter" in r))
    its = [r["seconds"] for r in curve if "iter" in r]
    log(f"  {FLAGSHIP_ITERS} iterations, {summary['seconds_per_iter']:.3f} s "
        f"an iteration (3 views; the first, warm-up and capture of its "
        f"program included, {its[0]:.3f} s, the median replayed one "
        f"{float(np.median(its[1:])):.4f} s), targets "
        f"{curve[0]['target_seconds']:.2f} "
        f"s; vertex RMSE {summary['rmse0']:.5f} -> "
        f"{summary['rmse_final']:.5f} (x{summary['rmse_reduction']:.3f}), "
        f"Chamfer {summary['chamfer0']:.5f} -> "
        f"{summary['chamfer_final']:.5f} (x"
        f"{summary['chamfer_reduction']:.3f}); launches {launches}")
    if not summary["rmse_final"] < summary["rmse0"]:
        raise AssertionError("phase 27: the vertex RMSE did not fall")
    return launches, summary


def program_frame(fn, top=None):
    """One profiled run of ``fn``: (wall ms, device-busy ms, device kernels,
    host launch calls: ``cudaLaunchKernel``, ``cuLaunchKernel``,
    ``cudaGraphLaunch`` and their kind). ``top``, a list, receives the ten
    kernels with the most device time, by name."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kern, calls = device_work(prof)
    busy = sum(ms for _, ms in kern.values())
    if top is not None:
        top.extend(k for k, _ in top_kernels(kern))
    return wall, busy, sum(n for n, _ in kern.values()), calls


def program_configs(dev):
    """Phase 28's configurations a-d, each as (label, eager(seed),
    replay(seed), the program after the first replay, the launches of a
    frame: phases 5, 14, 18 and 12's): eager runs the render op by op with
    a host key, replay through its program with the key on the card."""
    from psdr_tpu_torch import DirectIntegrator, PathTracer
    from psdr_tpu_torch.convert import params_from_numpy
    from psdr_tpu_torch.core import threefry
    from psdr_tpu_torch.scene.scene import detach_flat
    from psdr_tpu_torch.testing.scenes import cbox_scene, env_bench_scene

    def forward(integ, label, expect):
        sc = cbox_scene(**BENCH, device=dev)
        params = params_from_numpy(sc.params(), device=dev)
        render = integ.render_fn(sc, with_boundary=False, detached=True)
        prog = integ.render_program(sc, with_boundary=False, detached=True)
        return (label, lambda s: render(params, threefry.PRNGKey(s)),
                lambda s: prog(params, threefry.PRNGKey(s, device=dev)),
                lambda: prog, expect)

    def cached(integ, sc, label, boundary, expect):
        def eager(s):
            flat = sc.flat if boundary else detach_flat(sc.flat)
            with torch.no_grad():
                return integ.radiance_image(sc, flat, 0, threefry.PRNGKey(s),
                                            boundary)
        replay = ((lambda s: integ.renderD(sc, seed=s)) if boundary
                  else (lambda s: integ.renderC(sc, seed=s)))
        return (label, eager, replay,
                lambda: next(iter(integ._radiance_jits.values())), expect)

    yield forward(DirectIntegrator(1, 1), "a: DirectIntegrator(1, 1) "
                  "render_program, cbox 512x512 spp 64",
                  {"closest": 8, "any": 48, "k2": 8, "k3": 0})
    yield forward(PathTracer(3), "b: PathTracer(3) render_program, cbox "
                  "512x512 spp 64", {"closest": 24, "any": 64, "k2": 8,
                                     "k3": 0})
    yield cached(DirectIntegrator(1, 1), env_bench_scene(**ENV_BENCH,
                                                         device=dev),
                 "c: DirectIntegrator(1, 1) renderC, env_bench_scene 512x512 "
                 "spp 64", False, {"closest": 8, "any": 48, "k2": 8, "k3": 0})
    yield cached(DirectIntegrator(1, 1), cbox_scene(**RENDERD, device=dev),
                 "d: DirectIntegrator(1, 1) renderD, cbox 256x256 spp 16 "
                 "sppe 8 sppse 64", True,
                 {"closest": 4, "any": 20, "k2": 4, "k3": 0})


def program_phase(intersect, dev):
    """Phase 28: the forward renders as captured programs (configurations
    a-d, ``program_configs``). For each: the eager render at seeds 0, 0
    (its own run-to-run spread) and 1, and its launch counts; the program
    built and captured (capture seconds, graph nodes, pool bytes); one
    replay's launch counts against the eager frame's; replays at seeds 0,
    1, 0, each equal to the eager image of its seed bit for bit (the eager
    render repeats itself bit for bit), two more at seed 0 equal to the
    first (phase 31), and seed 1 against seed 0,
    which must lie as far apart as in the eager renders; eager frames and
    replays timed as phase 5 times
    frames, one of each profiled; peak memory with the program in the
    cache. Returns ({label: summary}, the launch counts of the replays at
    seeds 0, 1, 0 summed over a-d)."""
    out = {}
    total = {k: 0 for k in counted(intersect)}
    for label, eager, replay, program, expect in program_configs(dev):
        log(f"  {label}")
        e0 = eager(0).reshape(-1, 3)                     # warm-up
        torch.cuda.synchronize()
        intersect.reset_launch_counts()
        e0b = eager(0).reshape(-1, 3)
        torch.cuda.synchronize()
        eager_launches = dict(intersect.LAUNCHES)
        e1 = eager(1).reshape(-1, 3)
        spread = float((e0 - e0b).abs().max())
        if not (torch.isfinite(e0).all() and float(e0.mean()) > 0.0):
            raise AssertionError(f"phase 28: {label}: eager image not "
                                 "finite or black")
        if {k: eager_launches[k] for k in expect} != expect:
            raise AssertionError(f"phase 28: {label}: eager launches "
                                 f"{eager_launches}, expected {expect}")
        t0 = time.perf_counter()
        r0 = replay(0).reshape(-1, 3)      # warm-up, capture and a replay
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        prog = program()
        if not prog.captured:
            raise AssertionError(f"phase 28: {label}: no graph captured")
        intersect.reset_launch_counts()
        r0 = replay(0).reshape(-1, 3)
        torch.cuda.synchronize()
        replay_launches = dict(intersect.LAUNCHES)
        r1 = replay(1).reshape(-1, 3)
        r0b = replay(0).reshape(-1, 3)
        torch.cuda.synchronize()
        for k, v in counted(intersect).items():
            total[k] += v
        if replay_launches != eager_launches:
            raise AssertionError(f"phase 28: {label}: a replay launched "
                                 f"{replay_launches}, the eager frame "
                                 f"{eager_launches}")
        diffs = {}
        for name, r, e in (("seed 0", r0, e0), ("seed 1", r1, e1),
                           ("seed 0 again", r0b, e0)):
            d = float((r - e).abs().max())
            diffs[name] = d
            if not (spread == 0.0 and torch.equal(r, e)):
                raise AssertionError(
                    f"phase 28: {label}: the replay at {name} differs from "
                    f"the eager render by {d} (eager spread {spread}): not "
                    "bit for bit")
        # phase 31: two more replays at seed 0, each the first bit for bit
        if not all(torch.equal(replay(0).reshape(-1, 3), r0)
                   for _ in range(2)):
            raise AssertionError(f"phase 31: {label}: a repeated replay at "
                                 "seed 0 differs from the first")
        # a key baked in at the capture would replay seed 0's image at
        # seed 1: the replays' mean gap between the seeds must be the eager
        # renders' (far above the run-to-run spread)
        seed_gap = float((r1 - r0).abs().mean())
        eager_gap = float((e1 - e0).abs().mean())
        if not (seed_gap > 0.5 * eager_gap and eager_gap > 100.0 * spread):
            raise AssertionError(f"phase 28: {label}: seeds 1 and 0 are "
                                 f"{seed_gap} apart a pixel in the replays, "
                                 f"{eager_gap} in the eager renders (spread "
                                 f"{spread}): a key was baked in")
        times = {}
        for name, fn in (("eager", eager), ("replay", replay)):
            fn(1)                                          # warm-up
            torch.cuda.synchronize()
            ts = []
            for i in range(3):
                t0 = time.perf_counter()
                fn(2 + i)
                torch.cuda.synchronize()
                ts.append(time.perf_counter() - t0)
            times[name] = ts
        torch.cuda.reset_peak_memory_stats()
        replay(5)
        torch.cuda.synchronize()
        peak, reserved = (torch.cuda.max_memory_allocated(),
                          torch.cuda.memory_reserved())
        prof = {name: program_frame(lambda: fn(9))
                for name, fn in (("eager", eager), ("replay", replay))}
        summary = {
            "eager_spread": spread, "replay_repeats_equal": True,
            "replay_vs_eager": diffs, "seed_gap": seed_gap,
            "eager_seed_gap": eager_gap,
            "launches": replay_launches,
            "first_call_s": first_s, "capture_s": prog.capture_seconds,
            "nodes": prog.nodes, "pool_bytes": prog.pool_bytes,
            "eager_s": float(np.median(times["eager"])),
            "replay_s": float(np.median(times["replay"])),
            "peak_allocated_bytes": peak, "reserved_bytes": reserved,
            **{f"{name}_{k}": v for name, (wall, busy, kern, calls)
               in prof.items() for k, v in (
                   ("profiled_wall_ms", wall), ("busy_ms", busy),
                   ("idle", 1.0 - busy / wall), ("kernels", kern),
                   ("host_launch_calls", calls))}}
        log(f"    eager frames {', '.join(f'{t:.4f}' for t in times['eager'])}"
            f" s, replays {', '.join(f'{t:.4f}' for t in times['replay'])} s;"
            f" first call (warm-up, capture, replay) {first_s:.3f} s, capture"
            f" {prog.capture_seconds:.3f} s, {prog.nodes} graph nodes, pool "
            f"{prog.pool_bytes / 2**30:.3f} GiB; replay = eager bit for bit, "
            f"and replay = replay (phase 31); seeds 0 / 1 {seed_gap:.4g} "
            f"apart a pixel (eager "
            f"{eager_gap:.4g}); launches "
            f"{replay_launches}")
        log(f"    {json.dumps(summary)}")
        out[label] = summary
    return out, total


def _grad_steps(integ, sc, target, boundary):
    """(eager(seed), replay(seed), [its program], None, None) of
    ``grad_program`` on ``sc`` (laid out as ``gradient_configs``' makers
    give them): eager runs the program's body op by op with a host key,
    replay the program with the key on the card; each returns (loss,
    gradient tree)."""
    from psdr_tpu_torch.convert import params_from_numpy
    from psdr_tpu_torch.core import threefry
    dev = sc.device
    prog = integ.grad_program(sc, target, with_boundary=boundary)
    params = params_from_numpy(sc.params(), device=dev)

    def eager(s):
        with torch.enable_grad():
            return prog.fn(params, threefry.PRNGKey(s))
    return (eager, lambda s: prog(params, threefry.PRNGKey(s, device=dev)),
            [prog], None, None)


def _trainer_steps(dev):
    """Phase 29 (i): phase 22's trainer (the flagship's config, one view,
    the textured bench scene, the occluder from ``flagship_deform``) as two
    programs: the loss's value and gradient in the occluder's vertices,
    then ``Optimizer._jit_update``. Eager runs both bodies op by op. Each
    returns (loss, gradient, the updated first moment, the updated
    vertices); the vertices are not gated against eager (a first Adam step
    is the rate times the gradient's sign, which a gradient entry near 0
    may flip), but the replay's must equal the update's body run on the
    replay's own gradient bit for bit."""
    from psdr_tpu_torch import DirectIntegrator
    from psdr_tpu_torch.convert import params_from_numpy
    from psdr_tpu_torch.core import threefry
    from psdr_tpu_torch.opt import Optimizer
    from psdr_tpu_torch.program import Program, value_and_grad
    from psdr_tpu_torch.testing.scenes import flagship_deform
    import dataclasses
    sc = textured_cbox(TRAIN, dev)
    sc.opts = dataclasses.replace(sc.opts, sppe=TRAIN["sppe"],
                                  sppse=TRAIN["sppse"])
    integ = DirectIntegrator(1, 1)
    sc.prepare_accel()
    target = integ.render_program(sc)(params_from_numpy(sc.params(), dev),
                                      threefry.PRNGKey(1000, device=dev))
    mesh = sc.meshes[OCCLUDER]
    mesh.vertex_positions = flagship_deform(np.asarray(mesh.vertex_positions))
    opt = Optimizer(sc, [f"Mesh[{OCCLUDER}].vertex_positions"], lr=1e-2)
    render = integ.render_fn(sc, with_boundary=True)
    path = ("meshes", OCCLUDER, "vertex_positions")

    def loss(v, key):
        live = {g: [dict(e) for e in opt.params[g]] for g in opt.params}
        live["meshes"][OCCLUDER]["vertex_positions"] = v
        return torch.mean((render(live, key) - target) ** 2)

    grad = Program(value_and_grad(loss), "trainer value_and_grad",
                   grad=True, retrace_on=lambda: sc.accel_version)
    v0 = opt.params["meshes"][OCCLUDER]["vertex_positions"]
    state = [[opt.state["mu"][path]], [opt.state["nu"][path]],
             opt.state["count"]]

    def eager(s):
        with torch.enable_grad():
            value, g = grad.fn(v0, threefry.PRNGKey(s))
        with torch.no_grad():
            new, mu, _, _ = opt._update([v0], [g], *state)
        return value, g, mu[0], new[0]

    def replay(s):
        value, g = grad(v0, threefry.PRNGKey(s, device=dev))
        new, mu, _, _ = opt._jit_update([v0], [g], *state)
        return value, g, mu[0], new[0]

    def check(out):
        with torch.no_grad():
            new = opt._update([v0], [out[1]], *state)[0][0]
        if not torch.equal(out[3], new):
            raise AssertionError("phase 29 (i): the update program's "
                                 "vertices differ from its body's")
    return eager, replay, [grad, opt._jit_update], 3, check


def _flagship_steps(dev):
    """Phase 29 (h): one flagship iteration at phase 27's config (three
    views, smoothing, masked Adam on ``exponential_decay``) through
    ``flagship_recovery.make_train_step``: (eager(seed), replay(seed),
    [its program], 3, check), each returning (loss, raw gradient, the
    occluder's first moment, its updated vertices; those are not gated
    against eager, as in (i)). ``check`` holds a replay's vertices to the
    masked update run eagerly on the smoothed replay gradient, bit for bit,
    then replays once more from that replay's own state (count 1, where
    the bias corrections and the schedule's rate differ): every output
    (loss, gradient, first moment, vertices) equal to the eager step's from
    the same state bit for bit, its vertices to the update of its own
    gradient as at count 0."""
    from psdr_tpu_torch import DirectIntegrator
    from psdr_tpu_torch.core import threefry
    from psdr_tpu_torch.examples import flagship_recovery as fr
    from psdr_tpu_torch.opt import (adam, apply_updates, exponential_decay,
                                    masked, tree_map)
    sc, params = flagship_start(dev)
    sc.prepare_accel()
    integ = DirectIntegrator(1, 1)
    truth = tree_map(lambda x: x, params)
    truth["meshes"] = list(truth["meshes"])
    truth["meshes"][fr.OCCLUDER] = dict(
        truth["meshes"][fr.OCCLUDER], vertex_positions=torch.as_tensor(
            np.asarray(sc.meshes[fr.OCCLUDER].vertex_positions),
            device=dev))
    targets = fr.render_targets(sc, integ, truth)
    mask = tree_map(torch.zeros_like, params)
    mask["meshes"][fr.OCCLUDER]["vertex_positions"] = torch.ones_like(
        params["meshes"][fr.OCCLUDER]["vertex_positions"])
    optimizer = masked(adam(exponential_decay(1e-2, FLAGSHIP_ITERS, 0.05)),
                       mask)
    state = optimizer.init(params)
    v = params["meshes"][fr.OCCLUDER]["vertex_positions"]
    smooth = fr.laplacian_smoother(sc.meshes[fr.OCCLUDER].faces,
                                   v.shape[0], dev)
    step = fr.make_train_step(sc, fr.make_loss(sc, integ, targets), smooth,
                              optimizer)

    def pick(out):
        p1, s1, loss, g = out
        return (loss, g, s1["mu"]["meshes"][fr.OCCLUDER]["vertex_positions"],
                p1["meshes"][fr.OCCLUDER]["vertex_positions"])

    def eager(s, p=params, st=state):
        with torch.enable_grad():
            return pick(step.fn(p, st, threefry.PRNGKey(s)))

    def replay(s, p=params, st=state):
        return step(p, st, threefry.PRNGKey(s, device=dev))

    def update_of(out, p, st):
        """The replay's vertices against the update of its own smoothed
        gradient, run eagerly: bit for bit (the smoothing sums in one fixed
        order); the largest difference (0)."""
        grads = tree_map(torch.zeros_like, p)
        grads["meshes"][fr.OCCLUDER]["vertex_positions"] = smooth(out[1])
        with torch.no_grad():
            updates, _ = optimizer.update(grads, st, p)
            want = apply_updates(p, updates)["meshes"][fr.OCCLUDER][
                "vertex_positions"]
        old = p["meshes"][fr.OCCLUDER]["vertex_positions"]
        err = (out[3] - want).abs()
        move = float((want - old).abs().max())
        if not move > 0.0:
            raise AssertionError("phase 29 (h): the update moved nothing")
        if not torch.equal(out[3], want):
            raise AssertionError(
                f"phase 29 (h): the replay's vertices differ from the update "
                f"of its own gradient by {float(err.max()):.3g} at count "
                f"{int(st['count'])}")
        return float(err.max())

    def check(out):
        e0 = update_of(out, params, state)
        p1, s1, _, _ = replay(0)
        if int(s1["count"]) != 1:
            raise AssertionError("phase 29 (h): the replay's count is "
                                 f"{int(s1['count'])}, not 1")
        out1 = pick(replay(1, p1, s1))
        got, want = _floats(out1), _floats(eager(1, p1, s1))
        d = max(rel_l2(host(x), host(y)) for x, y in zip(got, want))
        if not all(np.array_equal(host(x), host(y))
                   for x, y in zip(got, want)):
            raise AssertionError(f"phase 29 (h): the replay from count 1 "
                                 f"differs from the eager step by {d:.3g} "
                                 "relative L2: not bit for bit")
        e1 = update_of(out1, p1, s1)
        log(f"    (h) the update of the replay's own gradient: vertices "
            f"within {e0:.3g} (count 0), {e1:.3g} (count 1); the replay "
            f"from count 1 against eager: every output bit for bit "
            f"({d:.3g})")
    return (eager, lambda s: pick(replay(s)), [step], 3, check)


def _guiding_steps(dev):
    """Phase 29 (j): phase 11's guiding build (GUIDING on
    SMALL_BOUNDARY): the eager body with a host key against the build's
    program; each returns (the cell masses summed over the rounds,)."""
    from psdr_tpu_torch import DirectIntegrator
    from psdr_tpu_torch.core import threefry
    from psdr_tpu_torch.testing.scenes import cbox_scene
    sc = cbox_scene(**SMALL_BOUNDARY, device=dev)
    integ = DirectIntegrator(1, 1)
    integ.preprocess_secondary_edges(sc, 0, **GUIDING)   # its program
    (prog,) = integ._guiding_jits.values()

    def eager(s):
        with torch.no_grad():
            return (prog.fn(threefry.PRNGKey(s)),)
    return (eager, lambda s: (prog(threefry.PRNGKey(s, device=dev)),),
            [prog], None, None)


def gradient_configs(dev):
    """Phase 29's configurations e-j: (label, make() -> (eager(seed),
    replay(seed), [programs], the count of leading outputs gated against
    eager (None: all), a check of a replay's outputs or None), the K1 / K2
    launches of one eager step or None where only the equality is
    gated)."""
    from psdr_tpu_torch import DirectIntegrator, PathTracer
    from psdr_tpu_torch.testing.scenes import cbox_scene

    def bench(integ, cfg, boundary):
        def make():
            sc = cbox_scene(**cfg, device=dev)
            target = torch.zeros((sc.opts.num_pixels, 3), device=dev)
            return _grad_steps(integ, sc, target, boundary)
        return make

    yield ("e: DirectIntegrator(1, 1) grad_program, cbox 512x512 spp 16",
           bench(DirectIntegrator(1, 1), BWD, False),
           {"closest": 2, "any": 12, "k2": 2, "k3": 0})
    yield ("f: PathTracer(3) grad_program, cbox 512x512 spp 16",
           bench(PathTracer(3), BWD, False),
           {"closest": 6, "any": 16, "k2": 2, "k3": 0})
    yield ("g: DirectIntegrator(1, 1) boundary step, cbox 256x256 spp 16 "
           "sppe 8 sppse 64", bench(DirectIntegrator(1, 1), RENDERD, True),
           {"closest": 4, "any": 20, "k2": 4, "k3": 0})
    yield ("h: flagship iteration, 3 views 256x256 spp 16 sppe 4 sppse 32",
           lambda: _flagship_steps(dev), None)
    yield ("i: trainer value_and_grad and Optimizer._jit_update, 256x256 "
           "spp 16 sppe 4 sppse 32", lambda: _trainer_steps(dev),
           {"closest": 3, "any": 16, "k2": 3, "k3": 0})
    yield ("j: guiding build, 24x3x3 cells x 4 samples x 8 rounds",
           lambda: _guiding_steps(dev), None)


def _floats(out, n=None):
    from torch.utils._pytree import tree_flatten
    return [x.reshape(-1).double() for x in tree_flatten(
        out if n is None else out[:n])[0] if x.is_floating_point()]


def gate_replay(phase, label, got, want, spread) -> float:
    """A replayed step's outputs ``got`` against the eager step's ``want``
    (lists of flat tensors, the loss first): the eager step repeats itself
    bit for bit (its run-to-run ``spread``, the largest relative L2 over
    the outputs, is 0) and every output equals it bit for bit. Returns the
    largest relative L2 difference (0)."""
    worst = 0.0
    for i, (x, y) in enumerate(zip(got, want)):
        xh, yh = host(x), host(y)
        d = rel_l2(xh, yh)
        worst = max(worst, d)
        if not (spread == 0.0 and np.array_equal(xh, yh)):
            raise AssertionError(
                f"phase {phase}: {label}: output {i} of the replay differs "
                f"from the eager step by {d:.3g} relative L2 (eager spread "
                f"{spread:.3g}): not bit for bit")
    return worst


def gradient_case(intersect, label, make, expect, phase=29, record=False):
    """One gradient program against its eager step (phase 29's gates, read
    in ``gradient_phase``): ``make() -> (eager(seed), replay(seed),
    [programs], the count of leading outputs gated against eager (None:
    all), a check of a replay's outputs or None)``, ``expect`` the K1 / K2
    launches of one eager step or None; ``record`` records the K1 and K2
    launches of the first eager step (``capture_queries``) and needs K1
    and K2 launched. Returns (its summary, the launches of the replays at
    seeds 0, 1, 0, the records or None)."""
    log(f"  {label}")
    eager, replay, progs, n_gated, check = make()
    records = None
    if record:
        e0, records = capture_queries(intersect, lambda: eager(0))
    else:
        e0 = eager(0)                                 # warm-up
    torch.cuda.synchronize()
    intersect.reset_launch_counts()
    e0b = eager(0)
    torch.cuda.synchronize()
    eager_launches = dict(intersect.LAUNCHES)
    e1 = eager(1)
    a, b, c = (_floats(x, n_gated) for x in (e0b, e0, e1))
    if not all(bool(torch.isfinite(x).all()) for x in a):
        raise AssertionError(f"phase {phase}: {label}: an eager output is "
                             "not finite")
    spreads = [rel_l2(host(y), host(x)) for x, y in zip(a, b)]
    spread = max(spreads)
    if expect is not None and {
            k: eager_launches[k] for k in expect} != expect:
        raise AssertionError(f"phase {phase}: {label}: eager launches "
                             f"{eager_launches}, expected {expect}")
    if expect is None and record:
        require_launches(phase, eager_launches)
    t0 = time.perf_counter()
    replay(0)                        # warm-up, capture and a replay
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    if not all(p.captured for p in progs):
        raise AssertionError(f"phase {phase}: {label}: no graph captured")
    ptrs = [[x.data_ptr() for x in p._outputs[0]] for p in progs]
    intersect.reset_launch_counts()
    r0 = replay(0)
    torch.cuda.synchronize()
    replay_launches = dict(intersect.LAUNCHES)
    r1 = replay(1)
    r0b = replay(0)
    torch.cuda.synchronize()
    total = counted(intersect)
    if replay_launches != eager_launches:
        raise AssertionError(f"phase {phase}: {label}: a replay launched "
                             f"{replay_launches}, the eager step "
                             f"{eager_launches}")
    if [[x.data_ptr() for x in p._outputs[0]] for p in progs] != ptrs:
        raise AssertionError(f"phase {phase}: {label}: an output buffer "
                             "moved between replays")
    if eager_launches["segsum"] == 0:
        raise AssertionError(f"phase {phase}: {label}: the fixed-order sum "
                             f"(segsum) never launched ({eager_launches})")
    if check is not None:
        check(r0)
    diffs = {name: gate_replay(phase, f"{label} at {name}",
                               _floats(r, n_gated), e, spread)
             for name, r, e in (("seed 0", r0, a), ("seed 1", r1, c),
                                ("seed 0 again", r0b, a))}
    # phase 31: two more replays at seed 0, every output the first's
    # bit for bit (the updated state too, where it is not gated
    # against eager)
    first = [host(x) for x in _floats(r0)]
    for _ in range(2):
        again = [host(x) for x in _floats(replay(0))]
        if not all(np.array_equal(x, y) for x, y in zip(again, first)):
            raise AssertionError(f"phase 31: {label}: a repeated replay "
                                 "at seed 0 differs from the first")
    # the first output (the loss, the masses) at seeds 1 and 0: as far
    # apart replayed as eager, and far beyond its own spread
    seed_gap = rel_l2(host(_floats(r1, 1)[0]), host(_floats(r0, 1)[0]))
    eager_gap = rel_l2(host(c[0]), host(a[0]))
    if not (seed_gap > 0.5 * eager_gap
            and eager_gap > 100.0 * spreads[0]):
        raise AssertionError(f"phase {phase}: {label}: seeds 1 and 0 are "
                             f"{seed_gap:.3g} apart replayed, "
                             f"{eager_gap:.3g} eager (its spread "
                             f"{spreads[0]:.3g}): a key was baked in")
    times = {}
    for name, fn in (("eager", eager), ("replay", replay)):
        ts = []
        for i in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(2 + i)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        times[name] = ts
    top = []
    prof = {"eager": program_frame(lambda: eager(9)),
            "replay": program_frame(lambda: replay(9), top)}
    if any("indexing_backward" in k for k in top):
        raise AssertionError(f"phase {phase}: {label}: an indexing_backward "
                             "kernel is among the replay's top ten")
    calls = prof["replay"][3]
    if calls != len(progs):
        raise AssertionError(f"phase {phase}: {label}: a replay made {calls} "
                             f"host launch calls, {len(progs)} programs")
    summary = {
        "eager_spread": spread, "replay_vs_eager": diffs,
        "replay_repeats_equal": True,
        "seed_gap": seed_gap, "eager_seed_gap": eager_gap,
        "launches": replay_launches, "first_call_s": first_s,
        "capture_s": sum(p.capture_seconds for p in progs),
        "nodes": sum(p.nodes for p in progs),
        "pool_bytes": sum(p.pool_bytes for p in progs),
        "eager_s": float(np.median(times["eager"])),
        "replay_s": float(np.median(times["replay"])),
        "replay_top": top[:3],
        **{f"{name}_{k}": v for name, (wall, busy, kern, n_calls)
           in prof.items() for k, v in (
               ("profiled_wall_ms", wall), ("busy_ms", busy),
               ("idle", 1.0 - busy / wall), ("kernels", kern),
               ("host_launch_calls", n_calls))}}
    log(f"    eager steps {', '.join(f'{t:.4f}' for t in times['eager'])}"
        f" s, replays {', '.join(f'{t:.4f}' for t in times['replay'])} "
        f"s; first call (warm-ups, capture, replay) {first_s:.3f} s, "
        f"capture {summary['capture_s']:.3f} s, {summary['nodes']} graph "
        f"nodes, pool {summary['pool_bytes'] / 2**30:.3f} GiB; replay "
        f"within {max(diffs.values()):.3g} of eager (spread "
        f"{spread:.3g}); loss gap seeds 0 / 1 {seed_gap:.3g} (eager "
        f"{eager_gap:.3g}); launches {replay_launches}")
    log(f"    {json.dumps(summary)}")
    return summary, total, records


def gradient_phase(intersect, dev):
    """Phase 29: the gradient programs (``gradient_configs``). For each:
    the eager step at seeds 0, 0 (its run-to-run spread) and 1 and its
    launches; the programs captured (capture seconds, graph nodes, pool
    bytes); one replay's launches against the eager step's; replays at
    seeds 0, 1, 0 against the eager step of each seed: the eager step
    repeats itself and every gated output (the loss, every gradient leaf;
    the flagship's and the trainer's update) equals it bit for bit; two
    more replays at seed 0 equal to the first (phase 31); the fixed-order
    sum (segsum) launched; seed 1 against seed 0 as far apart as in the
    eager steps; the output
    buffers at the same addresses replay after replay; eager steps and
    replays timed (median of 3), one of each profiled (device busy, idle
    share, host launch calls: one a program), no ``indexing_backward``
    kernel among the replay's top ten; the flagship's eager step with its
    K1 and K2 launches recorded. Each configuration's programs are
    dropped before the next. Returns ({label: summary}, the launches of
    the replays at seeds 0, 1, 0 summed over e-j, the flagship's
    ``captured_shapes``)."""
    out, flag = {}, None
    total = {k: 0 for k in counted(intersect)}
    for label, make, expect in gradient_configs(dev):
        record = label.startswith("h")
        out[label], launches, records = gradient_case(
            intersect, label, make, expect, record=record)
        for k in total:
            total[k] += launches[k]
        if record:
            log(f"  K1 and K2 on the flagship step's own inputs (three "
                f"views, eager): {len(records)} distinct launches")
            flag = captured_shapes(intersect, records, None, "flagship")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return out, total, flag


# -- phase 30: the scene-query layer ------------------------------------------

def median_ms(fn) -> float:
    """Median device ms of ``fn`` over QUERY_REPS launches queued behind
    the spin kernel (``launch_times_ms``)."""
    return float(np.median(launch_times_ms(fn, QUERY_REPS)))


def sorted_case(intersect, label, flat, ray, act, tmax, any_hit):
    """A sweep through ``_closest_hit(sort_rays=True)`` against K1 on the
    same rays unsorted: the record equal bit for bit (a thread's walk
    depends on its ray alone, in any-hit mode too), then each timed: K1
    unsorted; the sort, the gathers in, K1 on the sorted batch and the
    scatters back (and, for any hits, the booleans' alone) apart; the
    whole sorted query. Returns the dict of times."""
    from psdr_tpu_torch.core.records import Ray
    from psdr_tpu_torch.scene import scene as q
    args = k1_args(flat, ray, act, tmax)
    exact(f"{label}: sorted against unsorted",
          q._closest_hit(flat, ray, act, tmax=tmax, sort_rays=True,
                         any_hit=any_hit),
          intersect.k1_cuda(*args, any_hit=any_hit))
    perm, _ = q._octant_sort(ray, act, want_inv=False)
    qo, qd, qa, qt = q._permuted(perm, ray, act, tmax)
    qargs = k1_args(flat, Ray(qo, qd), qa, qt)
    hq = intersect.k1_cuda(*qargs, any_hit=any_hit)
    t = {"unsorted_ms": median_ms(
            lambda: intersect.k1_cuda(*args, any_hit=any_hit)),
         "sort_ms": median_ms(lambda: q._octant_sort(ray, act,
                                                     want_inv=False)),
         "permute_in_ms": median_ms(lambda: q._permuted(perm, ray, act,
                                                        tmax)),
         "sorted_kernel_ms": median_ms(
            lambda: intersect.k1_cuda(*qargs, any_hit=any_hit)),
         "permute_out_ms": median_ms(lambda: q._unpermuted(hq, perm)),
         "sorted_ms": median_ms(lambda: q._closest_hit(
             flat, ray, act, tmax=tmax, sort_rays=True, any_hit=any_hit))}
    if any_hit:
        t["scatter_back_ms"] = median_ms(
            lambda: torch.zeros_like(hq.valid).scatter_(0, perm, hq.valid))
        t["sorted_test_ms"] = median_ms(lambda: q._closest_hit(
            flat, ray, act, tmax=tmax, sort_rays=True, any_hit=True,
            test_only=True))
    n = ray.o.shape[0]
    log(f"  {label} ({'any' if any_hit else 'closest'}, {int(act.sum())} "
        f"of {n} active): K1 unsorted {t['unsorted_ms']:.4f} ms, sorted "
        f"{t['sorted_kernel_ms']:.4f} ms; sort {t['sort_ms']:.4f}, permute "
        f"in {t['permute_in_ms']:.4f}, out {t['permute_out_ms']:.4f} ms; "
        f"the sorted query {t['sorted_ms']:.4f} ms")
    return dict(rays=n, active=int(act.sum()), any_hit=any_hit, **t)


def compacted_case(intersect, label, flat, ray, tmax, act, frac_shift):
    """``_ray_test_sparse`` (the compacted sweep and its residue) against
    the dense sweep on the same rays, lane for lane, then each timed: K1
    dense and unsorted; the sorted dense query (the JAX package's
    fallback); the sort, the gather of the two batches, K1 on the
    compacted head, K1 on the residue, the scatter back apart; the whole
    compacted query. Returns the dict of times and lane counts."""
    from psdr_tpu_torch.core.records import Ray
    from psdr_tpu_torch.scene import scene as q
    n = ray.o.shape[0]
    s = min(1 << 15 if n % (1 << 15) == 0 else 4096, n)
    ks = s >> frac_shift
    dense = q._closest_hit(flat, ray, act, tmax=tmax, any_hit=True,
                           test_only=True) & act
    got = q._ray_test_sparse(flat, ray, tmax, act, frac_shift=frac_shift)
    if got is None or not torch.equal(got & act, dense) or not dense.any():
        raise AssertionError(f"phase 30: {label}: the compacted sweep "
                             "differs from the dense one, or nothing is "
                             "occluded")
    counts = act.reshape(n // s, s).sum(dim=1)
    residue = int(torch.clamp(counts - ks, min=0).sum())
    perm, _ = q._octant_sort(ray, act, want_inv=False)
    head, rest = q._compacted(perm, ray, tmax, act, s, ks)
    hargs = k1_args(flat, Ray(*head[:2]), *head[2:])
    rargs = k1_args(flat, Ray(*rest[:2]), *rest[2:])
    hk = intersect.k1_cuda(*hargs, any_hit=True)
    hr = intersect.k1_cuda(*rargs, any_hit=True)
    args = k1_args(flat, ray, act, tmax)
    t = {"dense_ms": median_ms(
            lambda: intersect.k1_cuda(*args, any_hit=True)),
         "sorted_dense_ms": median_ms(lambda: q._closest_hit(
             flat, ray, act, tmax=tmax, any_hit=True, sort_rays=True,
             test_only=True)),
         "sort_ms": median_ms(lambda: q._octant_sort(ray, act,
                                                     want_inv=False)),
         "gather_ms": median_ms(lambda: q._compacted(perm, ray, tmax, act,
                                                     s, ks)),
         "head_kernel_ms": median_ms(
            lambda: intersect.k1_cuda(*hargs, any_hit=True)),
         "residue_kernel_ms": median_ms(
            lambda: intersect.k1_cuda(*rargs, any_hit=True)),
         "scatter_ms": median_ms(lambda: q._scattered(
             perm, hk.valid & head[2], hr.valid, s, ks)),
         "compacted_ms": median_ms(lambda: q._ray_test_sparse(
             flat, ray, tmax, act, frac_shift=frac_shift))}
    log(f"  {label} (1/{1 << frac_shift} cap: {ks} of {s} lanes a segment;"
        f" {int(act.sum())} of {n} active, {residue} past the cap, "
        f"{int(dense.sum())} occluded): K1 dense {t['dense_ms']:.4f} ms; "
        f"compacted {t['compacted_ms']:.4f} ms = sort {t['sort_ms']:.4f} + "
        f"gather {t['gather_ms']:.4f} + head {t['head_kernel_ms']:.4f} + "
        f"residue {t['residue_kernel_ms']:.4f} + scatter "
        f"{t['scatter_ms']:.4f}; sorted dense {t['sorted_dense_ms']:.4f} ms")
    return dict(rays=n, active=int(act.sum()), past_cap=residue,
                frac_shift=frac_shift, **t)


def record_sparse_sweeps(fn):
    """(``fn()``, {caller: [(ray, tmax, active, frac_shift), ...]}): the
    inputs of every compacted sweep of each integrator function during
    ``fn``, copied."""
    from psdr_tpu_torch.core.records import Ray
    from psdr_tpu_torch.integrator import direct as direct_mod
    from psdr_tpu_torch.scene import scene as q
    seen, inner = {}, q._ray_test_sparse

    def record(flat, ray, tmax, active, frac_shift=3, seg=1 << 15):
        f = sys._getframe(1)
        while f is not None and not f.f_globals.get(
                "__name__", "").startswith("psdr_tpu_torch.integrator"):
            f = f.f_back
        seen.setdefault(f"{f.f_code.co_name} 1/{1 << frac_shift}", []).append(
            (Ray(ray.o.detach().clone(), ray.d.detach().clone()),
             tmax.detach().clone(), active.clone(), frac_shift))
        return inner(flat, ray, tmax, active, frac_shift=frac_shift, seg=seg)
    q._ray_test_sparse = direct_mod._ray_test_sparse = record
    try:
        out = fn()
    finally:
        q._ray_test_sparse = direct_mod._ray_test_sparse = inner
    return out, seen


def ordering_shapes(intersect, dev, env_sc):
    """Phase 30, first part: the direction sort and the compacted sweeps
    at the paths' own shapes (``sorted_case``, ``compacted_case``): the
    PathTracer's depth-2 and depth-3 bounce (closest) and shadow (any)
    sweeps of phase 14's first chunk; the sky shadow sweep of
    ``env_bench_scene`` (phase 20's chunk), which NEE sorts under an
    envmap; the compacted sweeps of one eager ``DirectIntegrator(1, 1)``
    frame at phase 5's config (the emitter-first occlusion sweep,
    visibility reuse's probes and its quarter-cap second sweep, each in
    the chunk where it finds the most occluded lanes); and a dense sweep
    that overflows the cap
    (the depth-2 shadow sweep compacted). Returns {shape: dict}."""
    from psdr_tpu_torch import DirectIntegrator
    from psdr_tpu_torch.core import threefry
    from psdr_tpu_torch.scene import scene as scene_mod
    from psdr_tpu_torch.scene.scene import detach_flat
    from psdr_tpu_torch.testing.scenes import (tiled_material_rays,
                                               tiled_path_rays)
    out = {}
    sc, flat = bench_scene(dev)
    if flat.accel_kind != "pallas":
        raise AssertionError(f"phase 30: accel_mode 'auto' gives "
                             f"{flat.accel_kind!r} on the card, not K1's")
    with torch.no_grad():
        sweeps = tiled_path_rays(sc, flat, N_TIME, BENCH["spp"], 2, depth=3)
        for name, any_hit in (("depth 2 bounce", False),
                              ("depth 3 bounce", False),
                              ("depth 2 shadow", True),
                              ("depth 3 shadow", True)):
            out[f"path {name}"] = sorted_case(intersect, f"path {name}",
                                              flat, *sweeps[name], any_hit)
        env_flat = detach_flat(env_sc.flat)
        chunk = max(0, env_sc.opts.num_pixels * env_sc.opts.spp
                    // N_TIME // 2 - 1)
        ray, act, tmax = tiled_material_rays(
            env_sc, env_flat, N_TIME, env_sc.opts.spp, 2,
            chunk=chunk)["sky shadow"]
        out["env NEE sky shadow"] = sorted_case(
            intersect, "env NEE sky shadow", env_flat, ray, act, tmax, True)
        del env_flat
        render = DirectIntegrator(1, 1).render_fn(sc, with_boundary=False,
                                                  detached=True)
        _, seen = record_sparse_sweeps(
            lambda: render(sc.params(), threefry.PRNGKey(1)))
        if set(seen) != {"Li 1/8", "_nee_visibility_impl 1/8",
                         "_sparse_or_plain_test 1/4"}:
            raise AssertionError(f"phase 30: the forward's compacted sweeps "
                                 f"are {sorted(seen)}")
        for name, calls in seen.items():
            # the chunk with the most occluded lanes
            ray, tmax, act, shift = max(calls, key=lambda c: int((
                scene_mod._closest_hit(flat, c[0], c[2], tmax=c[1],
                                       any_hit=True, test_only=True)
                & c[2]).sum()))
            out[f"forward {name}"] = compacted_case(
                intersect, f"forward {name}", flat, ray, tmax, act, shift)
        del seen
        ray, act, tmax = sweeps["depth 2 shadow"]
        case = compacted_case(intersect, "overflowing: path depth 2 shadow",
                              flat, ray, tmax, act, 3)
        if case["past_cap"] == 0:
            raise AssertionError("phase 30: the overflow case fits its cap")
        out["overflowing path depth 2 shadow"] = case
    return out


def accel_mode_phase(intersect, bvh_mod, dev, reference):
    """Phase 30, second part: ``renderC`` of the 64x64 gate scene under
    each ``Scene.accel_mode`` on the card against the CPU
    (``render_check``, its side from ``reference``) under phase 4's
    gates, with the kernels each launched on the card (K1 under "auto",
    "pallas" and "bvh_walk", K3 under "culled" and its alias "bvh", no
    tree under "brute"; K2 always, for the emitter-first sweep); then a
    tree of 8-triangle leaves (``accel_leaf_size``) on the bench scene,
    K1 and K3 against ``k1_plain`` on phase 3's rays. Returns {mode:
    launches}."""
    from psdr_tpu_torch.scene.scene import ACCEL_MODES, detach_flat
    from psdr_tpu_torch.testing.scenes import cbox_scene, scene_rays
    kernel = {"auto": "k1", "pallas": "k1", "bvh_walk": "k1", "culled": "k3",
              "bvh": "k3", "brute": None}
    out = {}
    for mode in ACCEL_MODES:
        intersect.reset_launch_counts()
        render_check(dev, reference, 30, f"accel_mode {mode!r}", f"30 {mode}",
                     ((IMG_RTOL, IMG_CLOSE_FRAC),))
        got = dict(intersect.LAUNCHES)
        k1 = got["closest"] + got["any"]
        want = kernel[mode]
        if (got["k2"] == 0 or (k1 > 0) != (want == "k1")
                or (got["k3"] > 0) != (want == "k3")
                or (mode == "bvh_walk" and got["any"])):
            raise AssertionError(f"phase 30: accel_mode {mode!r} launched "
                                 f"{got}")
        log(f"    launches {got}")
        out[mode] = got
    sc = cbox_scene(**BENCH, device=dev)
    sc.accel_leaf_size = 8
    sc.prepare_accel()
    flat = detach_flat(sc.build(sc.params()))
    log(f"  leaf size 8: {flat.accel.num_leaves} leaves of "
        f"{flat.accel.leaf_size}, {bvh_mod.wide_layout(flat.accel.num_leaves)}")
    err = {"closest": [], "any": []}
    compare = comparer(err, (flat.tri.p0, flat.tri.e1, flat.tri.e2))
    for label, rays in zip(("camera", "bounce", "shadow"),
                           scene_rays(sc, flat, N_CHECK, 1)):
        args = k1_args(flat, *rays)
        hp = intersect.k1_plain(*args)
        for any_hit in ((False, True) if rays[2] is None else (True,)):
            compare(f"leaf size 8 {label}", args,
                    intersect.k1_cuda(*args, any_hit=any_hit), hp, any_hit)
        exact(f"leaf size 8 {label}: K3 (ray_intersect_culled)",
              bvh_mod.ray_intersect_culled(*args), hp)
    return out


def envmap_lifetime_phase(dev):
    """Phase 30, last part (ROADMAP item 25): ``render_program`` captured
    on a sky above 2^15 cells (ENV_SKY: a 398 x 198 frozen table), then
    SNAPSHOTS new radiance snapshots pushed through ``set_params`` and
    built (the host cache evicts the table), the allocator's free memory
    released and refilled with NaN, in blocks of the table's sizes on
    NAN_STREAMS streams of the pool and larger ones, and a replay: it
    must equal
    the capture-time eager render bit for bit (eager repeats itself).
    Returns the replay's largest difference from eager."""
    import gc
    import weakref
    from psdr_tpu_torch import DirectIntegrator
    from psdr_tpu_torch.convert import params_from_numpy
    from psdr_tpu_torch.core import threefry
    from psdr_tpu_torch.testing.scenes import env_scene
    sky = np.random.default_rng(4).uniform(0.1, 1.0, (*ENV_SKY, 3)).astype(
        np.float32)
    sc = env_scene(None, **ENV_SMALL, sky=sky, device=dev)
    integ = DirectIntegrator(1, 1)
    params = params_from_numpy(sc.params(), device=dev)
    render = integ.render_fn(sc, with_boundary=False, detached=True)
    with torch.no_grad():
        e0, e0b = (render(params, threefry.PRNGKey(5)) for _ in range(2))
    spread = float((e0 - e0b).abs().max())
    prog = integ.render_program(sc, with_boundary=False, detached=True)
    key = threefry.PRNGKey(5, device=dev)
    first = prog(params, key)
    cmf = sc.flat.envmap.cell_distrb.distrb.cmf
    table, sizes = weakref.ref(cmf), {cmf.numel()}
    sc._flat_cache = None
    del cmf
    rad = sc.emitters[0].radiance.data
    for k in range(SNAPSHOTS):
        p = sc.params()
        p["emitters"][0] = dict(p["emitters"][0],
                                radiance=rad * np.float32(1 + (k + 1) / 64))
        sc.set_params(p)
        sc.configure()
    sc._flat_cache = None
    gc.collect()
    torch.cuda.empty_cache()
    # freed blocks stay with the stream that allocated them: the table was
    # made in a warm-up on a pooled side stream, so refill on every one
    junk = []
    for _ in range(NAN_STREAMS):
        with torch.cuda.stream(torch.cuda.Stream(dev)):
            junk += [torch.full((m,), float("nan"), device=dev)
                     for m in sorted(sizes) for _ in range(8)]
    junk += [torch.full((1 << 24,), float("nan"), device=dev)
             for _ in range(16)]
    torch.cuda.synchronize()
    replay = prog(params, key)
    torch.cuda.synchronize()
    del junk
    d = float((replay - e0).abs().max())
    log(f"  envmap table after {SNAPSHOTS} snapshots: held by the program "
        f"{table() is not None}; replay against the eager render {d:.3g} "
        f"(eager spread {spread:.3g}; first replay {float((first - e0).abs().max()):.3g})")
    ok = spread == 0.0 and torch.equal(replay, e0)
    if table() is None or not ok or not torch.isfinite(replay).all():
        raise AssertionError("phase 30: the replay after the envmap table's "
                             f"eviction differs from eager by {d}")
    return d



# -- phase 31: reproducibility ------------------------------------------------

class LaunchHasher:
    """While it stands, every K1 and K2 launch outside a capture leaves a
    digest of its rays (o, d, active, tmax) and of its record (valid, t,
    tri_id, uv): a position-weighted sum of each tensor's 32-bit words in
    int64 (integer adds: one value whatever their order), on the card, and
    its count of active rays. ``stop()`` ends it and returns [(mode, rays,
    active rays, [8 digests])], read back once."""

    def __init__(self, intersect):
        self.intersect = intersect
        self.k1, self.k2 = intersect.k1_cuda, intersect.k2_cuda
        self.weights, self.rows = {}, []
        intersect.k1_cuda, intersect.k2_cuda = self.k1_hash, self.k2_hash

    def digest(self, *xs):
        out = []
        for x in xs:
            v = x.detach().contiguous().reshape(-1)
            v = (v.to(torch.int32) if v.dtype == torch.bool
                 else v.view(torch.int32))
            w = self.weights.get(v.numel())
            if w is None:
                w = self.weights[v.numel()] = (torch.arange(
                    v.numel(), dtype=torch.int64, device=v.device)
                    * 2654435761 % (1 << 31) + 1)
            out.append((v.long() * w).sum())
        return torch.stack(out)

    def record(self, mode, rays, hit):
        if not torch.cuda.is_current_stream_capturing():
            o, d, active, tmax = rays
            self.rows.append((mode, o.shape[0], active.sum(), self.digest(
                o, d, active, tmax, hit.valid, hit.t, hit.tri_id, hit.uv)))
        return hit

    def k1_hash(self, bvh, ray_o, ray_d, active, tmax, any_hit=False,
                counts=None):
        return self.record("any" if any_hit else "closest",
                           (ray_o, ray_d, active, tmax),
                           self.k1(bvh, ray_o, ray_d, active, tmax,
                                   any_hit=any_hit, counts=counts))

    def k2_hash(self, *args):
        return self.record("k2", args[3:], self.k2(*args))

    def stop(self):
        self.intersect.k1_cuda, self.intersect.k2_cuda = self.k1, self.k2
        torch.cuda.synchronize()
        return [(m, n, int(a), [int(v) for v in h.cpu()])
                for m, n, a, h in self.rows]


def hashed_trainer(intersect, dev, cfg, steps):
    """``steps`` eager trainer steps (phase 22's: the textured bench scene
    at ``cfg``, the occluder from ``flagship_deform``, ``Optimizer`` on its
    vertices through every boundary term, keys 0, 1, ...) under a
    ``LaunchHasher``: {"launches": its records, "marks": the launch count
    after each step, "losses": each step's loss as float.hex, "vertices":
    the final vertices as float32 bytes in hex}."""
    import dataclasses
    from psdr_tpu_torch import DirectIntegrator
    from psdr_tpu_torch.convert import params_from_numpy
    from psdr_tpu_torch.core import threefry
    from psdr_tpu_torch.opt import Optimizer
    from psdr_tpu_torch.testing.scenes import flagship_deform
    sc = textured_cbox(cfg, dev)
    sc.opts = dataclasses.replace(sc.opts, sppe=cfg["sppe"],
                                  sppse=cfg["sppse"])
    integ = DirectIntegrator(1, 1)
    with torch.no_grad():
        target = integ.render_fn(sc, with_boundary=False, detached=True)(
            params_from_numpy(sc.params(), device=dev),
            threefry.PRNGKey(1000))
    mesh = sc.meshes[OCCLUDER]
    mesh.vertex_positions = flagship_deform(np.asarray(mesh.vertex_positions))
    opt = Optimizer(sc, [f"Mesh[{OCCLUDER}].vertex_positions"], lr=1e-2)
    render = integ.render_fn(sc, with_boundary=True)

    def loss_fn(p, key):
        return torch.mean((render(p, key) - target) ** 2)
    hasher = LaunchHasher(intersect)
    marks, losses = [], []
    try:
        for k in range(steps):
            losses.append(float(opt.step(loss_fn, threefry.PRNGKey(k))).hex())
            marks.append(len(hasher.rows))
    finally:
        rows = hasher.stop()
    v = host(opt.params["meshes"][OCCLUDER]["vertex_positions"])
    return {"launches": rows, "marks": marks, "losses": losses,
            "vertices": v.astype(np.float32).tobytes().hex()}


def first_difference(a, b) -> str | None:
    """Where two ``hashed_trainer`` runs part: None where they agree in
    every launch, loss and vertex; else the first differing launch (its
    step, kind and which digests), or what else differs."""
    names = ("o", "d", "active", "tmax", "valid", "t", "tri_id", "uv")
    for i, (x, y) in enumerate(zip(a["launches"], b["launches"])):
        if x != y:
            step = sum(1 for m in a["marks"] if m <= i)
            return (f"launch {i} (step {step}, {x[0]}, {x[1]} rays): "
                    + ", ".join(n for n, p, q in zip(names, x[3], y[3])
                                if p != q))
    for key in ("marks", "losses", "vertices"):
        if a[key] != b[key] or len(a["launches"]) != len(b["launches"]):
            return f"{key} differ"
    return None


def repro_child(path: str) -> int:
    """The second process of phase 31: REPRO_SMALL's hashed trainer run,
    written to ``path`` as JSON."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from psdr_tpu_torch.accel import intersect
    intersect.load_library()
    torch.backends.cuda.matmul.allow_tf32 = False
    run = hashed_trainer(intersect, torch.device(DEVICE), REPRO_SMALL,
                         REPRO_STEPS)
    with open(path, "w") as f:
        json.dump(run, f)
    return 0


def boundary_lanes(intersect, dev):
    """Phase 12's boundary step (value and gradient, eager) on a scene
    built afresh: (its ``LaunchHasher`` records, the active rays of each of
    its launches on the compacted 131,072-lane wavefront)."""
    from psdr_tpu_torch import DirectIntegrator
    from psdr_tpu_torch.convert import params_from_numpy
    from psdr_tpu_torch.core import threefry
    from psdr_tpu_torch.testing.scenes import cbox_scene
    sc = cbox_scene(**RENDERD, device=dev)
    prog = DirectIntegrator(1, 1).grad_program(
        sc, torch.zeros((sc.opts.num_pixels, 3), device=dev),
        with_boundary=True)
    params = params_from_numpy(sc.params(), device=dev)
    hasher = LaunchHasher(intersect)
    try:
        with torch.enable_grad():
            prog.fn(params, threefry.PRNGKey(3))
    finally:
        rows = hasher.stop()
    return rows, [a for _, n, a, _ in rows if n == 131072]


def segsum_shape(intersect, dev, name, keys, values, rows, order, idx,
                 phase=31):
    """The fixed-order sum of ``values`` onto ``rows`` by the sorted
    ``keys`` (``order`` their sort, or None; ``idx`` each lane's row in
    lane order): the kernel against its plain version bit for bit and
    against itself, timed beside its sort, its plain version and
    ``index_add_``, with its bound and its launches a sum. Returns its
    dict."""
    from psdr_tpu_torch.core import segsum
    from psdr_tpu_torch.testing.bench_kernels import segsum_bytes
    before = intersect.LAUNCHES["segsum"]
    got = segsum.segsum_cuda(keys, values, rows, order)
    levels = intersect.LAUNCHES["segsum"] - before
    again = segsum.segsum_cuda(keys, values, rows, order)
    plain = segsum.segsum_plain(keys, values, rows, order)
    if not (torch.equal(got, again) and torch.equal(got, plain)):
        raise AssertionError(f"phase {phase}: segsum on {name}: the kernel "
                             f"differs from its plain version by "
                             f"{float((got - plain).abs().max())} or "
                             "from itself")
    keep = idx >= 0                  # each lane's row, in lane order
    exact = torch.zeros(rows, values.shape[1], dtype=torch.float64,
                        device=dev).index_add_(
        0, idx.clamp(min=0), values.double() * keep[:, None])
    c = values.shape[1]
    ms, _ = time_ms(lambda: segsum.segsum_cuda(keys, values, rows, order),
                    20, spin=True)
    sort_ms = (None if order is None else
               time_ms(lambda: segsum.sort_keys(idx, rows), 20,
                       spin=True)[0])
    plain_ms, _ = time_ms(
        lambda: segsum.segsum_plain(keys, values, rows, order), 3)
    lib_ms, _ = time_ms(lambda: torch.zeros(
        rows, c, device=dev).index_add_(0, idx.clamp(min=0), values), 20,
        spin=True)
    # keys (int32), the sort's order (int64) and the values read once,
    # the rows written once, against n * c float adds
    n = keys.numel()
    b_ms, b_by = bound(segsum_bytes(n, rows, c, order is not None), n * c)
    out = {"lanes": n, "channels": c, "rows": rows,
           "launches": levels, "max_abs_err": 0.0,
           "err_vs_float64": float((got.double() - exact).abs().max()),
           "ms": ms, "sort_ms": sort_ms, "plain_ms": plain_ms,
           "library_ms": lib_ms, "bound_ms": b_ms,
           "bound_by": b_by, "bound_share": b_ms / ms}
    sort_txt = "none" if sort_ms is None else f"{sort_ms:.4f}"
    log(f"  segsum, {name}: {n} lanes x {c} onto {rows} rows, "
        f"{levels} launches: kernel = plain bit for bit and = itself; "
        f"{ms:.4f} ms (sort {sort_txt}, plain {plain_ms:.3f}, "
        f"index_add_ {lib_ms:.4f}), bound {b_ms:.4f} ms by {b_by} "
        f"({b_ms / ms:.3f}); against a float64 sum "
        f"{out['err_vs_float64']:.3g}")
    return out


def segsum_phase(intersect, dev):
    """Phase 31, the fixed-order sum (``core/segsum.py``, ``csrc/segsum
    .cu``; no TPU kernel's port): the kernel against its plain version on
    the card, bit for bit (tolerance 0), and run twice, equal; on the main
    path's own inputs (the largest sum of an eager (e) step: the
    recompute's face-table gather backward, and the same step's vertex
    gather of the occluder, 61,440 corners x 3 onto 10,242 vertices) and
    on ``bench_kernels.segsum_cases``: a hot-row shape (2^20 lanes onto row
    0, 2^19 onto row 1, the rest over 20,490 rows), a cold-row one (2^21
    lanes spread evenly), a pixel one (the compacted wavefront's 131,072
    lanes, 3 channels) and the guiding masses (GUIDING's 864 lanes x 1, in
    cell order: no sort, no ``order``); each timed (CUDA events, 20
    launches behind the spin kernel), beside its sort, its plain version
    and ``index_add_`` (the library call, atomic), with its bound and its
    launches a sum. Returns {shape: dict}, the main shape's name."""
    from psdr_tpu_torch import DirectIntegrator
    from psdr_tpu_torch.convert import params_from_numpy
    from psdr_tpu_torch.core import segsum, threefry
    from psdr_tpu_torch.testing.bench_kernels import segsum_cases
    from psdr_tpu_torch.testing.scenes import cbox_scene
    seen = []
    launch = segsum.segsum_cuda

    def record(keys, values, num_rows, order=None):
        seen.append((keys, values, num_rows, order))
        return launch(keys, values, num_rows, order)
    sc = cbox_scene(**BWD, device=dev)
    prog = DirectIntegrator(1, 1).grad_program(
        sc, torch.zeros((sc.opts.num_pixels, 3), device=dev),
        with_boundary=False)
    segsum.segsum_cuda = record
    try:
        with torch.enable_grad():
            prog.fn(params_from_numpy(sc.params(), device=dev),
                    threefry.PRNGKey(0))
    finally:
        segsum.segsum_cuda = launch
    main = max(seen, key=lambda a: a[0].numel() * a[1].shape[1])
    verts = sc.meshes[OCCLUDER].vertex_positions.shape[0]
    vertex = next(a for a in seen if a[2] == verts and a[1].shape[1] == 3)
    shapes = {}
    for name, (keys, values, rows, order) in (
            ("main: (e)'s face-table gather backward", main),
            ("vertex gather", vertex)):
        lane = torch.empty_like(order)
        lane[order] = torch.arange(order.numel(), device=dev)
        shapes[name] = (keys, values, rows, order, keys[lane].long())
    for name, (idx, rows, values, pre) in segsum_cases(
            dev, main[2]).items():
        keys, order = ((idx.to(torch.int32), None) if pre
                       else segsum.sort_keys(idx, rows))
        shapes[name] = (keys, values, rows, order, idx)
    out = {name: segsum_shape(intersect, dev, name, *args)
           for name, args in shapes.items()}
    return out, next(iter(shapes))


def reproducibility_phase(intersect, dev, programs, grad_programs):
    """Phase 31: the port repeats itself bit for bit.
    Phases 28 and 29 already replayed each of (a)-(j) twice more at seed
    0, every output equal to the first, and ran each eager step of (a)-(j)
    twice, equal (their eager spread is 0; (e), (g) and (i) among them).
    Here: REPRO_STEPS eager trainer steps at phase 22's config, twice,
    every K1 and K2 launch's rays and record hashed (``LaunchHasher``),
    equal launch for launch with equal losses and vertices; a second
    process (``chip_smoke.py --repro-child``) running REPRO_SMALL's trainer
    against the same run in this one; phase 12's boundary step on two
    builds of its scene, equal launch for launch, its compacted
    wavefront's active lanes equal; the fixed-order sum against its plain
    version (``segsum_phase``). Returns (a summary, segsum_phase's)."""
    bad = [label for label, summ in {**programs, **grad_programs}.items()
           if summ["eager_spread"] != 0.0
           or not summ.get("replay_repeats_equal")]
    if bad:
        raise AssertionError(f"phase 31: not bit for bit: {bad}")
    log(f"  (a)-(j): each replayed three times at seed 0, equal; each "
        f"eager step run twice, equal (phases 28, 29)")
    t0 = time.time()
    runs = [hashed_trainer(intersect, dev, TRAIN, REPRO_STEPS)
            for _ in range(2)]
    diff = first_difference(*runs)
    if diff is not None:
        raise AssertionError(f"phase 31: two passes of {REPRO_STEPS} eager "
                             f"trainer steps part at {diff}")
    log(f"  {REPRO_STEPS} eager trainer steps at {TRAIN}, twice: "
        f"{len(runs[0]['launches'])} K1 and K2 launches each, equal launch "
        f"for launch (rays and records), losses and vertices equal "
        f"({time.time() - t0:.1f} s)")
    t0 = time.time()
    mine = hashed_trainer(intersect, dev, REPRO_SMALL, REPRO_STEPS)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "child.json")
        child = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--repro-child", path],
            cwd=ROOT, capture_output=True, text=True, timeout=RANK_TIMEOUT)
        if child.returncode != 0:
            raise AssertionError(f"phase 31: the second process failed:\n"
                                 f"{child.stdout[-2000:]}"
                                 f"{child.stderr[-4000:]}")
        with open(path) as f:
            theirs = json.load(f)
    theirs["launches"] = [tuple(r) for r in theirs["launches"]]
    diff = first_difference(mine, theirs)
    if diff is not None:
        raise AssertionError(f"phase 31: the second process parts from "
                             f"this one at {diff}")
    log(f"  a second process, {REPRO_STEPS} eager trainer steps at "
        f"{REPRO_SMALL}: its {len(mine['launches'])} launches, losses and "
        f"vertices equal this process's ({time.time() - t0:.1f} s)")
    (rows_a, lanes_a), (rows_b, lanes_b) = (boundary_lanes(intersect, dev)
                                            for _ in range(2))
    if rows_a != rows_b or not lanes_a:
        raise AssertionError(f"phase 31: phase 12's boundary step differs "
                             f"between two builds (compacted active lanes "
                             f"{lanes_a} / {lanes_b})")
    log(f"  phase 12's boundary step on two builds: equal launch for launch; "
        f"active lanes of its compacted sweeps {lanes_a}")
    seg, main = segsum_phase(intersect, dev)
    return {"trainer_launches": len(runs[0]["launches"]),
            "child_launches": len(mine["launches"]),
            "compacted_active_lanes": lanes_a}, (seg, main)


# -- phase 32: the reference's representative gradient configuration --------

def guiding_build(intersect, dev, sc, integ):
    """Phase 32 (1): ``preprocess_secondary_edges`` at GUIDING_REF on
    ``sc`` through ``integ``: the first call (the program's eager warm-up,
    its capture and a replay), the program's body eagerly with a host key
    (its seconds, launches and the segsum launches a round), a replay with
    a second seed (the build as a later call makes it: seconds, profiled
    for the replay's idle share), then the build again at the first seed.
    Gates: the second build at a seed equals the first bit for bit (pmf and
    cmf), the replay's masses equal the eager body's bit for bit, every
    mass finite and >= 0, some cell positive, the cmf non-decreasing and
    ending at the total (the pmf's float64 sum within 1e-5). The cmf's
    ``prefix_sum`` over the 1,000,000 cells timed, repeated equal. Leaves
    ``integ`` holding the first seed's table. Returns (a summary, the
    first call's launches, the inputs of one round's per-cell sum (keys,
    values, rows))."""
    from psdr_tpu_torch.core import segsum, threefry
    from psdr_tpu_torch.integrator.direct import guiding_programs
    reso, nrounds, seed = (GUIDING_REF[k] for k in ("reso", "nrounds",
                                                    "seed"))
    n_cells = int(np.prod(reso[:3]))
    lanes = n_cells * reso[3]
    before = dict(intersect.LAUNCHES)
    t0 = time.perf_counter()
    integ.preprocess_secondary_edges(sc, 0, **GUIDING_REF)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    build_launches = {k: intersect.LAUNCHES[k] - before[k] for k in before}
    table = integ.warpper[0]
    (prog,) = guiding_programs(integ).values()
    # the body op by op with a host key; the first round's sum recorded
    seen, launch = [], segsum.segsum_cuda

    def record(keys, values, num_rows, order=None):
        if not seen:
            seen.append((keys, values, num_rows))
        return launch(keys, values, num_rows, order)
    mid = dict(intersect.LAUNCHES)
    torch.cuda.reset_peak_memory_stats()
    segsum.segsum_cuda = record
    try:
        t0 = time.perf_counter()
        with torch.no_grad():
            eager = prog.fn(threefry.PRNGKey(seed))
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t0
    finally:
        segsum.segsum_cuda = launch
    eager_peak = torch.cuda.max_memory_allocated()
    eager_launches = {k: intersect.LAUNCHES[k] - mid[k] for k in mid}
    replayed = prog(threefry.PRNGKey(seed, device=dev))
    if not torch.equal(replayed, eager):
        raise AssertionError(
            f"phase 32: the build's replay differs from its eager body by "
            f"{float((replayed - eager).abs().max())}: not bit for bit")
    t0 = time.perf_counter()
    integ.preprocess_secondary_edges(sc, 0, **dict(GUIDING_REF,
                                                   seed=seed + 1))
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    other = integ.warpper[0]
    wall, busy, kern, calls = program_frame(
        lambda: prog(threefry.PRNGKey(seed + 1, device=dev)))
    integ.preprocess_secondary_edges(sc, 0, **GUIDING_REF)
    again = integ.warpper[0]
    if not (torch.equal(again.distrb.pmf, table.distrb.pmf)
            and torch.equal(again.distrb.cmf, table.distrb.cmf)):
        raise AssertionError("phase 32: a second build at the same seed "
                             "differs from the first")
    if torch.equal(other.distrb.pmf, table.distrb.pmf):
        raise AssertionError("phase 32: the builds at two seeds are equal: "
                             "a key was baked in")
    pmf, cmf = table.distrb.pmf, table.distrb.cmf
    total = float(pmf.double().sum())
    if (pmf.shape != (n_cells,) or not bool(torch.isfinite(pmf).all())
            or bool((pmf < 0).any()) or not bool((pmf > 0).any())):
        raise AssertionError(f"phase 32: masses of shape {tuple(pmf.shape)}"
                             f", finite {bool(torch.isfinite(pmf).all())}, "
                             f"{int((pmf > 0).sum())} positive, "
                             f"{int((pmf < 0).sum())} negative")
    if (bool((cmf[1:] < cmf[:-1]).any())
            or float(cmf[-1]) != float(table.distrb.total)
            or abs(float(cmf[-1]) - total) > 1e-5 * total):
        raise AssertionError(f"phase 32: the cmf decreases or ends at "
                             f"{float(cmf[-1])}, not at the total {total}")
    cmf_ms, scan = time_ms(lambda: segsum.prefix_sum(pmf), 5)
    if not torch.equal(scan, segsum.prefix_sum(pmf)):
        raise AssertionError("phase 32: prefix_sum over the masses differs "
                             "from itself")
    summary = {
        "cells": n_cells, "lanes_a_round": lanes, "rounds": nrounds,
        "first_call_s": first_s, "eager_s": eager_s, "replay_s": replay_s,
        "capture_s": prog.capture_seconds, "nodes": prog.nodes,
        "pool_bytes": prog.pool_bytes, "eager_peak_bytes": eager_peak,
        "replay_profiled_wall_ms": wall, "replay_busy_ms": busy,
        "replay_idle": 1.0 - busy / wall, "replay_host_launch_calls": calls,
        "eager_launches": eager_launches,
        "segsum_launches_a_round": eager_launches["segsum"] / nrounds,
        "cells_with_mass": int((pmf > 0).sum()), "total": total,
        "largest_cell": float(pmf.max()), "prefix_sum_ms": cmf_ms}
    log(f"  {n_cells} cells x {reso[3]} samples x {nrounds} rounds "
        f"({lanes} lanes a round): first call (eager warm-up, capture, "
        f"replay) {first_s:.3f} s; eager body {eager_s:.3f} s (peak "
        f"{eager_peak / 2**30:.2f} GiB, launches {eager_launches}); a build "
        f"at another seed {replay_s:.4f} s (replay busy {busy:.1f} of "
        f"{wall:.1f} ms, idle {1.0 - busy / wall:.3f}, {calls} host launch "
        f"calls); capture {prog.capture_seconds:.3f} s, {prog.nodes} graph "
        f"nodes, pool {prog.pool_bytes / 2**30:.3f} GiB; "
        f"{summary['cells_with_mass']} cells with mass, largest "
        f"{summary['largest_cell']:.4g}, total {total:.6g}; replay = eager "
        f"and build = build at one seed, bit for bit; cmf non-decreasing, "
        f"ends at the total; prefix_sum of the masses {cmf_ms:.3f} ms")
    return summary, build_launches, seen[0]


def secondary_chunk(sc, flat, dev, warp=None):
    """One secondary-edge chunk of ``sc`` as ``render_secondary_edges``
    draws it (the stream under salt 2, here from PRNGKey(12)): the samples
    sorted by their edge coordinate and warped by the guiding table
    ``warp`` (None: unguided), and their validity pre-pass on the detached
    ``flat``. Returns (samples (m, 3), valid (m,), the stream after the
    samples)."""
    from psdr_tpu_torch.core import threefry
    from psdr_tpu_torch.core.distribution import hypercube_sample_reuse
    from psdr_tpu_torch.core.sampler import RngStream
    from psdr_tpu_torch.integrator.direct import _emitter_meta
    from psdr_tpu_torch.scene.scene import sample_boundary_segment_direct
    opts = sc.opts
    m = min(opts.pass_lanes, opts.num_pixels * opts.sppse)
    rng = RngStream(threefry.PRNGKey(12), salt=2, device=dev)
    sample3 = rng.next_3d(m)
    sample3 = sample3[torch.argsort(sample3[:, 0], stable=True)]
    if warp is not None:
        sample3, _ = hypercube_sample_reuse(warp, sample3)
    valid = sample_boundary_segment_direct(
        flat, sc.face_offset, _emitter_meta(sc), sample3,
        torch.ones((m,), dtype=torch.bool, device=dev)).valid
    return sample3, valid, rng


def guided_step(intersect, dev, sc, integ):
    """Phase 32 (2): the boundary step of ``integ`` (guided) on ``sc``
    through ``render_fn(with_boundary=True)``: one warm-up, three timed
    steps and one profiled step (no ``indexing_backward`` kernel among its
    top ten), every leaf finite, the gradient unlike the unguided one at
    the same key; then as ``grad_program`` against its eager step
    (``gradient_case``: bit for bit at seeds 0, 1, 0). Returns (a summary,
    the launches of the three timed steps, the program's summary)."""
    from psdr_tpu_torch import DirectIntegrator
    from psdr_tpu_torch.core import threefry
    opts = sc.opts
    base = sc.params()
    render = integ.render_fn(sc, with_boundary=True)
    times, loss, grads, launches, peak = timed_steps(intersect, render, base,
                                                     dev)
    bad = [i for i, g in enumerate(grads)
           if g is None or not bool(torch.isfinite(g).all())]
    if bad or not bool(torch.isfinite(loss)) or not float(loss) > 0.0:
        raise AssertionError(f"phase 32: loss {float(loss)}, leaves without "
                             f"a finite gradient: {bad}")
    require_launches(32, launches)
    top, busy, _ = profile_step(
        lambda: grad_step(render, base, dev, threefry.PRNGKey(9)),
        "guided boundary step")
    if any("indexing_backward" in k for k in top):
        raise AssertionError("phase 32: an indexing_backward kernel is among "
                             "the guided step's top ten")
    _, plain = grad_step(DirectIntegrator(1, 1).render_fn(
        sc, with_boundary=True), base, dev, threefry.PRNGKey(3))
    moved = max(float((a - b).abs().max()) for a, b in zip(grads, plain))
    if not moved > 0.0:
        raise AssertionError("phase 32: guiding changed no gradient")
    dt = float(np.median(times))
    samples = opts.num_pixels * (opts.spp + opts.sppe + opts.sppse)
    log(f"  guided steps {', '.join(f'{t:.3f}' for t in times)} s; median "
        f"{dt:.3f} s -> {samples / dt / 1e6:.3f} M grad-samples/s; loss "
        f"{float(loss):.6f}; {len(grads)} leaves, all finite; largest "
        f"|guided - unguided| entry {moved:.3g}; peak memory "
        f"{peak / 2**30:.2f} GiB; launches over 3 steps {launches}")
    target = torch.zeros((opts.num_pixels, 3), device=dev)
    prog, _, _ = gradient_case(
        intersect, "k: DirectIntegrator(1, 1) guided boundary step "
        "grad_program, cbox 256x256 spp 16 sppe 8 sppse 64",
        lambda: _grad_steps(integ, sc, target, True), None, phase=32)
    require_launches(32, prog["launches"])
    return ({"step_s": dt, "peak_bytes": peak, "busy_ms": busy,
             "moved": moved}, launches, prog)


def guiding_variance(dev):
    """Phase 32 (4), ``scripts/bench_guiding_scale.py``'s measurement:
    on VARIANCE's scene the forward-mode derivative image of the boundary
    terms (``testing.harness.run_ad``) at VARIANCE_SEEDS keys, guided by a
    GUIDING_REF table and unguided; the mean per-pixel variance over the
    keys, guided against unguided, below VARIANCE_RATIO. The derivative is
    the occluder's translation along -x: the script's perturbation, a
    vertex of mesh 0 along -x, moves a corner of this scene's floor within
    its own plane, whose derivative is 0 but for rounding. Returns (the
    ratio, a summary)."""
    from psdr_tpu_torch import DirectIntegrator
    from psdr_tpu_torch.testing import run_ad
    from psdr_tpu_torch.testing.scenes import cbox_scene
    sc = cbox_scene(**VARIANCE, device=dev)
    guided = DirectIntegrator(1, 1)
    t0 = time.perf_counter()
    guided.preprocess_secondary_edges(sc, 0, **GUIDING_REF)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    var = {}
    t0 = time.perf_counter()
    for name, integ in (("guided", guided), ("unguided",
                                             DirectIntegrator(1, 1))):
        imgs = np.stack([run_ad(sc, integ, "mesh_transform", npass=1,
                                seed0=100 + s, mesh_index=OCCLUDER,
                                direction=(-1.0, 0.0, 0.0))
                         for s in range(VARIANCE_SEEDS)])
        if not np.isfinite(imgs).all():
            raise AssertionError(f"phase 32: a {name} derivative image is "
                                 "not finite")
        var[name] = float(imgs.var(axis=0).mean())
    ad_s = time.perf_counter() - t0
    ratio = var["guided"] / var["unguided"]
    log(f"  what the table buys, {VARIANCE}, {VARIANCE_SEEDS} keys: mean "
        f"per-pixel variance of the derivative image guided "
        f"{var['guided']:.4g}, unguided {var['unguided']:.4g}: ratio "
        f"{ratio:.4f} (bound {VARIANCE_RATIO}); its table built in "
        f"{build_s:.3f} s, the {2 * VARIANCE_SEEDS} derivative images in "
        f"{ad_s:.2f} s")
    if not (var["unguided"] > 0.0 and ratio < VARIANCE_RATIO):
        raise AssertionError(f"phase 32: guided / unguided variance {ratio} "
                             f"(bound {VARIANCE_RATIO})")
    return ratio, {"variance_guided": var["guided"],
                   "variance_unguided": var["unguided"], "ratio": ratio,
                   "build_s": build_s}


def reference_guiding_phase(intersect, dev):
    """Phase 32: the reference's representative gradient configuration on
    the card: the GUIDING_REF table built on phase 12's scene
    (``guiding_build``), the guided boundary step eager and as its program
    (``guided_step``), the share of a secondary-edge chunk's lanes that are
    valid guided and unguided, K1 and K2 at the guided chunk's compacted
    shapes against their plain versions (``boundary_shapes``), the
    per-cell sum of one round against its plain version (``segsum_shape``)
    and the variance ratio (``guiding_variance``). Returns (a summary, the
    launches of the path: the first build and the three timed steps, K1's
    shapes, K2's, their comparisons, K1's lanes unlike ``k1_plain``, the
    segsum shape {name: dict})."""
    from psdr_tpu_torch import DirectIntegrator
    from psdr_tpu_torch.scene.scene import detach_flat
    from psdr_tpu_torch.testing.scenes import cbox_scene
    sc = cbox_scene(**RENDERD, device=dev)
    integ = DirectIntegrator(1, 1)
    build, build_launches, (keys, values, rows) = guiding_build(
        intersect, dev, sc, integ)
    step, step_launches, prog = guided_step(intersect, dev, sc, integ)
    launches = {k: build_launches[k] + step_launches[k]
                for k in step_launches}
    if launches["segsum"] == 0:
        raise AssertionError(f"phase 32: the fixed-order sum never launched "
                             f"({launches})")
    with torch.no_grad():
        flat = detach_flat(sc.build(sc.params()))
        share = {name: float(secondary_chunk(sc, flat, dev, warp)[1].float()
                             .mean())
                 for name, warp in (("guided", integ.warpper[0]),
                                    ("unguided", None))}
    log(f"  valid lanes of a 2^21-lane secondary-edge chunk: guided "
        f"{share['guided']:.4f}, unguided {share['unguided']:.4f}")
    tally = {}
    k1, k2, err, _ = boundary_shapes(intersect, sc, dev,
                                     warp=integ.warpper[0], tally=tally)
    name = "guiding masses, 1,000,000 cells (one round)"
    lane_rows = keys.long()
    seg = {name: segsum_shape(intersect, dev, name, keys, values, rows, None,
                              lane_rows, phase=32)}
    ratio, var = guiding_variance(dev)
    summary = {"build": build, "step": step, "program": prog,
               "valid_share": share, "variance": var, "launches": launches}
    log(f"  {json.dumps(summary)}")
    return summary, launches, k1, k2, err, tally, seg


# -- phase 33: checkpointed gradients above 2^23 lanes --------------------------

def checkpointed_step(intersect, dev, sc, integ, label):
    """Phase 33 (1): ``bench.py``'s gradient step (``value_and_grad`` of
    mean(image^2)) of ``integ`` on ``sc``, whose wavefront lies above
    ``remat_lanes``, so that ``remat_passes="auto"`` checkpoints every pass
    chunk: the forward render (``render_fn(detached=True)``), then the
    eager step at the same key twice (the second timed, its launches and
    peak memory read, equal to the first bit for bit), its image against
    the forward's, then
    ``grad_program``: the first call (three eager warm-ups, the capture, a
    replay) and a replay, each equal to the eager step bit for bit, one
    profiled replay without an ``indexing_backward`` kernel in its top
    ten. Returns (a summary, the timed eager step's launches)."""
    from psdr_tpu_torch.convert import params_from_numpy
    from psdr_tpu_torch.core import threefry
    from psdr_tpu_torch.program import value_and_grad
    opts = sc.opts
    n = opts.num_pixels * opts.spp
    remat = opts.resolve_remat(n)
    log(f"  {label}: {n} lanes, remat_passes {opts.remat_passes!r} -> "
        f"{remat} (remat_lanes {opts.remat_lanes})")
    if not remat:
        raise AssertionError(f"phase 33: {label}: {n} lanes do not resolve "
                             "to checkpointed passes")
    target = torch.zeros((opts.num_pixels, 3), device=dev)
    render = integ.render_fn(sc, with_boundary=False)
    images = []

    def loss(params, key):
        img = render(params, key)
        images.append(img.detach())
        return torch.mean((img - target) ** 2)
    step = value_and_grad(loss)
    params = params_from_numpy(sc.params(), device=dev)

    def eager(seed):
        with torch.enable_grad():
            return step(params, threefry.PRNGKey(seed))
    # the forward first: it also fills the scene's caches for the step
    t0 = time.perf_counter()
    with torch.no_grad():
        fwd = integ.render_fn(sc, with_boundary=False, detached=True)(
            params, threefry.PRNGKey(0))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    e0 = _floats(eager(0))                 # warm-up: the allocator grows
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    intersect.reset_launch_counts()
    t0 = time.perf_counter()
    e1 = _floats(eager(0))
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    launches = dict(intersect.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    require_launches(33, launches)
    if launches["segsum"] == 0:
        raise AssertionError(f"phase 33: {label}: the fixed-order sum never "
                             f"launched ({launches})")
    if not all(bool(torch.isfinite(x).all()) for x in e1):
        raise AssertionError(f"phase 33: {label}: a leaf is not finite")
    gate_replay(33, f"{label}: the second eager step", e1, e0, 0.0)
    img = images[-1]
    images.clear()
    if torch.equal(img, fwd):
        log(f"  {label}: the step's image equals the forward's bit for bit")
        img_share = 1.0
    else:
        img_share = image_gate(33, f"{label}: the step's image and the "
                               "forward's (the forward reads the hit "
                               "query's t and uv, the step recomputes the "
                               "hit on its triangle)", host(img), host(fwd))
    del e0, img, fwd
    prog = integ.grad_program(sc, target, with_boundary=False)
    t0 = time.perf_counter()
    r0 = _floats(prog(params, threefry.PRNGKey(0, device=dev)))
    torch.cuda.synchronize()
    prog_first_s = time.perf_counter() - t0
    before = dict(intersect.LAUNCHES)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    r1 = _floats(prog(params, threefry.PRNGKey(0, device=dev)))
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    replay_peak = torch.cuda.max_memory_allocated()
    replay_launches = {k: intersect.LAUNCHES[k] - before[k] for k in before}
    if replay_launches != launches:
        raise AssertionError(f"phase 33: {label}: a replay launched "
                             f"{replay_launches}, the eager step {launches}")
    gate_replay(33, f"{label}: the first call", r0, e1, 0.0)
    gate_replay(33, f"{label}: a replay", r1, e1, 0.0)
    top = []
    wall, busy, kern, calls = program_frame(
        lambda: prog(params, threefry.PRNGKey(9, device=dev)), top)
    if any("indexing_backward" in k for k in top):
        raise AssertionError(f"phase 33: {label}: an indexing_backward "
                             "kernel is among the replay's top ten")
    summary = {"lanes": n, "remat": remat, "forward_first_s": first_s,
               "eager_s": eager_s, "eager_peak_bytes": peak,
               "image_share_within_rtol": img_share,
               "program_first_call_s": prog_first_s, "replay_s": replay_s,
               "replay_peak_bytes": replay_peak,
               "capture_s": prog.capture_seconds, "nodes": prog.nodes,
               "pool_bytes": prog.pool_bytes, "replay_busy_ms": busy,
               "replay_idle": 1.0 - busy / wall, "launches": launches,
               "replay_top": top[:3]}
    log(f"  {label}: eager step {eager_s:.3f} s (the forward before it "
        f"{first_s:.3f} s with the scene's first build), peak "
        f"{peak / 2**30:.2f} GiB, launches {launches}, every leaf finite, = "
        f"the first step bit for bit; grad_program: first call "
        f"{prog_first_s:.3f} s (capture {prog.capture_seconds:.3f} s, "
        f"{prog.nodes} graph nodes, pool {prog.pool_bytes / 2**30:.3f} "
        f"GiB), replay {replay_s:.3f} s (busy {busy:.1f} of {wall:.1f} ms, "
        f"peak {replay_peak / 2**30:.2f} GiB), = eager bit for bit")
    return summary, launches


def remat_forms(intersect, dev, make, integ, label, replay):
    """Phase 33 (2, 3): the gradient step of ``integ`` on the scene
    ``make()`` with ``remat_passes`` True and False, each eagerly (a first
    step, then a timed one with its peak memory) and, with ``replay``, as
    ``grad_program`` (first call, a timed replay with its peak and the
    pool): every form's loss and every leaf equal to every other's bit for
    bit. Returns {form: summary}."""
    import dataclasses

    from psdr_tpu_torch.convert import params_from_numpy
    from psdr_tpu_torch.core import threefry
    out, ref = {}, None
    for remat in (True, False):
        sc = make()
        sc.opts = dataclasses.replace(sc.opts, remat_passes=remat)
        target = torch.zeros((sc.opts.num_pixels, 3), device=dev)
        prog = integ.grad_program(sc, target, with_boundary=False)
        params = params_from_numpy(sc.params(), device=dev)
        runs = {"eager": lambda: prog.fn(params, threefry.PRNGKey(0))}
        if replay:
            runs["replay"] = lambda: prog(params,
                                          threefry.PRNGKey(0, device=dev))
        for form, run in runs.items():
            with torch.enable_grad():
                t0 = time.perf_counter()
                got = _floats(run())
                torch.cuda.synchronize()
                first_s = time.perf_counter() - t0
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                again = _floats(run())
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
            name = f"remat {remat}, {form}"
            if ref is None:
                ref = got
                if not all(bool(torch.isfinite(x).all()) for x in got):
                    raise AssertionError(f"phase 33: {label}: a leaf is not "
                                         "finite")
            gate_replay(33, f"{label}, {name}", got, ref, 0.0)
            gate_replay(33, f"{label}, {name} again", again, ref, 0.0)
            out[name] = {"first_s": first_s, "s": dt,
                         "peak_bytes": torch.cuda.max_memory_allocated()}
            if form == "replay":
                out[name].update(capture_s=prog.capture_seconds,
                                 nodes=prog.nodes, pool_bytes=prog.pool_bytes)
            log(f"  {label}, {name}: {dt:.3f} s a step (first call "
                f"{first_s:.3f} s), peak {out[name]['peak_bytes'] / 2**30:.2f}"
                f" GiB" + ("" if form == "eager" else
                           f", pool {prog.pool_bytes / 2**30:.3f} GiB")
                + "; loss and every leaf = remat True eager bit for bit")
        del prog, runs, params
        torch.cuda.empty_cache()
    return out


def checkpointed_phase(intersect, dev):
    """Phase 33: the gradients above ``RenderOptions.remat_lanes`` (2^23),
    where ``remat_passes="auto"`` checkpoints every pass chunk: (1)
    ``PathTracer(3)`` on ``env_bench_scene`` at 512x512, spp 64 (2^24
    lanes; ``checkpointed_step``); (2) at phase 19's config (2^22 lanes)
    ``remat_passes`` True against False, eagerly; (3)
    ``DirectIntegrator(1, 1)`` on the bench scene at 512x512, spp 64 (2^24
    lanes) True against False, eager and replayed, with the seconds and
    peak memory of each (``remat_forms``). Returns (a summary, the
    launches of (1)'s timed eager step)."""
    from psdr_tpu_torch import DirectIntegrator, PathTracer
    from psdr_tpu_torch.testing.scenes import cbox_scene, env_bench_scene
    path, launches = checkpointed_step(
        intersect, dev, env_bench_scene(**ENV_BENCH, device=dev),
        PathTracer(3), f"PathTracer(3), env_bench_scene {ENV_BENCH}")
    torch.cuda.empty_cache()
    env = remat_forms(intersect, dev,
                      lambda: env_bench_scene(**ENV_BWD, device=dev),
                      PathTracer(3), f"PathTracer(3), env_bench_scene "
                      f"{ENV_BWD}", replay=False)
    direct = remat_forms(intersect, dev,
                         lambda: cbox_scene(**BENCH, device=dev),
                         DirectIntegrator(1, 1), f"DirectIntegrator(1, 1), "
                         f"cbox {BENCH}", replay=True)
    summary = {"path_2_24": path, "path_2_22_forms": env,
               "direct_2_24_forms": direct}
    log(f"  {json.dumps(summary)}")
    return summary, launches


# -- phase 34: the configurations never run on the card -------------------------

def untried_configs():
    """Phase 34's configurations: (label, scene maker, scene, integrator
    maker, ``RenderOptions`` fields, environment switches, guiding tables
    or None)."""
    from psdr_tpu_torch import DirectIntegrator, PathTracer
    from psdr_tpu_torch.testing.scenes import cbox_scene, env_bench_scene

    def both_tables(integ, sc):
        integ.preprocess_secondary_edges(sc, 0, **UNTRIED_GUIDING)
        integ.preprocess_indirect_edges(sc, 0, **UNTRIED_GUIDING)
    cb, small, bnd = cbox_scene, SMALL, SMALL_BOUNDARY
    return [
        ("PathTracer(3, camera_depth=3) boundary step", cb, bnd,
         lambda: PathTracer(3, camera_depth=3), None, {}, None),
        ("guided PathTracer(2, camera_depth=2) boundary step, both tables "
         f"{UNTRIED_GUIDING}", cb, bnd,
         lambda: PathTracer(2, camera_depth=2), None, {}, both_tables),
        ("DirectIntegrator(1, 1) boundary step on env_bench_scene",
         env_bench_scene, UNTRIED_ENV_BOUNDARY,
         lambda: DirectIntegrator(1, 1), None, {}, None),
        ("DirectIntegrator(2, 2)", cb, small, lambda: DirectIntegrator(2, 2),
         None, {}, None),
        ("camera_hit_prior=True", cb, small, lambda: DirectIntegrator(1, 1),
         dict(camera_hit_prior=True), {}, None),
        ("primary_edge_vis_check=True", cb, bnd,
         lambda: DirectIntegrator(1, 1), dict(primary_edge_vis_check=True),
         {}, None),
        ("sampler stratified, stratify_primary True", cb, small,
         lambda: DirectIntegrator(1, 1), dict(sampler="stratified"), {},
         None),
        ("sampler stratified, stratify_primary False", cb, small,
         lambda: DirectIntegrator(1, 1),
         dict(sampler="stratified", stratify_primary=False), {}, None),
        ("sampler independent", cb, small, lambda: DirectIntegrator(1, 1),
         dict(sampler="independent"), {}, None),
        ("DirectIntegrator(1, 1, hide_emitters=True)", cb, small,
         lambda: DirectIntegrator(1, 1, hide_emitters=True), None, {},
         None),
        ("PathTracer(3, hide_emitters=True)", cb, small,
         lambda: PathTracer(3, hide_emitters=True), None, {}, None),
        ("PathTracer(6)", cb, small, lambda: PathTracer(6), None, {}, None),
        ("PSDR_TPU_VIS_REUSE=off", cb, bnd, lambda: DirectIntegrator(1, 1),
         None, {"PSDR_TPU_VIS_REUSE": "off"}, None),
        ("PSDR_TPU_VIS_REUSE=bern, PSDR_TPU_VIS_REUSE_Q=0.0625", cb, bnd,
         lambda: DirectIntegrator(1, 1), None,
         {"PSDR_TPU_VIS_REUSE": "bern", "PSDR_TPU_VIS_REUSE_Q": "0.0625"},
         None),
        ("PSDR_TPU_SSE_COMPACT=0", cb, bnd, lambda: DirectIntegrator(1, 1),
         None, {"PSDR_TPU_SSE_COMPACT": "0"}, None),
    ]


def cpu_jobs():
    """The CPU sides of the card-against-CPU checks, in the order the card's
    phases ask for them: [(key, run on the CPU)]: phases 4, 17 and 30's
    renders (``render_checks``), phases 8, 10, 13 and 17's gradients
    (``grad_checks``), phase 21's (``loaded_render``), then each of phase
    34's ``untried_configs``."""
    from psdr_tpu_torch.scene.scene import ACCEL_MODES
    cpu = torch.device("cpu")
    jobs = {f"render {k}": (lambda m=m, s=s, i=i: render_run(m, s, i(), cpu))
            for k, (m, s, i) in render_checks().items()}
    jobs.update({f"grad {k}": (lambda p=p, m=m, s=s, i=i: grad_run(
        p, m, s, i(), cpu)) for k, (p, m, s, i) in grad_checks().items()})
    jobs["render 21"] = lambda: loaded_render(cpu)

    def untried(make, scene, integ, opts, env, tables):
        with switches(env):
            return grad_run(34, make, scene, integ(), cpu, opts, tables)
    order = ["render 4", "grad 8", "grad 10", "grad 13 interior",
             "grad 13 boundary", "render 17 rough", "render 17 textured",
             "grad 17 rough interior", "grad 17 rough boundary",
             "grad 17 textured", *(f"render 17 AOV {f}" for f in AOV_FIELDS),
             "render 21", *(f"render 30 {mode}" for mode in ACCEL_MODES)]
    if sorted(order) != sorted(jobs):
        raise AssertionError("cpu_jobs: the order misses a check")
    return [*((k, jobs[k]) for k in order),
            *((f"untried {label}", lambda c=c: untried(*c))
              for label, *c in untried_configs())]


def cpu_reference(path: str) -> int:
    """``python3 chip_smoke.py --cpu-reference DIR``: each of ``cpu_jobs``
    run once on the CPU with CPU_REFERENCE_THREADS threads at the lowest
    priority, its result pickled to DIR/<its index>.pkl as it ends."""
    sys.path.insert(0, ROOT)
    os.nice(19)
    torch.set_num_threads(CPU_REFERENCE_THREADS)
    for i, (key, fn) in enumerate(cpu_jobs()):
        t0 = time.perf_counter()
        out = fn()
        part = os.path.join(path, f"{i}.part")
        with open(part, "wb") as f:
            pickle.dump(out, f)
        os.replace(part, os.path.join(path, f"{i}.pkl"))
        log(f"{key}: {time.perf_counter() - t0:.1f} s")
    log(f"done in {time.time() - T_START:.0f}")
    return 0


class CpuReference:
    """The CPU sides of the card-against-CPU checks (``cpu_jobs``) in a
    second process (``cpu_reference``), started when the kernels are built
    so that its CPU renders overlap the card's phases; no CUDA device is
    visible to it. ``get(key)`` waits for one job's result and loads it;
    ``later`` holds a phase's comparison until ``settle()`` (phase 34), so
    that no phase waits for the CPU; ``summary()`` logs what the process
    took; ``stop()`` ends it (also at exit) and removes its directory."""

    def __init__(self):
        self.dir = tempfile.mkdtemp(prefix="chip_smoke_cpu_")
        self.log = os.path.join(self.dir, "log.txt")
        self.keys = [k for k, _ in cpu_jobs()]
        self.pending = []
        self.waited = 0.0
        self.t0 = time.time()
        with open(self.log, "w") as f:
            self.proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 "--cpu-reference", self.dir], cwd=ROOT, stdout=f,
                stderr=subprocess.STDOUT,
                env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        atexit.register(self.stop)

    def _text(self) -> str:
        with open(self.log) as f:
            return f.read()

    def get(self, key: str):
        """The CPU's result of the job ``key``, once the process has given
        it (at most CPU_REFERENCE_TIMEOUT seconds after its start)."""
        path = os.path.join(self.dir, f"{self.keys.index(key)}.pkl")
        t0 = time.time()
        while not os.path.exists(path):
            if self.proc.poll() is not None and not os.path.exists(path):
                raise AssertionError(
                    f"the CPU reference process ended with "
                    f"{self.proc.returncode} before {key!r}:\n"
                    f"{self._text()[-4000:]}")
            if time.time() > self.t0 + CPU_REFERENCE_TIMEOUT:
                raise AssertionError(f"the CPU reference process gave no "
                                     f"{key!r} in {CPU_REFERENCE_TIMEOUT} s")
            time.sleep(0.05)
        self.waited += time.time() - t0
        with open(path, "rb") as f:
            return pickle.load(f)

    def later(self, phase: int, what: str, key: str, compare) -> None:
        """Hold ``compare(the CPU's result of key)`` for ``settle``: the
        card's side of a check is done, its CPU side may still run."""
        self.pending.append((phase, what, key, compare))
        log(f"  {what}: the card's side done, held against the CPU's in "
            "phase 34")

    def settle(self) -> None:
        """Every check held by ``later``, in the order the phases held
        them; each raises if the card and the CPU disagree."""
        for phase, what, key, compare in self.pending:
            log(f"  phase {phase}, {what}:")
            compare(self.get(key))
        self.pending.clear()

    def summary(self) -> None:
        rc = self.proc.wait(timeout=60)
        text = self._text()
        if rc != 0:
            raise AssertionError(f"the CPU reference process ended with "
                                 f"{rc}:\n{text[-4000:]}")
        jobs = [line for line in text.splitlines() if line.endswith(" s")]
        took = text.rsplit("done in ", 1)[1].split()[0]
        log(f"  the CPU reference process: started {self.t0 - T_START:.0f} "
            f"s into the run, ran {took} s; the card's phases waited "
            f"{self.waited:.1f} s for it; its jobs: {'; '.join(jobs)}")
        self.stop()

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        shutil.rmtree(self.dir, ignore_errors=True)


def untried_phase(dev, reference):
    """Phase 34: each of ``untried_configs`` on the card, twice, against
    its CPU run from ``reference`` (a ``CpuReference``), the same key
    (``grad_compare``): the images under phase 4's gates, the loss and every
    leaf under phase 10's bounds, every leaf finite, boundary images exactly
    zero on both; a guided case's tables built on the card against the
    CPU's (``tables_match``), the card then rendering under the CPU's
    tables, cmf and all (``carry_tables``). Returns {label: (worst relative
    L2 of a leaf, the card's seconds)}. First the comparisons that earlier
    phases held (``CpuReference.settle``)."""
    log("  the card-against-CPU checks held by phases 4, 8, 10, 13, 17, 21 "
        "and 30:")
    reference.settle()
    out = {}
    for label, make, scene, integ, opts, env, tables in untried_configs():
        log(f"  {label}: {make.__name__} {scene}"
            + (f", {opts}" if opts else ""))
        t0 = time.perf_counter()
        ref = reference.get(f"untried {label}")
        boundary = scene.get("sppe", 0) > 0 or scene.get("sppse", 0) > 0
        integ = integ()
        with switches(env):
            runs = [grad_run(34, make, scene, integ, dev, opts, tables,
                             carry=ref[3]) for _ in range(2)]
        if tables is not None:
            tables_match(34, runs[0][3], ref[3])
        worst = grad_compare(34, runs + [ref], boundary, images=True)
        out[label] = (worst, time.perf_counter() - t0)
    reference.summary()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    if torch.cuda.device_count() != 1:
        print(f"chip_smoke: drives one card, {torch.cuda.device_count()} "
              "visible (set CUDA_VISIBLE_DEVICES to one)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from psdr_tpu_torch import DirectIntegrator, PathTracer
    from psdr_tpu_torch.accel import bvh as bvh_mod
    from psdr_tpu_torch.accel import intersect
    from psdr_tpu_torch.testing.scenes import env_bench_scene

    # -- 1. the card --------------------------------------------------------
    card = card_line()
    log(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    # -- 2. build the kernels -------------------------------------------------
    t0 = time.time()
    lib_path = intersect.build_library()
    intersect.load_library()
    log(f"phase 2: K1, K2, K3, segsum, rng, stamp and bsdf built in "
        f"{time.time() - t0:.1f} s -> "
        f"{os.path.relpath(lib_path, ROOT)}")
    for line in (lib_path.parent / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    # the CPU sides of phases 4, 8, 10, 13, 17, 21, 30 and 34, beside the
    # card's phases from here on
    reference = CpuReference()

    # -- 3. K1 against its plain version -----------------------------------
    log("phase 3: K1 kernel vs plain PyTorch version on the card")
    # a function of its own, so that its tensors are freed before phase 5
    # reads the peak memory
    err, shapes = k1_phase(intersect, bvh_mod, dev)

    # -- 4. the port on the card against the port on the CPU ------------------
    log("phase 4: renderC on the card vs on the CPU (64x64, spp 4)")
    render_check(dev, reference, 4, "cbox, DirectIntegrator(1, 1)", "4",
                 ((IMG_RTOL, IMG_CLOSE_FRAC),))

    # -- 5. the forward at full width ------------------------------------------
    log("phase 5: DirectIntegrator(1, 1) forward, 512x512, spp 64, "
        f"reuse {os.environ.get('PSDR_TPU_VIS_REUSE', 'edge')}")
    launches, mean_direct, _ = forward_phase(intersect, dev,
                                             DirectIntegrator(1, 1), 5, 3)
    log("  the random stream's kernels against the tensor code on the card")
    rng = rng_phase(intersect, dev)
    log("  the materials kernel against the tensor code on the card")
    materials = bsdf_phase(intersect, dev)

    # -- 6. K2 against its plain version --------------------------------------
    log("phase 6: K2 kernel vs plain PyTorch version on the card")
    k2_err, k2_ms = k2_phase(intersect, dev)

    # -- 7. K3's entry point ---------------------------------------------------
    log("phase 7: K3 entry point; K3 and K1 vs k1_plain on the card")
    chunk = shapes["tiled camera chunk"]
    k3_launches, k3_err, k3_ms = k3_phase(
        intersect, bvh_mod, dev, (chunk["bound_ms"], chunk["bound_by"]))

    # -- 8. a gradient on the card against the CPU -------------------------------
    log("phase 8: value_and_grad on the card vs on the CPU (64x64, spp 4)")
    grad_phase(dev, reference, "8")

    # -- 9. the backward at bench.py's config ------------------------------------
    log("phase 9: DirectIntegrator(1, 1) backward, 512x512, spp 16, reuse "
        f"{os.environ.get('PSDR_TPU_VIS_REUSE', 'edge')}")
    bwd, _ = backward_phase(intersect, dev, DirectIntegrator(1, 1))

    # -- 10. the boundary gradient on the card against the CPU --------------------
    log("phase 10: value_and_grad with the boundary terms on the card vs on "
        "the CPU (64x64, spp 4, sppe 2, sppse 4)")
    grad_phase(dev, reference, "10")

    # -- 11. guiding on the card -----------------------------------------------------
    log(f"phase 11: preprocess_secondary_edges {GUIDING} on the card vs on "
        "the CPU")
    guiding_phase(dev)

    # -- 12. the boundary step at full width -----------------------------------------
    log(f"phase 12: DirectIntegrator(1, 1) boundary step, {RENDERD}, reuse "
        f"{os.environ.get('PSDR_TPU_VIS_REUSE', 'edge')}")
    bnd, bnd_k1, bnd_k2, bnd_err = boundary_phase(intersect, dev)
    shapes.update(bnd_k1)
    for mode in ("closest", "any"):
        err[mode] += bnd_err[mode]
    k2_err = k2_err + bnd_err["k2"]

    # -- 13. the PathTracer on the card against the CPU ----------------------------
    log("phase 13: PathTracer(3) interior (64x64, spp 4) and PathTracer(2, "
        "camera_depth=2) with the boundary terms (sppe 2, sppse 4, the fused "
        "pass) on the card vs on the CPU")
    grad_phase(dev, reference, "13 interior")
    grad_phase(dev, reference, "13 boundary")

    # -- 14. the PathTracer's forward at full width ---------------------------------
    log("phase 14: PathTracer(3) forward, 512x512, spp 64, reuse "
        f"{os.environ.get('PSDR_TPU_VIS_REUSE', 'edge')}")
    pt_fwd, mean_path, _ = forward_phase(intersect, dev, PathTracer(3), 14,
                                         7)
    if not mean_path > mean_direct:
        raise AssertionError(f"phase 14: three bounces in a closed box must "
                             f"add light ({mean_path} vs {mean_direct})")
    pt_k1, pt_k2, pt_err = path_forward_shapes(intersect, dev)

    # -- 15. the PathTracer's backward at bench.py's config --------------------------
    log("phase 15: PathTracer(3) backward, 512x512, spp 16")
    pt_bwd, _ = backward_phase(intersect, dev, PathTracer(3), phase=15)

    # -- 16. the full boundary step ----------------------------------------------------
    log(f"phase 16: PathTracer(max_depth=2, camera_depth=2) boundary step, "
        f"{RENDERD}")
    pt_bnd, ptb_k1, ptb_err = path_boundary_phase(intersect, dev)
    shapes.update(pt_k1)
    shapes.update(ptb_k1)
    for mode in ("closest", "any"):
        err[mode] += pt_err[mode] + ptb_err[mode]
    k2_err = k2_err + pt_err["k2"]

    # -- 17. the materials and lights on the card against the CPU ------------------
    log("phase 17: rough conductor under an environment map, image texture "
        "and AOVs on the card vs on the CPU")
    material_phase(dev, reference)

    # -- 18. env_bench_scene forward ---------------------------------------------------
    log(f"phase 18: env_bench_scene forward, {ENV_BENCH}")
    env_sc = env_bench_scene(**ENV_BENCH, device=dev)
    env_fwd, _, env_cmf_s = forward_phase(intersect, dev,
                                          DirectIntegrator(1, 1), 18, 3,
                                          sc=env_sc)
    log("  PathTracer(3):")
    env_pt_fwd, _, _ = forward_phase(intersect, dev, PathTracer(3), 18, 7,
                                     sc=env_sc)

    # -- 19. env_bench_scene backward ---------------------------------------------------
    log(f"phase 19: env_bench_scene PathTracer(3) backward, {ENV_BWD}")
    env_bwd_sc = env_bench_scene(**ENV_BWD, device=dev)
    env_bwd, top = backward_phase(intersect, dev, PathTracer(3), phase=19,
                                  sc=env_bwd_sc)
    if any("indexing_backward" in k for k in top):
        raise AssertionError("phase 19: an indexing_backward kernel is among "
                             "the step's top ten")
    masked_texel_reads(dev, env_bwd_sc)
    texel_backward_ms(dev, (256, 256, 3), "the ground texture")
    texel_backward_ms(dev, (512, 1024, 3), "the sky")

    # -- 20. K1 and K2 at env_bench_scene's shapes -----------------------------------
    log("phase 20: K1 and K2 at env_bench_scene's shapes")
    env_k1, env_k2, env_err, env_tally = env_shapes(intersect, env_sc, dev)
    shapes.update(env_k1)
    for mode in ("closest", "any"):
        err[mode] += env_err[mode]
    k2_err = k2_err + env_err["k2"]
    log(f"  lanes on which K1 and k1_plain differ: {env_tally}")

    with tempfile.TemporaryDirectory() as tmp:
        # -- 21. the loader on the card -----------------------------------
        log(f"phase 21: the bench scene written as files and loaded on the "
            f"card, {BENCH}")
        loaded_fwd, _ = loader_phase(intersect, dev,
                                     os.path.join(tmp, "bench"), launches,
                                     reference)
        # -- 22. the trainer at full width: slice 7's main path -----------
        log(f"phase 22: the trainer, {TRAIN}, Optimizer on "
            f"Mesh[{OCCLUDER}].vertex_positions through "
            "render_fn(with_boundary=True)")
        train, _, (train_k1, train_k2, train_err, train_tally,
                   _) = trainer_phase(intersect, dev,
                                      os.path.join(tmp, "train"))
        shapes.update(train_k1)
        for mode in ("closest", "any"):
            err[mode] += train_err[mode]
        k2_err = k2_err + train_err["k2"]
        log(f"  lanes on which K1 and k1_plain differ: {train_tally}")
        # -- 23. the trainer and the harness, card against CPU ------------
        log(f"phase 23: optimizer step, save / load and the harness on the "
            f"card vs on the CPU, {SMALL_TRAIN}")
        small_trainer_phase(dev, tmp)
        # -- 24. the envmap's opt-in tables -------------------------------
        log("phase 24: PSDR_TPU_ENV_ALIAS=1 and PSDR_TPU_ENV_HIER=1, card "
            "vs CPU and env_bench_scene forward")
        env_opt = env_opt_in_phase(intersect, dev)
        # -- 25. the sharded paths on the card ----------------------------
        log(f"phase 25: shard_render_fn, make_train_step and the collective "
            f"guiding table over {SHARD_RANKS} gloo ranks on the one card, "
            f"{RENDERD}; one NCCL rank")
        shard_launches, shard_secs = sharded_phase(dev)
        # -- 26. the multi-view step at the flagship's config --------------
        log(f"phase 26: make_multiview_train_step, {TRAIN}, 3 views on "
            f"{MV_RANKS} gloo ranks")
        mv_launches, mv_secs = multiview_phase(dev)
        # -- 27. the flagship recovery: this slice's main path -------------
        log(f"phase 27: examples.flagship_recovery at full width, "
            f"{FLAGSHIP_ITERS} iterations")
        flag_launches, _ = flagship_phase(intersect, dev,
                                          os.path.join(tmp, "flagship"))
    # -- 28. the forward renders as captured programs: slice 9's main path
    log("phase 28: the forward renders as captured CUDA graphs "
        "(render_program, renderC, renderD), replay against eager")
    programs, prog_launches = program_phase(intersect, dev)
    # -- 29. the gradient programs: this slice's main path -----------------
    log("phase 29: the gradient programs as captured CUDA graphs "
        "(grad_program, the flagship's step, the trainer with its update, "
        "the guiding build), replay against eager")
    grad_programs, grad_launches, (flag_k1, flag_k2, flag_err, flag_tally,
                                   _) = gradient_phase(intersect, dev)
    shapes.update(flag_k1)
    for mode in ("closest", "any"):
        err[mode] += flag_err[mode]
    k2_err = k2_err + flag_err["k2"]
    log(f"  lanes on which K1 and k1_plain differ: {flag_tally}")
    # -- 30. the scene-query layer -------------------------------------------
    log("phase 30: the direction sort and the compacted sweeps at the paths' "
        "shapes, against the unsorted and dense sweeps")
    ordering = ordering_shapes(intersect, dev, env_sc)
    del env_sc
    log("  renderC under each accel_mode on the card vs on the CPU (64x64, "
        "spp 4); a tree of 8-triangle leaves")
    modes = accel_mode_phase(intersect, bvh_mod, dev, reference)
    log(f"  render_program replayed after {SNAPSHOTS} envmap snapshots")
    envmap_lifetime_phase(dev)
    # -- 31. reproducibility ---------------------------------------------------
    log("phase 31: reproducibility: replays, eager steps, hashed trainer "
        "steps in two passes and two processes, boundary lanes across "
        "builds, the fixed-order sum against its plain version")
    repro, (seg, seg_main) = reproducibility_phase(intersect, dev, programs,
                                                   grad_programs)
    # -- 32. the reference's representative gradient configuration: this
    # slice's main path -------------------------------------------------------
    log(f"phase 32: the guided boundary step at the reference scale, "
        f"{GUIDING_REF} on {RENDERD}")
    guided, guided_launches, gd_k1, gd_k2, gd_err, gd_tally, gd_seg = (
        reference_guiding_phase(intersect, dev))
    shapes.update(gd_k1)
    for mode in ("closest", "any"):
        err[mode] += gd_err[mode]
    k2_err = k2_err + gd_err["k2"]
    seg.update(gd_seg)
    log(f"  lanes on which K1 and k1_plain differ: {gd_tally}")
    # -- 33. checkpointed gradients above 2^23 lanes: this slice's main path --
    log("phase 33: gradients above remat_lanes (2^23): PathTracer(3) on "
        f"env_bench_scene {ENV_BENCH}, remat True against False")
    remat, remat_launches = checkpointed_phase(intersect, dev)
    # -- 34. the configurations never run on the card -----------------------
    log("phase 34: configurations never run on the card before, card vs "
        "CPU")
    untried = untried_phase(dev, reference)
    log(f"all phases passed in {time.time() - T_START:.0f} s")

    # launches: the replays of phase 29 (seeds 0, 1, 0 of each of its six
    # configurations, this slice's main path), those of phase 28 (seeds 0,
    # 1, 0 of its four forward programs), the flagship's recovery run (phase
    # 27), the trainer's five timed steps (phase 22), one sharded step of
    # phase 25 (budget split) and one multi-view step of phase 26, each
    # summed over its ranks, the backward's three timed steps, the forward's
    # three timed frames and the boundary step's three timed steps, the same
    # three of the PathTracer (phases 15, 14, 16), env_bench_scene's two
    # forwards and its backward (phases 18, 19), the loaded scene's forward
    # (21) and env_bench_scene's forward under each opt-in table (24); K3,
    # off the render path, its entry point's run in phase 7. ms, plain_ms
    # and bound_ms of K1 and K2 are those of the main path's shapes, which
    # phase 28's configuration a replays: the first 2^21-lane camera chunk
    # in tile order (K1 closest), its shadow sweep (K1 any) and the
    # 2^21-lane emitter-first sweep (K2, phase 6); the other timed shapes,
    # the flagship step's own launches (phase 29 h) among them, stand under
    # "shapes".
    kernels = []
    for mode in ("closest", "any"):
        main = {"closest": "tiled camera chunk",
                "any": "tiled shadow sweep"}[mode]
        mine = {k: v for k, v in shapes.items()
                if v["any_hit"] == (mode == "any")}
        kernels.append({
            "name": f"ray_intersect_k1 ({mode} hit)",
            "route": "cuda",
            "source": "psdr_tpu_torch/csrc/intersect.cu",
            "replaces": "psdr_tpu/accel/pallas_kernel.py:678",
            "launches": grad_launches[mode],
            "launches_forward_programs": prog_launches[mode],
            "launches_flagship": flag_launches[mode],
            "launches_trainer": train[mode],
            "launches_sharded": shard_launches[mode],
            "launches_multiview": mv_launches[mode],
            "launches_backward": bwd[mode],
            "launches_forward": launches[mode],
            "launches_boundary": bnd[mode],
            "launches_path_backward": pt_bwd[mode],
            "launches_path_forward": pt_fwd[mode],
            "launches_path_boundary": pt_bnd[mode],
            "launches_env_forward": env_fwd[mode],
            "launches_env_path_forward": env_pt_fwd[mode],
            "launches_env_path_backward": env_bwd[mode],
            "launches_loaded_forward": loaded_fwd[mode],
            "launches_env_alias_forward": env_opt["alias"][0][mode],
            "launches_env_hier_forward": env_opt["hier"][0][mode],
            "launches_guided_boundary": guided_launches[mode],
            "launches_checkpointed": remat_launches[mode],
            # |t| error of the hits: closest against k1_plain's hit, any
            # against the plain Moller-Trumbore on the kernel's triangle
            "max_abs_err": max(e for e, _ in err[mode]),
            "valid_mismatches": sum(n for _, n in err[mode]),
            # phases 20, 22 and 29: lanes on which K1 equals its walk in tensor
            # code and not k1_plain (the cull-margin rule), by shape
            "lanes_unlike_k1_plain": {
                k: v for k, v in {**env_tally, **train_tally,
                                  **flag_tally, **gd_tally}.items()
                if shapes[k.split(" ", 1)[1]]["any_hit"] == (mode == "any")},
            "launches_accel_modes": {m: v[mode] for m, v in modes.items()},
            # phase 30: sorted against unsorted, compacted against dense
            "ordering": {k: v for k, v in ordering.items()
                         if v.get("any_hit", True) == (mode == "any")},
            "ms": mine[main]["ms"],
            "plain_ms": mine[main]["plain_ms"],
            "bound_ms": mine[main]["bound_ms"],
            "bound_by": mine[main]["bound_by"],
            "library_ms": None,
            "shapes": mine,
        })
    kernels.append({
        "name": "ray_intersect_brute (K2)", "route": "cuda",
        "source": "psdr_tpu_torch/csrc/brute.cu",
        "replaces": "psdr_tpu/accel/pallas_kernel.py:87",
        "launches": grad_launches["k2"],
        "launches_forward_programs": prog_launches["k2"],
        "launches_flagship": flag_launches["k2"],
        "launches_trainer": train["k2"],
        "launches_sharded": shard_launches["k2"],
        "launches_multiview": mv_launches["k2"],
        "launches_backward": bwd["k2"],
        "launches_forward": launches["k2"],
        "launches_boundary": bnd["k2"],
        "launches_path_backward": pt_bwd["k2"],
        "launches_path_forward": pt_fwd["k2"],
        "launches_path_boundary": pt_bnd["k2"],
        "launches_env_forward": env_fwd["k2"],
        "launches_env_path_forward": env_pt_fwd["k2"],
        "launches_env_path_backward": env_bwd["k2"],
        "launches_loaded_forward": loaded_fwd["k2"],
        "launches_env_alias_forward": env_opt["alias"][0]["k2"],
        "launches_env_hier_forward": env_opt["hier"][0]["k2"],
        "launches_guided_boundary": guided_launches["k2"],
        "launches_checkpointed": remat_launches["k2"],
        "launches_accel_modes": {m: v["k2"] for m, v in modes.items()},
        "max_abs_err": max(e for e, _ in k2_err),
        "valid_mismatches": sum(n for _, n in k2_err),
        # the main path's emitter-first sweep (phase 6)
        **{k: k2_ms[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        "shapes": {"emitter-first sweep": k2_ms, **bnd_k2, **pt_k2,
                   **env_k2, **train_k2, **flag_k2, **gd_k2}})
    kernels.append({
        "name": "ray_intersect_k3 (K3)", "route": "cuda",
        "source": "psdr_tpu_torch/csrc/culled.cu",
        "replaces": "psdr_tpu/accel/pallas_kernel.py:232",
        "launches": k3_launches, "launches_forward": launches["k3"],
        "launches_boundary": bnd["k3"],
        "launches_path_backward": pt_bwd["k3"],
        "launches_path_forward": pt_fwd["k3"],
        "launches_path_boundary": pt_bnd["k3"],
        "launches_env_forward": env_fwd["k3"],
        "launches_env_path_forward": env_pt_fwd["k3"],
        "launches_env_path_backward": env_bwd["k3"],
        "launches_trainer": train["k3"],
        "launches_flagship": flag_launches["k3"],
        "launches_forward_programs": prog_launches["k3"],
        "launches_gradient_programs": grad_launches["k3"],
        "launches_sharded": shard_launches["k3"],
        "launches_multiview": mv_launches["k3"],
        "launches_loaded_forward": loaded_fwd["k3"],
        "launches_guided_boundary": guided_launches["k3"],
        "launches_checkpointed": remat_launches["k3"],
        "launches_accel_modes": {m: v["k3"] for m, v in modes.items()},
        "max_abs_err": max(e for e, _ in k3_err),
        "valid_mismatches": sum(n for _, n in k3_err),
        "bound_ms": chunk["bound_ms"], "bound_by": chunk["bound_by"],
        "library_ms": None, **k3_ms})
    # the fixed-order sum: a helper of the port, no TPU kernel's port (on
    # the TPU these sums are XLA scatter-adds); its launches are those of
    # phase 29's replays, its times those of the main path's own inputs
    kernels.append({
        "name": "segsum (fixed-order segmented sum)", "route": "cuda",
        "source": "psdr_tpu_torch/csrc/segsum.cu",
        "replaces": "no TPU kernel (a helper of the port; XLA scatter-adds "
                    "at psdr_tpu/core/gather.py:89, integrator/base.py:117, "
                    "integrator/direct.py:642)",
        "tpu_kernel_port": False,
        "launches": grad_launches["segsum"],
        "launches_forward_programs": prog_launches["segsum"],
        "launches_flagship": flag_launches["segsum"],
        "launches_trainer": train["segsum"],
        "launches_guided_boundary": guided_launches["segsum"],
        "launches_checkpointed": remat_launches["segsum"],
        "launches_per_program": {
            label[0]: summ["launches"]["segsum"]
            for label, summ in {**programs, **grad_programs}.items()},
        "max_abs_err": max(v["max_abs_err"] for v in seg.values()),
        **{k: seg[seg_main][k] for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")},
        "shapes": seg, "reproducibility": repro})
    # the random stream: a helper of the port, no TPU kernel's port; its
    # launches are those of phases 29's and 28's replays (counted anew
    # after each reset before them), its times those of phase 5
    if grad_launches["rng"] == 0 or prog_launches["rng"] == 0:
        raise AssertionError(f"the random stream's kernels did not launch in "
                             f"the programs' replays (phase 29: "
                             f"{grad_launches['rng']}, phase 28: "
                             f"{prog_launches['rng']})")
    rng_main = next(iter(rng))
    kernels.append({
        "name": "rng (Threefry-2x32 draws and key derivations, scrambled "
                "(0,2)-points)", "route": "cuda",
        "source": "psdr_tpu_torch/csrc/rng.cu",
        "replaces": "no TPU kernel (a helper of the port; jax.random and the "
                    "sampler's bit arithmetic, which XLA fuses, at "
                    "psdr_tpu/core/sampler.py and psdr_tpu/integrator/"
                    "base.py)",
        "tpu_kernel_port": False,
        "launches": grad_launches["rng"],
        "launches_forward_programs": prog_launches["rng"],
        "max_abs_err": 0.0, "main_shape": rng_main,
        **{k: rng[rng_main][k] for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")},
        "shapes": rng})
    # the materials kernel: a helper of the port, no TPU kernel's port; its
    # launches are those of phase 28's replays, its times those of phase 5
    if prog_launches["bsdf"] == 0:
        raise AssertionError("the materials kernel did not launch in the "
                             "forward programs' replays (phase 28)")
    bsdf_main = next(iter(materials))
    kernels.append({
        "name": "bsdf (the BSDF dispatch: eval, pdf and sample in one pass)",
        "route": "cuda", "source": "psdr_tpu_torch/csrc/bsdf.cu",
        "replaces": "no TPU kernel (a helper of the port; the BSDF "
                    "arithmetic of psdr_tpu/bsdf/, which XLA fuses)",
        "tpu_kernel_port": False,
        "launches": grad_launches["bsdf"],
        "launches_forward_programs": prog_launches["bsdf"],
        "max_abs_err": 0.0, "main_shape": bsdf_main,
        **{k: materials[bsdf_main][k] for k in ("ms", "plain_ms", "bound_ms",
                                                "bound_by", "library_ms")},
        "shapes": materials})
    log(json.dumps({"programs": programs}))
    log(json.dumps({"gradient_programs": grad_programs}))
    log(json.dumps({"guided_reference": guided, "checkpointed": remat,
                    "untried": untried}))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--repro-child":
        sys.exit(repro_child(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--cpu-reference":
        sys.exit(cpu_reference(sys.argv[2]))
    sys.exit(main())
