"""The CUDA kernels on the card: K1, K2 and K3 against their plain
versions on the same CUDA tensors (trees of odd and even depth, the tie
case, several blockings, tiny and all-inactive launches), the default
device, and a small render, a small gradient, the boundary gradient, the
compaction, the guiding masses, the PathTracer's gradients, the
gradient of a rough conductor under an environment map, an optimizer step
and a scene loaded from files on the card against the same on the CPU;
and the sharded steps over gloo ranks sharing the card and a one-rank
NCCL group against their serial emulation on the card, and the flagship
recovery loop; and the captured render programs against the eager renders,
and the gradient programs (``grad_program``, the optimizer's update, a
guiding build, ``VJPProgram``) against their eager steps; and the scene
queries: K1 on sorted rays against unsorted, the compacted occlusion sweep
against the dense one, ``accel_mode="culled"`` through K3, and a program
replayed after its envmap table left the host cache; and the fixed-order
sums: the segsum kernel against its plain version, the prefix sum, a
backward step, a guiding build and five trainer steps run twice, equal;
and the reference-scale guiding table built twice and replayed, equal,
checkpointed gradients equal to plain ones, and ``camera_depth=3``'s
boundary gradient against the CPU; and the tracing: the layers'
device times of ``Program.profile_layers`` against the replay, a program
under ``torch.profiler`` bit-equal to one without, and the counters a
replay adds against the eager body's; and the random stream's kernels
(``csrc/rng.cu``) against the tensor code, and their launches in a
render body, where the tensor code runs nothing.
Needs a CUDA device and nvcc; skips elsewhere. Imports no jax, so it runs on a machine without it:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_gpu.py
"""
import functools

import numpy as np
import pytest
import torch

from psdr_tpu_torch import DirectIntegrator, PathTracer, RoughConductor
from psdr_tpu_torch.accel import bvh as t_bvh
from psdr_tpu_torch.accel import intersect
from psdr_tpu_torch.accel.bruteforce import brute_plain
from psdr_tpu_torch.convert import params_from_numpy
from psdr_tpu_torch.core import threefry
from psdr_tpu_torch.scene.scene import Scene
from psdr_tpu_torch.testing.scenes import (cbox_scene, coincident_case,
                                           env_bench_scene, env_scene,
                                           grazing_case, sphere_light_scene,
                                           triangle_soup)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _soup_args(cuda, n_tris=2048, arrays=None):
    p0, e1, e2, o, d, act, tmax = arrays or triangle_soup(n_tris=n_tris)
    topo = t_bvh.build_bvh_topology(p0, e1, e2, leaf_size=4)
    bvh = t_bvh.refit_bvh(topo, *(torch.from_numpy(x).to(cuda)
                                  for x in (p0, e1, e2)))
    return (bvh, *(torch.from_numpy(x).to(cuda) for x in (o, d, act, tmax)))


def _assert_exact(plain, hit):
    for f in ("valid", "tri_id", "t", "uv"):
        np.testing.assert_array_equal(getattr(plain, f).cpu().numpy(),
                                      getattr(hit, f).cpu().numpy(), f)


@pytest.mark.parametrize("n_tris", [2048, 1000, 13, 7, 3])
@pytest.mark.parametrize("any_hit", [False, True])
def test_cuda_kernel_matches_plain(cuda, any_hit, n_tris):
    """K1 against k1_plain: the record bit for bit in closest-hit mode,
    ``valid`` in any-hit mode; trees of odd depth (2048 triangles: 512
    leaves), even depth (1000: 256), and of 4, 2 and 1 leaves."""
    args = _soup_args(cuda, n_tris)
    plain = intersect.k1_plain(*args)
    before = dict(intersect.LAUNCHES)
    hit = intersect.k1_cuda(*args, any_hit=any_hit)
    torch.cuda.synchronize()
    mode = "any" if any_hit else "closest"
    assert intersect.LAUNCHES[mode] == before[mode] + 1
    assert not hit.valid.cpu().numpy()[~args[3].cpu().numpy()].any()
    if any_hit:
        np.testing.assert_array_equal(plain.valid.cpu().numpy(),
                                      hit.valid.cpu().numpy())
    else:
        _assert_exact(plain, hit)


@pytest.mark.parametrize("swap", [False, True])
def test_ties_go_to_the_lowest_slot(cuda, swap):
    """Two coincident triangles in different leaves, rays from both sides:
    K1 and K3 return the copy in the lower slot, as k1_plain does."""
    (topo, *arrs), winner = coincident_case(swap)
    p0, e1, e2, *rays = (torch.from_numpy(x).to(cuda) for x in arrs)
    args = (t_bvh.refit_bvh(topo, p0, e1, e2), *rays)
    plain = intersect.k1_plain(*args)
    ids = plain.tri_id.cpu().numpy()
    assert (ids == winner).sum() > 100 and not (ids == 60 - winner).any()
    _assert_exact(plain, intersect.k1_cuda(*args))
    _assert_exact(plain, intersect.k3_cuda(*args))
    _assert_exact(plain, intersect.k3_cuda(*args, ray_block=64, tri_block=16))


@pytest.mark.parametrize("case,reference", [
    (dict(edge=0.05, dist=(20.0, 100.0), sine=(1e-4, 1e-2)), "k1_plain"),
    (dict(edge=0.02, dist=(200.0, 1000.0), sine=(1e-3, 1e-1)), "k1_plain"),
    (dict(edge=0.3, dist=(1000.0, 5000.0), sine=(1e-6, 1e-4)),
     "k1_walk_plain")])
def test_grazing_rays(cuda, case, reference):
    """Grazing rays and far origins over small triangles: K1 equals
    k1_plain bit for bit while Moller-Trumbore's t stays within the cull
    margin, and equals its own walk in tensor code beyond that."""
    args = _soup_args(cuda, arrays=grazing_case(**case))
    _assert_exact(getattr(intersect, reference)(*args),
                  intersect.k1_cuda(*args))


def test_counting_instantiation_counts(cuda):
    """The counting instantiation returns the same record and counts at
    least one slab test and one triangle test run in full for every ray
    that hits; some tests are left after u and some after v."""
    args = _soup_args(cuda)
    counts = torch.zeros((4,), dtype=torch.int64, device=cuda)
    hit = intersect.k1_cuda(*args, counts=counts)
    _assert_exact(intersect.k1_cuda(*args), hit)
    n_hit = int(hit.valid.sum())
    n_box, left_at_u, left_at_v, in_full = (int(c) for c in counts.cpu())
    assert n_box >= n_hit and in_full >= n_hit
    assert left_at_u > 0 and left_at_v > 0


def test_default_device_is_the_card(cuda):
    """Scene() and the scene makers land on the card when the caller names
    no device."""
    assert Scene().device.type == "cuda"
    sc = cbox_scene(8, 8, spp=1)
    assert sc.build(sc.params()).tri.p0.is_cuda
    assert params_from_numpy(sc.params())["meshes"][0][
        "vertex_positions"].is_cuda


def test_render_on_card_matches_cpu(cuda):
    """renderC on 1,292 triangles (above accel_min_faces, so K1 runs) on the
    card and on the CPU, same key: at least 99% of pixels allclose (rtol
    1e-4, atol 1e-5) and image means within 1e-4 relative, the tolerance of
    tests/test_torch_render.py."""
    imgs = []
    intersect.reset_launch_counts()
    for dev in (cuda, torch.device("cpu")):
        sc = cbox_scene(16, 16, spp=4, occluder_subdiv=3, device=dev)
        imgs.append(DirectIntegrator(1, 1).renderC(sc, seed=5).cpu().numpy())
    assert intersect.LAUNCHES["closest"] > 0 and intersect.LAUNCHES["any"] > 0
    card, cpu = imgs
    assert np.isfinite(card).all() and card.mean() > 0.0
    close = np.isclose(card, cpu, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() >= 0.99
    assert abs(card.mean() - cpu.mean()) / cpu.mean() < 1e-4


@pytest.mark.parametrize("n_tris", [24, 700])
def test_k2_matches_plain_exactly(cuda, n_tris):
    """K2 against brute_plain: its unrolled branch (up to 24 faces, as the
    emitter-first sweep takes) and its chunked one; equal bit for bit."""
    p0, e1, e2, o, d, act, tmax = triangle_soup(n_tris=n_tris)
    args = [torch.from_numpy(x).to(cuda) for x in (p0, e1, e2, o, d, act,
                                                   tmax)]
    before = intersect.LAUNCHES["k2"]
    hit = intersect.ray_intersect_brute(*args)
    torch.cuda.synchronize()
    assert intersect.LAUNCHES["k2"] == before + 1
    _assert_exact(brute_plain(*args), hit)


@pytest.mark.parametrize("ray_block,tri_block", [(512, 128), (128, 256),
                                                 (32, 8)])
def test_k3_matches_plain_exactly(cuda, ray_block, tri_block):
    """K3 against k1_plain (its plain version) on the 2048-triangle soup,
    at its default blocking and two others: equal bit for bit."""
    args = _soup_args(cuda)
    before = intersect.LAUNCHES["k3"]
    hit = intersect.ray_intersect_k3(*args, ray_block=ray_block,
                                     tri_block=tri_block)
    torch.cuda.synchronize()
    assert intersect.LAUNCHES["k3"] == before + 1
    _assert_exact(intersect.k1_plain(*args), hit)


def _grads(device, seed=3, integ=None, **boundary):
    sc = cbox_scene(64, 64, spp=4, occluder_subdiv=3, device=device,
                    **boundary)
    p = params_from_numpy(sc.params(), device=device, requires_grad=True)
    img = (integ or DirectIntegrator(1, 1)).render_fn(
        sc, with_boundary=bool(boundary))(p, threefry.PRNGKey(seed))
    loss = torch.mean(img ** 2)
    loss.backward()
    leaves = [x for m in p["meshes"] for x in m.values()] + [
        x for k in ("bsdfs", "emitters", "sensors") for m in p[k]
        for x in m.values()]
    return float(loss), [x.grad.cpu().numpy().ravel() for x in leaves]


def _assert_leaves_close(cpu, card):
    for a, g in zip(cpu, card):
        assert np.isfinite(g).all()
        na = np.linalg.norm(a)
        assert np.linalg.norm(g - a) <= 1e-2 * na
        if na > 0:
            assert float(g @ a) / (np.linalg.norm(g) * na) >= 0.999


def test_boundary_grad_on_card_matches_cpu(cuda):
    """value_and_grad through render_fn(with_boundary=True) at 64x64, spp 4,
    sppe 2, sppse 4 (the secondary pass compacts 16,384 lanes to 4,096):
    the loss within 1e-5 relative, every leaf finite and within 1e-2
    relative L2 and cosine 0.999 of the CPU's; each boundary term's image
    exactly zero on the card."""
    intersect.reset_launch_counts()
    card_loss, card = _grads(cuda, sppe=2, sppse=4)
    assert all(intersect.LAUNCHES[k] > 0 for k in ("closest", "any", "k2"))
    cpu_loss, cpu = _grads(torch.device("cpu"), sppe=2, sppse=4)
    _, interior = _grads(cuda)
    assert abs(card_loss - cpu_loss) <= 1e-5 * cpu_loss
    _assert_leaves_close(cpu, card)
    assert max(np.abs(a - b).max() for a, b in zip(card, interior)) > 1e-4
    sc = cbox_scene(64, 64, spp=4, sppe=2, sppse=4, occluder_subdiv=3)
    integ = DirectIntegrator(1, 1)
    with torch.no_grad():
        flat = sc.build(sc.params())
        for term in (integ.render_primary_edges,
                     integ.render_secondary_edges):
            img = term(sc, flat, 0, threefry.PRNGKey(3))
            assert img.shape == (4096, 3) and not bool(img.any())


def test_guiding_on_card_matches_cpu(cuda):
    """preprocess_secondary_edges at (6, 3, 3, 4), 2 rounds: the cell
    masses on the card within rtol 1e-4 (atol 1e-4 of the largest cell; the
    per-cell sums add in one fixed order on both, but the lanes' values
    round apart between the devices) of the CPU's; a guided boundary gradient
    on the card matches the CPU's under the same table."""
    out = []
    for dev in (cuda, torch.device("cpu")):
        sc = cbox_scene(64, 64, spp=4, sppse=4, occluder_subdiv=3, device=dev)
        integ = DirectIntegrator(1, 1)
        integ.preprocess_secondary_edges(sc, 0, (6, 3, 3, 4), nrounds=2,
                                         seed=3)
        out.append((integ, integ.warpper[0].distrb.pmf.cpu().numpy()))
    (i_card, m_card), (i_cpu, m_cpu) = out
    assert m_card.shape == (54,) and (m_card > 0).any()
    np.testing.assert_allclose(m_card, m_cpu, rtol=1e-4,
                               atol=1e-4 * m_cpu.max())
    _, card = _grads(cuda, integ=i_card, sppse=4)
    _, cpu = _grads(torch.device("cpu"), integ=i_cpu, sppse=4)
    _assert_leaves_close(cpu, card)


def test_compaction_and_table_search_on_card_match_cpu(cuda):
    """_compact_boundary_lanes (two stable segmented sorts) gives the CPU's
    indices, weights and liveness exactly, an overflowing segment and tied
    keys included; discrete_sample_reuse on a 30,720-entry table gives the
    CPU's idx, pdf and remapped sample on one cmf."""
    from psdr_tpu_torch.convert import discrete_from_numpy
    from psdr_tpu_torch.core.distribution import (discrete_init,
                                                  discrete_sample_reuse)
    from psdr_tpu_torch.integrator.direct import _compact_boundary_lanes
    s, ks, segs = 2048, 512, 4
    rng = np.random.default_rng(12)
    valid = rng.uniform(size=s * segs) < np.repeat([0.03, 0.6, 0.0, 0.2], s)
    edge = np.sort(rng.integers(0, 300, s * segs) / 300.0).astype(np.float32)
    u = (rng.integers(0, 1000, s * segs) / 1000.0).astype(np.float32)
    res = [_compact_boundary_lanes(*(torch.from_numpy(x).to(d)
                                     for x in (valid, edge, u)), s, ks)
           for d in (cuda, "cpu")]
    for a, b in zip(*res):
        np.testing.assert_array_equal(a.cpu().numpy(), b.numpy())
    pmf = rng.uniform(0, 1, 30720).astype(np.float32)
    pmf[rng.uniform(size=30720) < 0.3] = 0.0
    smp = rng.uniform(size=50000).astype(np.float32)
    cmf = discrete_init(torch.from_numpy(pmf)).cmf.numpy()
    res = [discrete_sample_reuse(discrete_from_numpy(pmf, cmf, device=d),
                                 torch.from_numpy(smp).to(d))
           for d in (cuda, "cpu")]
    for a, b in zip(*res):
        np.testing.assert_array_equal(a.cpu().numpy(), b.numpy())


@pytest.mark.parametrize("n,live", [(1, 1), (7, 0), (300, 0), (300, 5)])
def test_tiny_and_all_inactive_launches(cuda, n, live):
    """K1 (both modes) and K2 take launches of a few rays and launches
    whose lanes are all inactive, as the compacted boundary wavefront sends
    them, and equal their plain versions."""
    p0, e1, e2, o, d, _, tmax = triangle_soup(n_tris=700)
    act = np.zeros(n, bool)
    act[:live] = True
    rays = [torch.from_numpy(x[:n].copy()).to(cuda) for x in (o, d, act, tmax)]
    tris = [torch.from_numpy(x).to(cuda) for x in (p0, e1, e2)]
    _assert_exact(brute_plain(*tris, *rays),
                  intersect.ray_intersect_brute(*tris, *rays))
    topo = t_bvh.build_bvh_topology(p0, e1, e2, leaf_size=4)
    bvh = t_bvh.refit_bvh(topo, *tris)
    plain = intersect.k1_plain(bvh, *rays)
    _assert_exact(plain, intersect.ray_intersect_k1(bvh, *rays))
    any_hit = intersect.ray_intersect_k1(bvh, *rays, any_hit=True)
    np.testing.assert_array_equal(plain.valid.cpu().numpy(),
                                  any_hit.valid.cpu().numpy())
    assert int(plain.valid.sum()) <= live


def test_grad_on_card_matches_cpu(cuda):
    """value_and_grad of mean(img^2) at 64x64, spp 4 (1,292 triangles: K1
    and K2 on the card): the loss within 1e-5 relative, every leaf finite,
    within 1e-2 relative L2 and cosine >= 0.999 of the CPU's, the bound of
    tests/test_torch_grad.py (the forward is exact; the backward's
    scatter-adds run in another order)."""
    intersect.reset_launch_counts()
    card_loss, card = _grads(cuda)
    assert intersect.LAUNCHES["closest"] > 0 and intersect.LAUNCHES["k2"] > 0
    cpu_loss, cpu = _grads(torch.device("cpu"))
    assert abs(card_loss - cpu_loss) <= 1e-5 * cpu_loss
    _assert_leaves_close(cpu, card)


@pytest.mark.parametrize("max_depth,camera_depth,boundary", [
    (3, 1, {}), (2, 2, dict(sppe=2, sppse=4))])
def test_path_tracer_grad_on_card_matches_cpu(cuda, max_depth, camera_depth,
                                              boundary):
    """value_and_grad of mean(img^2) under the PathTracer at 64x64, spp 4:
    PathTracer(3) interior, and PathTracer(2, camera_depth=2) with sppe 2,
    sppse 4 (the fused boundary pass, compacted): the loss within 1e-5
    relative, every leaf finite and within 1e-2 relative L2 and cosine
    0.999 of the CPU's; K1 in both modes and K2 launched; the secondary
    boundary image exactly zero on the card."""
    integ = PathTracer(max_depth, camera_depth=camera_depth)
    intersect.reset_launch_counts()
    card_loss, card = _grads(cuda, integ=integ, **boundary)
    assert all(intersect.LAUNCHES[k] > 0 for k in ("closest", "any", "k2"))
    cpu_loss, cpu = _grads(torch.device("cpu"), integ=integ, **boundary)
    assert abs(card_loss - cpu_loss) <= 1e-5 * cpu_loss
    _assert_leaves_close(cpu, card)
    if boundary:
        sc = cbox_scene(64, 64, spp=4, occluder_subdiv=3, **boundary)
        with torch.no_grad():
            img = integ.render_secondary_edges(sc, sc.build(sc.params()), 0,
                                               threefry.PRNGKey(3))
        assert img.shape == (4096, 3) and not bool(img.any())


def test_k2_exact_at_14_faces_of_an_envmap_scene(cuda):
    """K2 on the emitter-first face list of a scene with an area light and
    an environment map (2 + 12 faces, the bounding box's spanning the whole
    scene), rays from inside the box in every direction, a third with a
    ``tmax`` short of the box: equal to brute_plain bit for bit; every ray
    without a ``tmax`` hits the box."""
    sc = env_bench_scene(32, 32, 4, sphere_subdiv=2, small_subdiv=1,
                         env_size=(34, 66), tex_size=16)
    flat = sc.flat
    idx = flat.em_tri_idx
    assert idx.shape == (14,)
    tris = [x[idx].contiguous() for x in (flat.tri.p0, flat.tri.e1,
                                          flat.tri.e2)]
    rng = np.random.default_rng(13)
    n = 1 << 16
    o = rng.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)   # inside the box
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    act = rng.uniform(size=n) > 0.1
    tmax = np.where(rng.uniform(size=n) > 0.33, np.inf,
                    rng.uniform(0.2, 3.0, n)).astype(np.float32)
    rays = [torch.from_numpy(x).to(cuda) for x in (o, d, act, tmax)]
    before = intersect.LAUNCHES["k2"]
    hit = intersect.ray_intersect_brute(*tris, *rays)
    torch.cuda.synchronize()
    assert intersect.LAUNCHES["k2"] == before + 1
    _assert_exact(brute_plain(*tris, *rays), hit)
    free = act & np.isinf(tmax)
    assert hit.valid.cpu().numpy()[free].all()


def _env_grads(device, integ, **kw):
    sc = env_scene(RoughConductor(alpha_u=0.3, alpha_v=0.2), device=device,
                   **kw)
    p = params_from_numpy(sc.params(), device=device, requires_grad=True)
    img = integ.render_fn(sc, with_boundary=bool(kw.get("sppse")))(
        p, threefry.PRNGKey(3))
    loss = torch.mean(img ** 2)
    loss.backward()
    leaves = [x for k in ("meshes", "bsdfs", "emitters", "sensors")
              for m in p[k] for x in m.values()]
    return float(loss), [x.grad.cpu().numpy().ravel() for x in leaves]


@pytest.mark.parametrize("boundary", [{}, dict(sppe=2, sppse=4)])
def test_envmap_roughconductor_grad_on_card_matches_cpu(cuda, boundary):
    """value_and_grad of mean(img^2) under PathTracer(2) on env_scene with
    a rough-conductor sphere, 64 x 64 at spp 4, interior and with the
    boundary terms: the loss within 1e-5 relative, every leaf (roughness,
    eta, k, the map's texels, scale and rotation among them) finite and
    within 1e-2 relative L2 and cosine 0.999 of the CPU's; K2 ran on the
    12 bounding faces."""
    kw = dict(width=64, height=64, spp=4, **boundary)
    intersect.reset_launch_counts()
    card_loss, card = _env_grads(cuda, PathTracer(2), **kw)
    assert intersect.LAUNCHES["k2"] > 0
    cpu_loss, cpu = _env_grads(torch.device("cpu"), PathTracer(2), **kw)
    assert abs(card_loss - cpu_loss) <= 1e-5 * cpu_loss
    _assert_leaves_close(cpu, card)


@pytest.mark.parametrize("frozen", ["1", "0"])
def test_envmap_importance_grid_on_card_matches_cpu(cuda, frozen, monkeypatch):
    """configure_envmap on a 260 x 520 sky (above 2^18 fine cells: the
    divided 259 x 129 grid), frozen on the host and, with
    ``PSDR_TPU_ENV_FROZEN=0``, max-pooled on the device: the card's table
    equals the CPU's (the frozen one bit for bit), and no cell is empty."""
    from psdr_tpu_torch.emitter.envmap import configure_envmap
    monkeypatch.setenv("PSDR_TPU_ENV_FROZEN", frozen)
    monkeypatch.delenv("PSDR_TPU_ENV_RESO_DIV", raising=False)
    rad = np.random.default_rng(14).uniform(0.05, 1.0, (260, 520, 3)).astype(
        np.float32)
    rad[90:92, 100:102] = 400.0
    tables = []
    for dev in (cuda, torch.device("cpu")):
        p = {"radiance": torch.from_numpy(rad).to(dev),
             "scale": torch.tensor(1.0, device=dev),
             "to_world": torch.eye(4, device=dev)}
        st = configure_envmap(p, torch.zeros(3, device=dev),
                              torch.ones(3, device=dev), host_radiance=rad)
        assert st.cell_distrb.resolution == (259, 129)
        tables.append(st.cell_distrb.distrb.pmf.cpu().numpy())
    card, cpu = tables
    assert (card > 0).all()
    if frozen == "1":
        np.testing.assert_array_equal(card, cpu)
    else:
        np.testing.assert_allclose(card, cpu, rtol=1e-5, atol=1e-7)


def _opt_step(device, paths, **kw):
    """One Optimizer step through render_fn(with_boundary=True) on
    sphere_light_scene(**kw): (optimizer, loss, {path: gradient})."""
    from psdr_tpu_torch.opt import Optimizer
    sc = sphere_light_scene(**kw, device=device)
    opt = Optimizer(sc, paths, lr=1e-2)
    render = DirectIntegrator(1, 1).render_fn(sc, with_boundary=True)
    seen = {}
    update = opt.update
    opt.update = lambda grads: (seen.update(grads), update(grads))[1]
    loss = opt.step(lambda p, key: torch.mean(render(p, key) ** 2),
                    threefry.PRNGKey(3))
    return opt, loss, seen


def test_optimizer_step_on_card_matches_cpu(cuda, tmp_path):
    """One masked-Adam step with the boundary terms (32x32, spp 8, sppe 2,
    sppse 8) on the card and on the CPU: the loss within 1e-5 relative,
    each selected leaf's gradient within 1e-2 relative L2 and cosine 0.999,
    every one finite; given the card's gradients the CPU's Adam update
    equals the card's to 1e-6; a save / load round trip on the card
    resumes with the same next step."""
    from psdr_tpu_torch.opt import Optimizer
    paths = ["Mesh[0]", "BSDF[id=white].reflectance", "Emitter[0].radiance"]
    kw = dict(width=32, height=32, spp=8, sppe=2, sppse=8)
    card, l_card, g_card = _opt_step(cuda, paths, **kw)
    _, l_cpu, g_cpu = _opt_step(torch.device("cpu"), paths, **kw)
    assert abs(l_card - l_cpu) <= 1e-5 * l_cpu
    assert sorted(g_card) == sorted(g_cpu) and len(g_card) == 4
    _assert_leaves_close([g_cpu[k].numpy().ravel() for k in sorted(g_cpu)],
                         [g_card[k].cpu().numpy().ravel()
                          for k in sorted(g_card)])
    host = Optimizer(sphere_light_scene(**kw, device="cpu"), paths, lr=1e-2)
    host.update({k: v.cpu() for k, v in g_card.items()})
    for (g, i, n), leaf in card.trainable():
        np.testing.assert_allclose(leaf.cpu().numpy(),
                                   host.params[g][i][n].numpy(), rtol=1e-6,
                                   atol=1e-7)
    card.save(str(tmp_path / "ck.npz"))
    again = Optimizer(card.scene, paths, lr=1e-2)
    again.load(str(tmp_path / "ck.npz"))
    render = DirectIntegrator(1, 1).render_fn(card.scene, with_boundary=True)

    def loss_fn(p, key):
        return torch.mean(render(p, key) ** 2)

    for o in (card, again):
        o.step(loss_fn, threefry.PRNGKey(4))
    for (path, a), (_, b) in zip(card.trainable(), again.trainable()):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=1e-6, atol=1e-7)


def test_loaded_scene_on_card_matches_cpu(cuda, tmp_path):
    """The cbox with a textured floor written by ``write_scene`` (OBJ, EXR,
    XML) and loaded on each device: equal params, and renderC on the card
    against the CPU at tests/test_torch_render.py's tolerance."""
    from psdr_tpu_torch import Diffuse, load_file
    from psdr_tpu_torch.core.bitmap import from_array
    from psdr_tpu_torch.testing.scenes import checker_texture, write_scene
    sc = cbox_scene(32, 32, spp=4, occluder_subdiv=3, device="cpu")
    sc.meshes[0].bsdf_id = sc.add_bsdf(
        Diffuse(from_array(checker_texture(64))), "floor")
    path = write_scene(sc, str(tmp_path))
    imgs = []
    for dev in (cuda, torch.device("cpu")):
        ls = load_file(path, device=dev)
        assert ls.flat.tri.p0.device.type == dev.type
        imgs.append(DirectIntegrator(1, 1).renderC(ls, seed=5).cpu().numpy())
    card, cpu = imgs
    assert np.isfinite(card).all() and card.mean() > 0.0
    close = np.isclose(card, cpu, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() >= 0.99
    assert abs(card.mean() - cpu.mean()) / cpu.mean() < 1e-4


# -- the sharded steps and the flagship (chip_smoke.py phases 25-27) -----------

def _rel_l2(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _grad_close(a, b):
    """A gradient leaf computed in another process against its reference
    on the card: finite and, where the reference is not zero, within 1e-2
    relative L2 and a cosine of 0.999, the card-against-CPU bound of this
    file (the card's atomic sums differ run to run; a double-counted
    reduction is off by 50%)."""
    assert np.isfinite(a).all()
    if np.abs(b).any():
        x, y = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
        assert _rel_l2(x, y) <= 1e-2
        assert x @ y / (np.linalg.norm(x) * np.linalg.norm(y)) >= 0.999


def test_sharded_render_on_card_matches_serial(cuda):
    """Phase 25's check at the CPU suite's sizes: two gloo ranks share the
    card; each case of ``testing.ranks.sharded_cases`` equals the serial
    emulation on the card (image rtol 2e-5, atol 2e-6; gradient per leaf
    under ``_grad_close``); the overlapped and one-bucket train steps agree
    as closely; the collective direct guiding table equals the serial one
    (rtol 1e-5)."""
    from psdr_tpu_torch.opt import leaf_items
    from psdr_tpu_torch.parallel import run_ranks
    from psdr_tpu_torch.parallel.sharding import per_device_render_fn
    from psdr_tpu_torch.testing import ranks
    out = run_ranks(ranks.sharded_checks, 2, args=("cuda",), timeout=900)[0]
    for name, kw, integ, with_boundary, seed in ranks.sharded_cases():
        img, grads = out[name][:2]
        sc = cbox_scene(**kw, device=cuda)
        g = per_device_render_fn(integ(), sc, 2, with_boundary=with_boundary)
        p = params_from_numpy(sc.params(), cuda, requires_grad=True)
        key = threefry.PRNGKey(seed)
        ref = (g(p, key, 0) + g(p, key, 1)) / 2
        ranks.sharded_loss(ref).backward()
        np.testing.assert_allclose(img, ref.detach().cpu().numpy(),
                                   rtol=2e-5, atol=2e-6, err_msg=name)
        for a, (_, x) in zip(grads, leaf_items(p)):
            _grad_close(a, np.zeros_like(a) if x.grad is None
                        else x.grad.cpu().numpy())
    (la, pa), (lb, pb) = out["steps"]
    assert abs(la - lb) <= 1e-5 * la
    p0 = [x.numpy() for _, x in leaf_items(params_from_numpy(
        cbox_scene(24, 24, spp=8, device="cpu").params(), "cpu"))]
    for a, b, q in zip(pa, pb, p0):
        _grad_close(a - q, b - q)
    sc = ranks.guiding_scene(cuda)
    serial = DirectIntegrator(1, 1)
    serial.preprocess_secondary_edges(sc, 0, ranks.GUIDING["reso"],
                                      ranks.GUIDING["nrounds"],
                                      ranks.GUIDING["seed"])
    ref = serial.warpper[0].distrb.pmf.cpu().numpy()
    np.testing.assert_allclose(out["guiding"][0], ref, rtol=1e-5,
                               atol=1e-6 * ref.max())


def test_nccl_one_rank_render_equals_plain(cuda):
    """A one-rank NCCL group (the only NCCL a one-card machine can run):
    ``shard_render_fn`` with the boundary terms equals the plain render
    under ``fold_in(key, 0)`` (image rtol 2e-5, atol 2e-6; gradient per
    leaf under ``_grad_close``) with the same K1 and K2 launch counts."""
    from psdr_tpu_torch.parallel import run_ranks
    from psdr_tpu_torch.testing import ranks
    out = run_ranks(ranks.one_rank_render, 1, backend="nccl",
                    args=("cuda",), timeout=900)[0]
    (img, grads, launches), (p_img, p_grads, p_launches) = (
        out["sharded"], out["plain"])
    np.testing.assert_allclose(img, p_img, rtol=2e-5, atol=2e-6)
    for a, b in zip(grads, p_grads):
        _grad_close(a, b)
    assert launches == p_launches
    assert launches["closest"] > 0 and launches["any"] > 0
    assert launches["k2"] > 0


def test_multiview_step_on_card_matches_serial(cuda):
    """Phase 26's check at 16 x 16: two views on two gloo ranks sharing the
    card, one ``sgd(1e3)`` step (a rate at which each step stands far
    above the float32 rounding of the parameter it moves): the loss within
    1e-5 and each leaf's update over the rate under ``_grad_close`` against
    the serial emulation's gradient on the card."""
    from psdr_tpu_torch.opt import leaf_items
    from psdr_tpu_torch.parallel import run_ranks
    from psdr_tpu_torch.testing import ranks
    n_views, lr, seed = 2, 1e3, 3
    sc = ranks.multiview_scene(n_views, device=cuda)
    sc.prepare_accel()
    p = params_from_numpy(sc.params(), cuda, requires_grad=True)
    integ = DirectIntegrator(1, 1)
    with torch.no_grad():
        flat = sc.build(p)
        targets = [integ.radiance_image(sc, flat, s,
                                        threefry.PRNGKey(900 + s), False)
                   .cpu().numpy() for s in range(n_views)]
    out = run_ranks(ranks.multiview_step, 2,
                    args=(functools.partial(ranks.multiview_start, n_views),
                          targets, lr, seed, "cuda"), timeout=900)[0]
    loss, p1 = out["loss"], out["params"]

    def serial():
        q = params_from_numpy(sc.params(), cuda, requires_grad=True)
        flat = sc.build(q)
        total = 0.0
        for d in range(2):
            img = integ.radiance_image(
                sc, flat._replace(sensors=(flat.sensors[d % n_views],)), 0,
                threefry.fold_in(threefry.PRNGKey(seed), d), True)
            total = total + torch.mean((img - torch.as_tensor(
                targets[d % n_views], device=cuda)) ** 2)
        total = total / 2
        total.backward()
        return total.item(), [
            np.zeros(x.shape, np.float32) if x.grad is None
            else x.grad.cpu().numpy() for _, x in leaf_items(q)]

    ref_loss, g1 = serial()
    assert abs(loss - ref_loss) <= 1e-5 * ref_loss
    for a, (_, x), g in zip(p1, leaf_items(p), g1):
        _grad_close((a - x.detach().cpu().numpy()) / lr, -g)


def test_flagship_recovery_on_card_lowers_rmse(cuda, tmp_path):
    """Phase 27 at the ``--small`` size: three iterations on the card, a
    finite loss and gradient each, the vertex RMSE below its start, and
    the example's files written."""
    from psdr_tpu_torch.examples import flagship_recovery
    seen = []
    summary = flagship_recovery.run(
        3, str(tmp_path), True, cuda,
        on_iter=lambda rec, g: seen.append(
            np.isfinite(rec["loss"]) and bool(torch.isfinite(g).all())))
    assert seen == [True] * 3
    assert summary["rmse_final"] < summary["rmse0"]
    assert (tmp_path / "recovered_occluder.obj").stat().st_size > 0


# -- the captured programs (psdr_tpu_torch/program.py) ---------------------------

def _eager_renderC(integ, sc, seed):
    from psdr_tpu_torch.scene.scene import detach_flat
    with torch.no_grad():
        return integ.radiance_image(sc, detach_flat(sc.flat), 0,
                                    threefry.PRNGKey(seed), False).reshape(
                                        sc.opts.height, sc.opts.width, 3)


@pytest.mark.parametrize("integ", ["direct", "path"])
def test_program_replay_equals_eager_at_each_seed(cuda, integ):
    """renderC through its captured program (64x64, spp 4, 1,292
    triangles) equals the eager render with a host key bit for bit at
    seeds 0, 1, 0 (no build in the program: no atomic sum), seed 1 differs
    from seed 0 (no key baked in), and one replay launches what the eager
    frame launches."""
    sc = cbox_scene(64, 64, spp=4, occluder_subdiv=3, device=cuda)
    it = DirectIntegrator(1, 1) if integ == "direct" else PathTracer(2)
    want = {s: _eager_renderC(it, sc, s) for s in (0, 1)}
    intersect.reset_launch_counts()
    _eager_renderC(it, sc, 0)
    eager = dict(intersect.LAUNCHES)
    it.renderC(sc, seed=0)                      # warm-up, capture, replay
    (prog,) = it._radiance_jits.values()
    assert prog.captured and prog.nodes > 0 and prog.pool_bytes > 0
    intersect.reset_launch_counts()
    imgs = [it.renderC(sc, seed=s) for s in (0, 1, 0)]
    torch.cuda.synchronize()
    assert {k: 3 * v for k, v in eager.items()} == intersect.LAUNCHES
    for s, img in zip((0, 1, 0), imgs):
        assert torch.equal(img, want[s])
    assert float((imgs[1] - imgs[0]).abs().mean()) > 1e-3


def test_render_program_matches_render_fn(cuda):
    """``render_program`` (the scene rebuilt from the params inside the
    graph) against ``render_fn(detached=True)``: equal up to the atomic
    sums of the build's vertex normals."""
    from psdr_tpu_torch.profiling import render_timed
    sc = cbox_scene(64, 64, spp=4, occluder_subdiv=3, device=cuda)
    integ = DirectIntegrator(1, 1)
    p = params_from_numpy(sc.params(), device=cuda)
    prog = integ.render_program(sc)
    for s in (0, 1):
        want = integ.render_fn(sc, with_boundary=False, detached=True)(
            p, threefry.PRNGKey(s))
        got = prog(p, threefry.PRNGKey(s, device=cuda))
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="was built for"):
        prog(p, threefry.PRNGKey(0, device=cuda).to(torch.int32))
    # render_timed waits for the replay: its image is renderC's
    img, secs = render_timed(integ, sc, seed=2)
    assert secs > 0 and torch.equal(img, integ.renderC(sc, seed=2))


def test_program_capture_of_host_data_fails_loudly(cuda):
    """A body that copies host data cannot be captured: the call raises
    (the warm-up ran once, nothing runs eagerly in the capture's place),
    every later call raises without running the body, and the card stays
    usable."""
    from psdr_tpu_torch.program import Program
    calls = []

    def body(x):
        calls.append(1)
        return x + torch.tensor([1.0], device=x.device)

    prog = Program(body, "host data")
    x = torch.ones(4, device=cuda)
    with pytest.raises(RuntimeError, match="capture"):
        prog(x)
    n = len(calls)
    with pytest.raises(RuntimeError, match="capture failed"):
        prog(x)
    assert len(calls) == n and not prog.captured
    assert float((x * 2).sum()) == 8.0


# -- the gradient programs ------------------------------------------------------

def _close_trees(got, want, rtol=1e-4):
    """Leaf by leaf within rtol of the leaf's largest entry (the atomic
    sums of ``index_add_`` move the last places run to run)."""
    from torch.utils._pytree import tree_flatten
    for a, b in zip(tree_flatten(got)[0], tree_flatten(want)[0]):
        scale = max(float(b.abs().max()), 1e-12) if b.numel() else 1.0
        assert float((a - b).abs().max()) <= rtol * scale


@pytest.mark.parametrize("boundary", [False, True])
def test_grad_program_replay_equals_eager(cuda, boundary):
    """``grad_program`` (64x64, spp 4, with and without every boundary
    term): the replay's loss and every gradient leaf equal the eager
    ``value_and_grad`` at seeds 0 and 1, seed 1 differs from seed 0, the
    gradient buffers keep their addresses across replays, and a replay
    launches what the eager step launches."""
    from torch.utils._pytree import tree_flatten
    kw = dict(sppe=2, sppse=16) if boundary else {}
    sc = cbox_scene(64, 64, spp=4, occluder_subdiv=3, device=cuda, **kw)
    integ = DirectIntegrator(1, 1)
    prog = integ.grad_program(sc, torch.zeros(64 * 64, 3, device=cuda),
                              with_boundary=boundary)
    p = params_from_numpy(sc.params(), device=cuda)
    with torch.enable_grad():
        want = {s: prog.fn(p, threefry.PRNGKey(s)) for s in (0, 1)}
    intersect.reset_launch_counts()
    with torch.enable_grad():
        prog.fn(p, threefry.PRNGKey(0))
    eager = dict(intersect.LAUNCHES)
    prog(p, threefry.PRNGKey(0, device=cuda))     # warm-up, capture, replay
    assert prog.captured and prog.nodes > 0 and prog.pool_bytes > 0
    ptrs = [x.data_ptr() for x in prog._outputs[0]]
    intersect.reset_launch_counts()
    got = {s: prog(p, threefry.PRNGKey(s, device=cuda)) for s in (0, 1)}
    torch.cuda.synchronize()
    assert intersect.LAUNCHES == {k: 2 * v for k, v in eager.items()}
    assert [x.data_ptr() for x in prog._outputs[0]] == ptrs
    for s in (0, 1):
        _close_trees(got[s], want[s])
    assert float(got[1][0]) != float(got[0][0])
    assert all(torch.isfinite(x).all() for x in tree_flatten(got[0])[0])


def test_update_guiding_and_vjp_programs_replay_equal_eager(cuda):
    """The optimizer's ``_jit_update`` (two updates against the same
    arithmetic run eagerly), a guiding build replayed at a second seed
    against its eager body, and a ``VJPProgram``'s forward and backward
    against autograd's, each on the card."""
    from psdr_tpu_torch.opt import Optimizer
    from psdr_tpu_torch.program import VJPProgram
    sc = cbox_scene(32, 32, spp=2, sppse=4, occluder_subdiv=3, device=cuda)
    opt = Optimizer(sc, ["Mesh[5].vertex_positions"], lr=0.01)
    paths, leaves = zip(*opt.trainable())
    gen = torch.Generator(device=cuda).manual_seed(0)
    for _ in range(2):
        g = [torch.randn(x.shape, device=cuda, generator=gen) for x in leaves]
        args = (list(leaves), g, [opt.state["mu"][q] for q in paths],
                [opt.state["nu"][q] for q in paths], opt.state["count"])
        with torch.no_grad():
            want = opt._update(*args)
        opt.update(dict(zip(paths, g)))
        assert torch.equal(leaves[0], want[0][0])
        assert torch.equal(opt.state["mu"][paths[0]], want[1][0])
    assert opt._jit_update.captured and int(opt.state["count"]) == 2

    integ = DirectIntegrator(1, 1)
    for seed in (3, 4):
        integ.preprocess_secondary_edges(sc, 0, (8, 3, 3, 4), nrounds=2,
                                         seed=seed)
    (prog,) = integ._guiding_jits.values()
    with torch.no_grad():
        want = prog.fn(threefry.PRNGKey(4)) / 2
    _close_trees(integ.warpper[0].distrb.pmf, want, rtol=1e-5)

    x = torch.randn(64, device=cuda)
    vjp = VJPProgram(lambda v, k: torch.sin(v) * k, "vjp")
    for k in (2.0, 3.0):
        kt = torch.full((64,), k, device=cuda)
        y = vjp(x, kt)
        g = vjp.vjp(torch.ones(64, device=cuda))
        assert torch.allclose(y, torch.sin(x) * k)
        assert torch.allclose(g, torch.cos(x) * k)
    assert vjp.captured


def test_rebuild_recaptures_the_grad_program(cuda):
    """A forced BVH rebuild (``Optimizer.maybe_rebuild_accel``) makes a
    captured ``grad_program`` capture again at its next call, and that
    replay equals the eager step on the new tree."""
    from psdr_tpu_torch.opt import Optimizer
    sc = sphere_light_scene(32, 32, spp=2, subdiv=3, device=cuda)
    sc.prepare_accel()
    opt = Optimizer(sc, ["Mesh[0].vertex_positions"])
    prog = DirectIntegrator(1, 1).grad_program(
        sc, torch.zeros(32 * 32, 3, device=cuda))
    key = threefry.PRNGKey(1, device=cuda)
    prog(opt.params, key)
    assert prog.captures == 1
    vp = opt.params["meshes"][0]["vertex_positions"]
    a = 3.0 * vp[:, 1:2]
    vp.copy_(torch.cat([torch.cos(a) * vp[:, :1] - torch.sin(a) * vp[:, 2:],
                        vp[:, 1:2],
                        torch.sin(a) * vp[:, :1] + torch.cos(a) * vp[:, 2:]],
                       1))
    assert opt.maybe_rebuild_accel(threshold=sc.refit_quality(opt.params)
                                   - 0.01)
    got = prog(opt.params, key)
    assert prog.captures == 2
    with torch.enable_grad():
        want = prog.fn(opt.params, threefry.PRNGKey(1))
    _close_trees(got, want)


@pytest.mark.parametrize("case", ["flagship step", "train step whole",
                                  "train step split"])
def test_rebuild_recaptures_the_scene_programs(cuda, case):
    """A forced BVH rebuild makes every program that builds the scene
    capture again at its next call (the flagship step; the sharded train
    step on a one-rank mesh without a group, in both forms), and that
    replay equals a program made after the rebuild."""
    import dataclasses
    from psdr_tpu_torch.examples import flagship_recovery as fr
    from psdr_tpu_torch.opt import adam, sgd
    from psdr_tpu_torch.parallel import make_train_step
    from psdr_tpu_torch.testing.ranks import LocalRank, LocalSplitRank

    key = threefry.PRNGKey(1, device=cuda)
    if case == "flagship step":
        sc = fr.build_scene(True, cuda)
        sc.opts = dataclasses.replace(sc.opts, width=32, height=32, spp=2,
                                      sppe=2, sppse=4)
        sc.accel_min_faces = 1
        sc.prepare_accel()
        integ = DirectIntegrator(1, 1)
        params = params_from_numpy(sc.params(), cuda)
        targets = [torch.zeros(32 * 32, 3, device=cuda)] * sc.num_sensors
        occ = sc.meshes[fr.OCCLUDER]
        smooth = fr.laplacian_smoother(occ.faces, occ.num_vertices, cuda)
        opt = adam(1e-2)

        def make():
            step = fr.make_train_step(sc, fr.make_loss(sc, integ, targets),
                                      smooth, opt)
            return step, (params, opt.init(params), key)
    else:
        sc = cbox_scene(32, 32, spp=2, occluder_subdiv=3, device=cuda)
        mesh = (LocalRank if case.endswith("whole") else LocalSplitRank)(
            None, 0, 1, cuda)

        def make():
            step, state = make_train_step(
                DirectIntegrator(1, 1), sc, mesh,
                np.zeros((32 * 32, 3), np.float32), optimizer=sgd(1.0),
                with_boundary=False)
            return step, (params_from_numpy(sc.params(), cuda), state, key)
    step, args = make()
    progs = getattr(step, "programs", (step,))
    step(*args)
    assert [p.captures for p in progs] == [1] * len(progs)
    assert sc.maybe_rebuild_accel(threshold=sc.refit_quality() - 0.01)
    got = step(*args)
    assert [p.captures for p in progs] == [2] + [1] * (len(progs) - 1)
    _close_trees(got, make()[0](*args))


def test_capture_survives_programs_freed_by_the_collector(cuda):
    """Programs caught in reference cycles (as an integrator and its
    program cache are) are freed by Python's cyclic collector; a capture
    that allocates enough to trigger a collection still succeeds (the
    collector runs before a capture, not during it: a graph freed while a
    stream captures invalidates the capture)."""
    from psdr_tpu_torch.program import Program
    x = torch.ones(8, device=cuda)
    for _ in range(4):
        holder = {}
        holder["p"] = Program(lambda v: v * 2.0 + len(holder), "cyclic")
        holder["p"](x)
        assert holder["p"].captured
        del holder

    def body(v):
        junk = [[i] for i in range(20000)]     # past gc's thresholds
        return v * 3.0 + len(junk) * 0.0

    prog = Program(body, "allocates")
    assert torch.equal(prog(x), x * 3.0) and prog.captured


def test_grad_capture_of_a_host_read_in_backward_fails_loudly(cuda):
    """A gradient body whose custom Function reads the host in its
    backward cannot be captured: the call raises, later calls raise
    without running it, and the card stays usable."""
    from psdr_tpu_torch.program import Program, value_and_grad

    class Reads(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x * 2.0

        @staticmethod
        def backward(ctx, g):
            return g * (2.0 if g.sum().item() != 0.0 else 0.0)

    prog = Program(value_and_grad(lambda x: Reads.apply(x).sum()),
                   "reads in backward", grad=True)
    x = torch.ones(4, device=cuda)
    with pytest.raises(RuntimeError, match="capture"):
        prog(x)
    with pytest.raises(RuntimeError, match="capture failed"):
        prog(x)
    assert not prog.captured and float((x * 2).sum()) == 8.0


# -- the scene queries ------------------------------------------------------------

def _bench_flat(cuda):
    from psdr_tpu_torch.scene.scene import detach_flat
    sc = cbox_scene(512, 512, spp=64, occluder_subdiv=5, device=cuda)
    sc.prepare_accel()
    return sc, detach_flat(sc.build(sc.params()))


def test_sorted_k1_equals_unsorted_at_2_21_lanes(cuda):
    """``_closest_hit(sort_rays=True)`` on the bench scene (20,492
    triangles, K1: "auto" on the card) at 2^21 lanes, the PathTracer's
    depth-2 bounce (closest) and shadow (any) sweeps: every field equal
    to K1 on the unsorted rays bit for bit, one K1 launch a query."""
    from psdr_tpu_torch.scene.scene import _closest_hit
    from psdr_tpu_torch.testing.scenes import tiled_path_rays
    sc, flat = _bench_flat(cuda)
    assert flat.accel_kind == "pallas"
    sweeps = tiled_path_rays(sc, flat, 1 << 21, 64, 2, depth=2)
    for name, any_hit in (("depth 2 bounce", False), ("depth 2 shadow", True)):
        ray, act, tmax = sweeps[name]
        inf = torch.full_like(ray.o[:, 0], float("inf"))
        plain = intersect.k1_cuda(flat.accel, ray.o.contiguous(),
                                  ray.d.contiguous(), act,
                                  inf if tmax is None else tmax.contiguous(),
                                  any_hit=any_hit)
        before = dict(intersect.LAUNCHES)
        got = _closest_hit(flat, ray, act, tmax=tmax, sort_rays=True,
                           any_hit=any_hit)
        mode = "any" if any_hit else "closest"
        assert intersect.LAUNCHES[mode] == before[mode] + 1
        assert got.valid.any()
        _assert_exact(plain, got)


@pytest.mark.parametrize("frac_shift,share", [(3, 0.01), (3, 0.5),
                                              (2, 0.2)])
def test_compacted_sweep_equals_dense(cuda, frac_shift, share):
    """``_ray_test_sparse`` at 2^21 lanes of the bench scene's shadow
    rays (the 2^21-lane chunk of rows 384 to 447, the floor under the
    occluder) with a share of them active (1%: every segment fits its
    cap; half: they overflow an eighth; a fifth under a quarter cap)
    equals the dense any-hit sweep lane for lane, in two K1 launches."""
    from psdr_tpu_torch.scene.scene import _closest_hit, _ray_test_sparse
    from psdr_tpu_torch.testing.scenes import tiled_camera_rays
    sc, flat = _bench_flat(cuda)
    _, _, (ray, alive, tmax) = tiled_camera_rays(sc, flat, 1 << 21, 64, 3,
                                                 chunk=6)
    pick = torch.as_tensor(np.random.default_rng(5).uniform(size=1 << 21)
                           < share, device=cuda)
    act = alive & pick
    dense = _closest_hit(flat, ray, act, tmax=tmax, any_hit=True,
                         test_only=True) & act
    before = intersect.LAUNCHES["any"]
    got = _ray_test_sparse(flat, ray, tmax, act, frac_shift=frac_shift)
    assert intersect.LAUNCHES["any"] == before + 2
    assert dense.any() and torch.equal(got & act, dense)
    over = (act.reshape(-1, 1 << 15).sum(1) > (1 << 15) >> frac_shift).any()
    assert bool(over) == (share == 0.5)


def test_culled_mode_runs_k3_and_equals_k1(cuda):
    """``accel_mode="culled"`` renders through K3 (and "auto" through K1,
    no K3), and the two images agree as card and CPU renders must
    (chip_smoke.py phase 4: at least 99% of pixels within rtol 1e-4, atol
    1e-5, means to 1e-4; the pixel sums are atomic): 64x64 spp 4, 1,292
    triangles."""
    imgs = {}
    for mode in ("culled", "auto"):
        sc = cbox_scene(64, 64, spp=4, occluder_subdiv=3, device=cuda)
        sc.accel_mode = mode
        intersect.reset_launch_counts()
        imgs[mode] = DirectIntegrator(1, 1).renderC(sc, seed=7)
        torch.cuda.synchronize()
        k1 = intersect.LAUNCHES["closest"] + intersect.LAUNCHES["any"]
        assert (intersect.LAUNCHES["k3"] > 0) == (mode == "culled")
        assert (k1 > 0) == (mode == "auto")
    a, b = (imgs[m].reshape(-1, 3) for m in ("culled", "auto"))
    close = torch.isclose(a, b, rtol=1e-4, atol=1e-5).all(dim=1)
    assert float(close.float().mean()) >= 0.99
    assert abs(float(a.mean() - b.mean())) < 1e-4 * float(b.mean())


def test_program_replays_after_its_envmap_table_left_the_cache(cuda):
    """``render_program`` on a sky above 2^15 cells (a 398 x 198 frozen
    table), then 9 new radiance snapshots built (the host cache drops the
    table), the allocator's free memory released and refilled with NaN:
    the replay stays within 8 times the replays' own spread (atomic sums)
    of the capture-time replay."""
    import gc
    sky = np.random.default_rng(4).uniform(0.1, 1.0, (100, 200, 3)).astype(
        np.float32)
    sc = env_scene(None, 32, 32, spp=4, sky=sky, device=cuda)
    params = params_from_numpy(sc.params(), cuda)
    prog = DirectIntegrator(1, 1).render_program(sc, with_boundary=False,
                                                 detached=True)
    key = threefry.PRNGKey(5, device=cuda)
    first = prog(params, key)
    spread = float((prog(params, key) - first).abs().max())
    rad = sc.emitters[0].radiance.data
    for k in range(9):
        p = sc.params()
        p["emitters"][0] = dict(p["emitters"][0],
                                radiance=rad * np.float32(1 + (k + 1) / 64))
        sc.set_params(p)
        sc.configure()
    sc._flat_cache = None
    gc.collect()
    torch.cuda.empty_cache()
    junk = []
    for _ in range(64):          # the warm-up allocated on a pooled stream
        with torch.cuda.stream(torch.cuda.Stream(cuda)):
            junk += [torch.full((398 * 198,), float("nan"), device=cuda)
                     for _ in range(8)]
    torch.cuda.synchronize()
    late = prog(params, key)
    assert torch.isfinite(late).all()
    assert float((late - first).abs().max()) <= 8.0 * spread
    del junk


# -- reproducibility: the fixed-order sums ---------------------------------------

@pytest.mark.parametrize("shape", ["hot", "cold", "pixels", "one row",
                                   "x1", "x9", "x33"])
def test_segsum_kernel_equals_its_plain_version(cuda, shape):
    """``csrc/segsum.cu`` against ``segsum_plain`` on the same CUDA
    tensors, bit for bit, and run twice, equal: 2^20 lanes onto two hot
    rows and 20,490 cold ones (32 columns), lanes spread evenly, 131,072
    pixel lanes of 3 channels with dropped lanes, every lane on one row,
    and the narrow and wide widths: 1 column in cell order without
    ``order`` (the guiding masses), 9 columns (two spans a warp) and 33
    (a second channel group)."""
    from psdr_tpu_torch.core import segsum
    rng = np.random.default_rng(7)
    n = 1 << 20
    idx, rows, c = {
        "hot": (rng.permutation(np.concatenate([
            np.zeros(n // 2), np.ones(n // 4),
            rng.integers(2, 20492, n - n // 2 - n // 4)])), 20492, 32),
        "cold": (rng.integers(0, 20492, n), 20492, 32),
        "pixels": (rng.integers(-1, 65536, 131072), 65536, 3),
        "one row": (np.full(n, 3), 20492, 32),
        "x1": (np.arange(n) // 4, n // 4 + 1, 1),
        "x9": (rng.integers(-1, 5000, n), 5000, 9),
        "x33": (rng.integers(-1, 20492, n), 20492, 33)}[shape]
    idx = torch.as_tensor(idx.astype(np.int64), device=cuda)
    values = torch.as_tensor(rng.normal(size=(idx.numel(), c)).astype(
        np.float32), device=cuda)
    keys, order = segsum.sort_keys(idx, rows)
    if shape == "x1":
        keys, order = idx.to(torch.int32), None
    before = intersect.LAUNCHES["segsum"]
    got = segsum.segsum_cuda(keys, values, rows, order)
    assert intersect.LAUNCHES["segsum"] > before
    assert torch.equal(got, segsum.segsum_cuda(keys, values, rows, order))
    assert torch.equal(got, segsum.segsum_plain(keys, values, rows, order))


def test_prefix_sum_repeats_itself_on_the_card(cuda):
    """``prefix_sum`` of 300,000 floats run 200 times gives one result (a
    1-D ``torch.cumsum`` there gives many: CUB's look-back scan)."""
    from psdr_tpu_torch.core import segsum
    x = torch.rand(300000, device=cuda)
    first = segsum.prefix_sum(x)
    assert all(torch.equal(segsum.prefix_sum(x), first) for _ in range(200))
    assert float((first.double() - torch.cumsum(x.double(), 0)).abs().max()
                 ) <= 1e-6 * float(first[-1])


def test_backward_step_and_guiding_build_repeat_bit_for_bit(cuda):
    """Two eager runs of ``grad_program``'s body with every boundary term
    (64x64, spp 4, sppe 2, sppse 16) give equal losses and gradients bit
    for bit, and two guiding builds at one seed equal masses."""
    from torch.utils._pytree import tree_flatten
    sc = cbox_scene(64, 64, spp=4, sppe=2, sppse=16, occluder_subdiv=3,
                    device=cuda)
    integ = DirectIntegrator(1, 1)
    prog = integ.grad_program(sc, torch.zeros(64 * 64, 3, device=cuda),
                              with_boundary=True)
    p = params_from_numpy(sc.params(), device=cuda)
    with torch.enable_grad():
        a, b = (tree_flatten(prog.fn(p, threefry.PRNGKey(3)))[0]
                for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    masses = []
    for _ in range(2):
        integ.preprocess_secondary_edges(sc, 0, (8, 3, 3, 4), nrounds=2,
                                         seed=3)
        masses.append(integ.warpper[0].distrb.pmf.clone())
    assert torch.equal(*masses) and float(masses[0].sum()) > 0


def test_five_trainer_steps_repeat_bit_for_bit(cuda):
    """Five ``Optimizer.step``s on the occluder's vertices through every
    boundary term (32x32, spp 4, sppe 2, sppse 16), twice from the same
    start: equal losses and vertices bit for bit."""
    from psdr_tpu_torch.opt import Optimizer
    from psdr_tpu_torch.testing.scenes import flagship_deform
    runs = []
    for _ in range(2):
        sc = cbox_scene(32, 32, spp=4, sppe=2, sppse=16, occluder_subdiv=3,
                        device=cuda)
        integ = DirectIntegrator(1, 1)
        with torch.no_grad():
            target = integ.render_fn(sc, with_boundary=False, detached=True)(
                params_from_numpy(sc.params(), cuda), threefry.PRNGKey(9))
        sc.meshes[5].vertex_positions = flagship_deform(
            np.asarray(sc.meshes[5].vertex_positions))
        opt = Optimizer(sc, ["Mesh[5].vertex_positions"], lr=1e-2)
        render = integ.render_fn(sc, with_boundary=True)
        losses = [opt.step(lambda q, k: torch.mean((render(q, k) - target)
                                                   ** 2), threefry.PRNGKey(s))
                  for s in range(5)]
        runs.append((losses, opt.params["meshes"][5]["vertex_positions"]
                     .clone()))
    assert runs[0][0] == runs[1][0]
    assert torch.equal(runs[0][1], runs[1][1])


def test_reference_scale_guiding_table_repeats_and_replays(cuda):
    """The secondary-edge guiding table at the reference's scale, 40000 x 5
    x 5 cells x 2 samples over 16 rounds (2,000,000 lanes a round) on the
    256x256 bench scene: a second build at the same seed equals the first
    bit for bit (pmf and cmf), the build's replay equals its body run
    eagerly, the masses are finite and non-negative with some positive, and
    the cmf is non-decreasing and ends at the total."""
    from psdr_tpu_torch.integrator.direct import guiding_programs
    sc = cbox_scene(256, 256, spp=16, sppe=8, sppse=64, occluder_subdiv=5,
                    device=cuda)
    integ = DirectIntegrator(1, 1)
    tables = []
    for _ in range(2):
        integ.preprocess_secondary_edges(sc, 0, (40000, 5, 5, 2),
                                         nrounds=16, seed=5)
        tables.append(integ.warpper[0].distrb)
    assert torch.equal(tables[0].pmf, tables[1].pmf)
    assert torch.equal(tables[0].cmf, tables[1].cmf)
    (prog,) = guiding_programs(integ).values()
    with torch.no_grad():
        eager = prog.fn(threefry.PRNGKey(5))
    assert torch.equal(prog(threefry.PRNGKey(5, device=cuda)), eager)
    pmf, cmf = tables[0].pmf, tables[0].cmf
    assert pmf.shape == (1000000,) and bool(torch.isfinite(pmf).all())
    assert not bool((pmf < 0).any()) and bool((pmf > 0).any())
    assert not bool((cmf[1:] < cmf[:-1]).any())
    total = float(pmf.double().sum())
    assert abs(float(cmf[-1]) - total) <= 1e-5 * total


def test_remat_equals_plain_at_2_22_lanes(cuda):
    """``PathTracer(3)``'s gradient on ``env_bench_scene`` at 512x512, spp
    16 (2^22 lanes in two pass chunks): ``remat_passes=True`` (each chunk
    checkpointed, its forward run again in the backward) gives the loss and
    every leaf of ``remat_passes=False`` bit for bit."""
    import dataclasses
    from torch.utils._pytree import tree_flatten
    out = []
    for remat in (True, False):
        sc = env_bench_scene(512, 512, 16, device=cuda)
        sc.opts = dataclasses.replace(sc.opts, remat_passes=remat)
        prog = PathTracer(3).grad_program(
            sc, torch.zeros(512 * 512, 3, device=cuda), with_boundary=False)
        p = params_from_numpy(sc.params(), device=cuda)
        with torch.enable_grad():
            out.append(tree_flatten(prog.fn(p, threefry.PRNGKey(3)))[0])
        del prog
        torch.cuda.empty_cache()
    assert all(bool(torch.isfinite(x).all()) for x in out[0])
    assert all(torch.equal(x, y) for x, y in zip(*out))


def test_camera_depth_3_boundary_grad_on_card_matches_cpu(cuda):
    """``PathTracer(3, camera_depth=3)`` with every boundary term (64x64,
    spp 4, sppe 2, sppse 4), a configuration first run on the card with
    ``chip_smoke.py`` phase 34: the loss within 1e-5 relative, every leaf
    finite and within 1e-2 relative L2 and cosine 0.999 of the CPU's; K1
    in both modes and K2 launched."""
    integ = PathTracer(3, camera_depth=3)
    intersect.reset_launch_counts()
    card_loss, card = _grads(cuda, integ=integ, sppe=2, sppse=4)
    assert all(intersect.LAUNCHES[k] > 0 for k in ("closest", "any", "k2"))
    cpu_loss, cpu = _grads(torch.device("cpu"), integ=integ, sppe=2, sppse=4)
    assert abs(card_loss - cpu_loss) <= 1e-5 * cpu_loss
    _assert_leaves_close(cpu, card)


_LAYERS = ("render", "camera", "rng", "intersect", "bsdf", "emitter",
           "film")


def _cbox_program(cuda, size=256, spp=8):
    sc = cbox_scene(size, size, spp=spp, occluder_subdiv=3, device=cuda)
    p = params_from_numpy(sc.params(), device=cuda)
    prog = DirectIntegrator(2, 2).render_program(sc)
    return sc, prog, p, threefry.PRNGKey(7, device=cuda)


def test_profile_layers_accounts_for_the_replay(cuda):
    """``profile_layers`` on a small cbox (256x256, spp 8,
    ``DirectIntegrator(2, 2)``): every layer reads a time; their self
    times add up to the twin's replay within 1%; their nodes to the
    program's graph; the twin replays within 3% of the program's graph;
    and the program's graph and output are as they were."""
    _, prog, p, key = _cbox_program(cuda)
    want = prog(p, key)
    nodes = prog.nodes
    res = prog.profile_layers(p, key, replays=20)
    assert prog.nodes == res["nodes"] == nodes
    assert set(_LAYERS) <= set(res["layers_ms"])
    assert all(v >= 0 for v in res["layers_ms"].values())
    assert all(res["layers_ms"][k] > 0 for k in _LAYERS)
    assert sum(res["layer_nodes"].values()) == nodes
    assert abs(res["sum_ms"] - res["twin_ms"]) <= 0.01 * res["twin_ms"]
    assert abs(res["twin_ms"] - res["plain_ms"]) <= 0.03 * res["plain_ms"]
    assert res["call_ms"] > 0 and res["events"] > len(_LAYERS)
    assert torch.equal(prog(p, key), want)


def test_program_output_is_bit_equal_under_a_profiler(cuda):
    """A replay under ``torch.profiler`` (the spans then open
    ``record_function``s) equals one without, and a program captured
    under the profiler has the same graph, node for node, and output."""
    from torch.profiler import ProfilerActivity, profile
    _, prog, p, key = _cbox_program(cuda, size=64, spp=4)
    want = prog(p, key)
    _, prog2, p2, _ = _cbox_program(cuda, size=64, spp=4)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        got = prog(p, key)
        got2 = prog2(p2, key)
        torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got2, want)
    assert prog2.nodes == prog.nodes


def test_counters_per_replay_equal_the_eager_counts(cuda):
    """The launch counters and ``k1.rays`` a replay adds equal what the
    eager body counts; a capture counts one first capture, each call one
    replay."""
    from psdr_tpu_torch import profiling
    sc, prog, p, key = _cbox_program(cuda, size=64, spp=4)
    keys = ("launches.closest", "launches.any", "launches.k2",
            "launches.segsum", "launches.rng", "k1.rays")
    with torch.no_grad():
        prog.fn(p, key)                  # fills the caches
        c0 = profiling.counters()
        prog.fn(p, key)
        c1 = profiling.counters()
    eager = {k: c1.get(k, 0) - c0.get(k, 0) for k in keys}
    assert eager["launches.closest"] > 0 and eager["k1.rays"] > 0
    assert eager["launches.rng"] > 0
    prog(p, key)
    c2 = profiling.counters()
    prog(p, key)
    prog(p, key)
    c3 = profiling.counters()
    assert {k: c3.get(k, 0) - c2.get(k, 0) for k in keys} == {
        k: 2 * v for k, v in eager.items()}
    assert c3["program.replays"] - c2["program.replays"] == 2
    assert c2.get("program.captures.first", 0) >= 1
    assert dict(intersect.LAUNCHES)["closest"] == c3["launches.closest"]


# -- the random stream (csrc/rng.cu) -------------------------------------------

_RNG_SIZES = [1, 7, 2**16 + 3, 3 << 21]


def _bit_equal(got, want):
    assert got.is_cuda and got.dtype == want.dtype
    assert tuple(got.shape) == tuple(want.shape)
    got, want = got.cpu(), want.cpu()
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    assert torch.equal(got, want)


def _rng_keys(cuda):
    """(key the kernel reads, the same key on the CPU, output device):
    a key on the card (its words read from device memory), a host key
    drawing onto the card (words as arguments), and a row of a split
    block on the card (a view into a two-column key table)."""
    host = threefry.fold_in(threefry.PRNGKey(12345), 11)
    card = host.to(cuda)
    return ((card, host, None), (host, host, cuda),
            (threefry.split(card, 4)[2], threefry.split(host, 4)[2], None))


@pytest.mark.parametrize("n", _RNG_SIZES)
def test_threefry_kernels_equal_the_tensor_code(cuda, n):
    """``uniform``, ``random_bits``, ``split`` and ``fold_in`` on the card
    (``psdr_threefry``) bit for bit against the tensor code on the CPU on
    the same keys, in both key modes and on a row of a split block; one
    launch each."""
    want = functools.lru_cache(lambda draw, kh: draw(kh, (n,)))
    keys = _rng_keys(cuda)
    before = intersect.RNG_LAUNCHES["rng"]
    launches = 0
    for kc, kh, dev in keys:
        for draw in (threefry.uniform, threefry.random_bits):
            _bit_equal(draw(kc, (n,), dev), want(draw, kh))
            launches += 1
        if dev is None:
            with threefry.tensor_words():    # host words split in Python
                _bit_equal(threefry.split(kc, n), threefry.split(kh, n))
            for data in (0, 7, n, 2**32 - 1):
                _bit_equal(threefry.fold_in(kc, data),
                           threefry.fold_in(kh, data))
            launches += 5
    assert intersect.RNG_LAUNCHES["rng"] - before == launches


@pytest.mark.parametrize("n", _RNG_SIZES)
def test_randint_kernel_equals_the_tensor_code(cuda, n):
    """``randint`` on the card (``psdr_randint``: the key split, both draws
    and the modular reduction in one launch) against the tensor code, in
    both key modes and on a row of a split block."""
    bounds = ([(0, 2**31 - 1), (-5, 1000), (3, 4), (-2**31, 2**31 - 1),
               (9, 2)] if n < 2**16 else [(0, 2**31 - 1)])
    want = functools.lru_cache(
        lambda kh, lo, hi: threefry.randint(kh, (n,), lo, hi))
    keys = _rng_keys(cuda)
    before = intersect.RNG_LAUNCHES["rng"]
    for kc, kh, dev in keys:
        for lo, hi in bounds:
            _bit_equal(threefry.randint(kc, (n,), lo, hi, dev),
                       want(kh, lo, hi))
    assert intersect.RNG_LAUNCHES["rng"] - before == len(keys) * len(bounds)


def test_ld2d_kernel_equals_the_tensor_code(cuda):
    """The scrambled (0,2)-points on the card (``psdr_ld2d``) against the
    tensor code: sample indices up to 2^32 - 1, words on the card and on
    the host, and points whose coordinate rounds to 1.0."""
    from psdr_tpu_torch.core import sampler
    rng = np.random.default_rng(5)
    n = 2**16 + 3
    idx = np.concatenate([np.arange(n // 2),
                          rng.integers(2**32 - 2**20, 2**32, n - n // 2)])
    idx = torch.from_numpy(idx.astype(np.int64))
    pix = torch.from_numpy(rng.integers(0, 1 << 22, n))
    words = threefry.randint(threefry.PRNGKey(3), (6,), 0, 2**31 - 1)
    # the first 256 lanes: bitrev(i) ^ h(p, w0) = 2^32 - 1 - j, so x
    # rounds to 1.0 for j < 128
    h = sampler._pix_hash(pix[:256], words[0])
    x = (2**32 - 1 - torch.arange(256)) ^ h
    idx[:256] = torch.tensor([int(f"{v:032b}"[::-1], 2) for v in x.tolist()])
    for w in (words, words.to(cuda)):
        for k in range(5):
            want = sampler.ld_2d_scrambled(idx, pix, words, k)
            got = sampler.ld_2d_scrambled(idx.to(cuda), pix.to(cuda), w, k)
            _bit_equal(got, want)
            if k == 0:
                assert int((got[:256, 0] == 1.0).sum()) == 128


def test_rng_launches_count_an_eager_program_body(cuda, monkeypatch):
    """``launches.rng`` counts each launch of the random stream's kernels
    in one eager ``render_program`` body, and the tensor code of the
    layer (the Threefry rounds, the (0,2)-sequence's bit loops, the pixel
    hash) runs nothing there."""
    from psdr_tpu_torch.core import sampler
    _, prog, p, key = _cbox_program(cuda, size=64, spp=4)
    launched = []
    launch = intersect._launch

    def spy(kernel, fn, *args, dev):
        if kernel in ("threefry", "randint", "ld2d"):
            launched.append(kernel)
        return launch(kernel, fn, *args, dev=dev)

    def refuse(*args, **kwargs):
        raise AssertionError("the random stream's tensor code ran on the "
                             "card")

    monkeypatch.setattr(intersect, "_launch", spy)
    monkeypatch.setattr(threefry, "_tensor_rotl", refuse)
    for name in ("_lp32", "_bit_reverse32", "_pix_hash"):
        monkeypatch.setattr(sampler, name, refuse)
    before = intersect.RNG_LAUNCHES["rng"]
    with torch.no_grad():
        prog.fn(p, key)
    torch.cuda.synchronize()
    assert intersect.RNG_LAUNCHES["rng"] - before == len(launched) > 0
    assert {"threefry", "randint", "ld2d"} <= set(launched)
