"""The CUDA kernels on the card: K1, K2 and K3 against their plain
versions on the same CUDA tensors, and a small render and a small gradient
on the card against the same on the CPU. Needs a CUDA device and nvcc;
skips elsewhere. Imports no jax, so it runs on a machine without it:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from psdr_tpu_torch import DirectIntegrator
from psdr_tpu_torch.accel import bvh as t_bvh
from psdr_tpu_torch.accel import intersect
from psdr_tpu_torch.accel.bruteforce import brute_plain
from psdr_tpu_torch.convert import params_from_numpy
from psdr_tpu_torch.core import threefry
from psdr_tpu_torch.testing.scenes import cbox_scene, triangle_soup

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("any_hit", [False, True])
def test_cuda_kernel_matches_plain(cuda, any_hit):
    """valid exactly equal; closest hit: tri_id equal except at t-ties and
    t allclose (rtol 1e-5), as tests/test_bvh.py:43-50."""
    p0, e1, e2, o, d, act, tmax = triangle_soup()
    topo = t_bvh.build_bvh_topology(p0, e1, e2, leaf_size=4)
    bvh = t_bvh.refit_bvh(topo, *(torch.from_numpy(x).to(cuda)
                                  for x in (p0, e1, e2)))
    args = (bvh, *(torch.from_numpy(x).to(cuda) for x in (o, d, act, tmax)))
    plain = intersect.k1_plain(*args)
    before = dict(intersect.LAUNCHES)
    hit = intersect.k1_cuda(*args, any_hit=any_hit)
    torch.cuda.synchronize()
    mode = "any" if any_hit else "closest"
    assert intersect.LAUNCHES[mode] == before[mode] + 1
    np.testing.assert_array_equal(plain.valid.cpu().numpy(),
                                  hit.valid.cpu().numpy())
    assert not hit.valid.cpu().numpy()[~act].any()
    if not any_hit:
        tp, tk = plain.t.cpu().numpy(), hit.t.cpu().numpy()
        same = plain.tri_id.cpu().numpy() == hit.tri_id.cpu().numpy()
        assert np.all(same | np.isclose(tp, tk, rtol=1e-5))
        np.testing.assert_allclose(tp, tk, rtol=1e-5)


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


def _assert_exact(plain, hit):
    for f in ("valid", "tri_id", "t", "uv"):
        np.testing.assert_array_equal(getattr(plain, f).cpu().numpy(),
                                      getattr(hit, f).cpu().numpy(), f)


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


def test_k3_matches_plain_exactly(cuda):
    """K3 against k1_plain (its plain version) on the 2048-triangle soup:
    equal bit for bit."""
    p0, e1, e2, o, d, act, tmax = triangle_soup()
    topo = t_bvh.build_bvh_topology(p0, e1, e2, leaf_size=4)
    bvh = t_bvh.refit_bvh(topo, *(torch.from_numpy(x).to(cuda)
                                  for x in (p0, e1, e2)))
    args = (bvh, *(torch.from_numpy(x).to(cuda) for x in (o, d, act, tmax)))
    before = intersect.LAUNCHES["k3"]
    hit = intersect.ray_intersect_k3(*args)
    torch.cuda.synchronize()
    assert intersect.LAUNCHES["k3"] == before + 1
    _assert_exact(intersect.k1_plain(*args), hit)


def _grads(device, seed=3):
    sc = cbox_scene(64, 64, spp=4, occluder_subdiv=3, device=device)
    p = params_from_numpy(sc.params(), device=device, requires_grad=True)
    img = DirectIntegrator(1, 1).render_fn(sc, with_boundary=False)(
        p, threefry.PRNGKey(seed))
    loss = torch.mean(img ** 2)
    loss.backward()
    leaves = [x for m in p["meshes"] for x in m.values()] + [
        x for k in ("bsdfs", "emitters", "sensors") for m in p[k]
        for x in m.values()]
    return float(loss), [x.grad.cpu().numpy().ravel() for x in leaves]


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
    for a, g in zip(cpu, card):
        assert np.isfinite(g).all()
        na = np.linalg.norm(a)
        assert np.linalg.norm(g - a) <= 1e-2 * na
        if na > 0:
            assert float(g @ a) / (np.linalg.norm(g) * na) >= 0.999
