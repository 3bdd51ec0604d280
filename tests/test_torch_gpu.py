"""K1's CUDA kernel on the card: against its plain version on the same
CUDA tensors, and a small render on the card against the same render on
the CPU. Needs a CUDA device and nvcc; skips elsewhere. Imports no jax, so
it runs on a machine without it:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from psdr_tpu_torch import DirectIntegrator
from psdr_tpu_torch.accel import bvh as t_bvh
from psdr_tpu_torch.accel import intersect
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
