"""The port's forward render against the JAX package's, end to end:
DirectIntegrator(1, 1) renderC semantics (render_fn with_boundary=False,
detached=True) on cbox_scene(32, 32, spp=4, occluder_subdiv=3), 1,292
triangles, so the BVH and K1 run (the plain version, on the CPU). Both
packages get the same parameters (params_from_numpy) and PRNGKey(seed);
their uniforms are bit-equal, so lanes agree to float rounding. XLA-CPU
and torch-CPU round a few ops differently (fused Moller-Trumbore, sin/cos,
matmul order), so a handful of lanes may cross a discrete test (a triangle
edge, the side gate, a penumbra class): at least 99% of pixels must be
allclose (rtol 1e-4, atol 1e-5) and the image means must agree to 1e-4."""
import numpy as np
import jax
import pytest
import torch

from psdr_tpu import DirectIntegrator as JDirect
from psdr_tpu_torch import DirectIntegrator as TDirect
from psdr_tpu_torch.convert import params_from_numpy
from psdr_tpu_torch.core import threefry
from psdr_tpu_torch.testing.scenes import cbox_scene as t_cbox

from scenes import cbox_scene as j_cbox

torch.set_num_threads(2)

SCENE = dict(width=32, height=32, spp=4, occluder_subdiv=3)


def _renders(seed):
    js = j_cbox(**SCENE)
    j_img = np.asarray(jax.jit(JDirect(1, 1).render_fn(
        js, with_boundary=False, detached=True))(
            js.params(), jax.random.PRNGKey(seed)))
    ts = t_cbox(**SCENE)
    t_img = TDirect(1, 1).render_fn(ts, with_boundary=False, detached=True)(
        params_from_numpy(js.params()), threefry.PRNGKey(seed)).numpy()
    return j_img, t_img


@pytest.mark.parametrize("reuse,q", [("off", None), ("edge", None),
                                     ("bern", "0.25")])
def test_render_matches_jax(reuse, q, monkeypatch):
    monkeypatch.setenv("PSDR_TPU_VIS_REUSE", reuse)
    if q is None:
        monkeypatch.delenv("PSDR_TPU_VIS_REUSE_Q", raising=False)
    else:
        monkeypatch.setenv("PSDR_TPU_VIS_REUSE_Q", q)
    j_img, t_img = _renders(seed=3)
    assert t_img.shape == j_img.shape == (SCENE["width"] * SCENE["height"], 3)
    assert np.isfinite(t_img).all() and t_img.mean() > 0.0
    close = np.isclose(t_img, j_img, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(t_img.mean() - j_img.mean()) / j_img.mean() < 1e-4


def test_scene_build_matches_jax():
    """The flat scene: face table (F, 32), emitter faces, emitter tables."""
    js, ts = j_cbox(**SCENE), t_cbox(**SCENE)
    jf = js.build(js.params())
    tf = ts.build(params_from_numpy(js.params()))
    np.testing.assert_allclose(np.asarray(jf.face_table),
                               tf.face_table.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(jf.em_tri_idx),
                                  tf.em_tri_idx.numpy())
    for f in ("emitter_radiance", "emitter_weight", "emitter_inv_area"):
        np.testing.assert_allclose(np.asarray(getattr(jf, f)),
                                   getattr(tf, f).numpy(), rtol=1e-6)
    assert ts.face_offset == js.face_offset


def test_unported_options_raise():
    """What slice 1 leaves out raises instead of doing something else."""
    ts = t_cbox(width=8, height=8, spp=1, occluder_subdiv=1)
    with pytest.raises(NotImplementedError, match="slice 2"):
        TDirect(1, 1).render_fn(ts, detached=False)
    with pytest.raises(NotImplementedError, match="slice 2"):
        TDirect(1, 1).renderD(ts)
    ts.opts = ts.opts.__class__(width=8, height=8, spp=1, sppe=1)
    with pytest.raises(NotImplementedError, match="slice 2"):
        ts.build(ts.params())
