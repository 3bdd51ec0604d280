"""The port's ``FieldExtractionIntegrator`` against the JAX package's on the
CPU: the six AOVs (silhouette, position, depth, geoNormal, shNormal, uv)
per pixel on the cbox (walls with uv, a smooth-shaded sphere, 1,292
triangles: the BVH path), on ``env_scene`` (every camera ray ends on the
environment map's bounding mesh at the latest) and through the camera-hit
prior. Both packages draw the same jitter and find the same triangles, so
the silhouette is equal exactly and the others to float rounding (XLA fuses
the ray-triangle arithmetic differently): every pixel within rtol 1e-5,
atol 1e-5 (measured: at most 1.9e-6 absolute).
"""
import dataclasses

import numpy as np
import jax
import pytest
import torch

import psdr_tpu as J
import psdr_tpu_torch as T
from psdr_tpu_torch.convert import params_from_numpy
from psdr_tpu_torch.core import threefry
from psdr_tpu_torch.testing import scenes as t_scenes

from scenes import cbox_scene as j_cbox
from test_envmap import _env_scene as j_env_scene

torch.set_num_threads(2)

CPU = dict(device="cpu")     # the port defaults to the card
FIELDS = ("silhouette", "position", "depth", "geoNormal", "shNormal", "uv")


def _scenes(which):
    if which == "env":
        return (j_env_scene(J.Diffuse([0.7, 0.7, 0.7]), 24, 24, 2),
                t_scenes.env_scene(width=24, height=24, spp=2, **CPU))
    kw = dict(width=24, height=24, spp=2, occluder_subdiv=3)
    return j_cbox(**kw), t_scenes.cbox_scene(**kw, **CPU)


def _render_fn(lib, sc, field):
    return lib.FieldExtractionIntegrator(field).render_fn(
        sc, with_boundary=False, detached=True)


@pytest.mark.parametrize("which", ["cbox", "env"])
@pytest.mark.parametrize("field", FIELDS)
def test_field_matches_jax(field, which):
    js, ts = _scenes(which)
    want = np.asarray(jax.jit(_render_fn(J, js, field))(
        js.params(), jax.random.PRNGKey(1)))
    got = _render_fn(T, ts, field)(params_from_numpy(js.params(), **CPU),
                                   threefry.PRNGKey(1)).numpy()
    assert got.shape == want.shape == (24 * 24, 3)
    assert np.isfinite(got).all()
    if field == "silhouette":
        np.testing.assert_array_equal(got, want)
        assert (got == 1.0).all()      # a closed box, a closing sky
        return
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.abs(got).sum() > 0 or (field == "uv" and which == "env")


def test_field_under_the_camera_hit_prior_and_unknown_field():
    """The prior bounds the camera query and changes no AOV; an unknown
    field is refused at construction."""
    _, ts = _scenes("cbox")
    ts.opts = dataclasses.replace(ts.opts, spp=4)
    plain = T.FieldExtractionIntegrator("depth").renderC(ts, seed=2)
    ts.opts = dataclasses.replace(ts.opts, camera_hit_prior=True)
    prior = T.FieldExtractionIntegrator("depth").renderC(ts, seed=2)
    np.testing.assert_allclose(prior.numpy(), plain.numpy(), rtol=1e-6)
    with pytest.raises(ValueError, match="Unsupported field"):
        T.FieldExtractionIntegrator("albedo")


def test_field_position_gradient_reaches_the_mesh_transform():
    """The AOVs are differentiable where the hit recompute is: the mean
    depth moves with a translation of the sphere along the view axis."""
    _, ts = _scenes("cbox")
    p = params_from_numpy(ts.params(), **CPU, requires_grad=True)
    img = T.FieldExtractionIntegrator("depth").render_fn(
        ts, with_boundary=False)(p, threefry.PRNGKey(0))
    img.mean().backward()
    g = p["meshes"][5]["to_world"].grad
    assert torch.isfinite(g).all() and g[2, 3] < 0.0
