"""The port's AD-vs-FD harness against the JAX package's on the CPU:
``run_orig`` per pixel, ``run_ad`` (forward mode through
``render_fn(with_boundary=True)``: the interior and both boundary terms)
for a mesh translation, a vertex displacement, a roughness change and an
envmap rotation, ``run_fd`` (common random numbers), each derivative image
per pixel; ``apply_perturbation``'s five modes against the JAX ones; and
the port's own AD against its FD on tests/test_opt.py's interior case.

A derivative image sums many cancelling terms (the triangle recompute,
the boundary splats), so its pixels agree to rtol 1e-3 with an atol of
1e-4 of the image's largest entry, on all but 1% of the pixels, and the
images to 1e-2 relative L2."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import psdr_tpu as J
import psdr_tpu_torch as T
from psdr_tpu import testing as j_testing
from psdr_tpu_torch import testing as t_testing
from psdr_tpu_torch.convert import params_from_numpy
from psdr_tpu_torch.core import transform as xf
from psdr_tpu_torch.testing import scenes as t_scenes

from scenes import sphere_light_scene as j_sphere
from test_torch_envmap import _pair as env_pair
from test_torch_envmap import _rotation
from test_torch_materials import _assert_images_match

torch.set_num_threads(2)

CPU = dict(device="cpu")     # the port defaults to the card


def _rough_scene(lib, width=24, height=24, spp=32, sppe=0, sppse=0):
    """tests/test_opt.py::test_harness_ad_matches_fd_interior's scene: a
    rough-conductor icosphere under a tilted area light."""
    sc = lib.Scene(**({} if lib is J else CPU))
    metal = sc.add_bsdf(lib.RoughConductor(alpha_u=0.2, alpha_v=0.2),
                        "metal")
    sc.add_mesh(lib.primitives.make_icosphere(subdiv=2, radius=1.0,
                                              bsdf_id=metal))
    light = lib.primitives.make_quad(size=1.0, bsdf_id=-1,
                                     enable_edges=False,
                                     use_face_normals=True)
    light.set_transform(xf.translate([0, 3.0, 3.0])
                        @ xf.rotate([1, 0, 0], 135.0))
    sc.add_emitter(lib.AreaLight([8.0, 8.0, 8.0],
                                 mesh_index=sc.add_mesh(light)))
    cam = lib.PerspectiveCamera(fov_x=40.0)
    cam.set_transform(xf.look_at([0, 0, 5], [0, 0, 0], [0, 1, 0]))
    sc.add_sensor(cam)
    sc.opts = lib.RenderOptions(width=width, height=height, spp=spp,
                                sppe=sppe, sppse=sppse)
    return sc


def _sphere_pair(**kw):
    return j_sphere(**kw), t_scenes.sphere_light_scene(**kw, **CPU)


def _assert_derivatives_match(got, want, min_share=0.99, rel_l2=1e-2):
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = np.abs(want).max()
    assert scale > 0.0
    close = np.isclose(got, want, rtol=1e-3, atol=1e-4 * scale).all(-1)
    assert close.mean() >= min_share, close.mean()
    assert np.linalg.norm(got - want) <= rel_l2 * np.linalg.norm(want)


def test_run_orig_matches_jax():
    js, ts = _sphere_pair(width=16, height=16, spp=4)
    want = j_testing.run_orig(js, J.DirectIntegrator(1, 1), npass=2)
    got = t_testing.run_orig(ts, T.DirectIntegrator(1, 1), npass=2)
    assert got.shape == want.shape == (16, 16, 3)
    _assert_images_match(got.reshape(-1, 3), want.reshape(-1, 3))


AD_CASES = {
    "mesh_transform": dict(kw=dict(mesh_index=0, direction=(1.0, 0.0, 0.0))),
    # vertex 25 of the subdiv-1 icosphere, (0, 0, 1), faces the camera
    "vertex_transform": dict(kw=dict(mesh_index=0, vertex_index=25,
                                     direction=(0.0, 1.0, 0.0))),
    "material_roughness": dict(kw={}),
    "envmap_rotate": dict(kw=dict(axis=(0.0, 1.0, 0.0))),
}


def _ad_pair(case):
    if case == "material_roughness":
        return (_rough_scene(J, 16, 16, spp=8, sppe=2, sppse=8),
                _rough_scene(T, 16, 16, spp=8, sppe=2, sppse=8),
                lambda lib: lib.DirectIntegrator(1, 1))
    if case == "envmap_rotate":
        js, ts, _ = env_pair(to_world=_rotation(), width=16, height=16, spp=4,
                             sppe=2, sppse=8)
        return js, ts, lambda lib: lib.PathTracer(2)
    js, ts = _sphere_pair(width=16, height=16, spp=4, sppe=4, sppse=8)
    return js, ts, lambda lib: lib.DirectIntegrator(1, 1)


@pytest.mark.parametrize("case", list(AD_CASES))
def test_run_ad_matches_jax(case):
    """The forward-mode derivative image with the boundary terms, two
    passes, against ``psdr_tpu.testing.run_ad`` (``jax.jvp``)."""
    js, ts, make = _ad_pair(case)
    kw = AD_CASES[case]["kw"]
    want = j_testing.run_ad(js, make(J), case, npass=2, **kw)
    got = t_testing.run_ad(ts, make(T), case, npass=2, **kw)
    _assert_derivatives_match(got, want)


def test_run_ad_with_guiding_matches_jax():
    js, ts = _sphere_pair(width=12, height=12, spp=2, sppe=2, sppse=8)
    kw = dict(direction=(1.0, 0.0, 0.0))
    guiding = ((4, 2, 2, 2), 1)
    want = j_testing.run_ad(js, J.DirectIntegrator(1, 1), "mesh_transform",
                            guiding=guiding, **kw)
    got = t_testing.run_ad(ts, T.DirectIntegrator(1, 1), "mesh_transform",
                           guiding=guiding, **kw)
    _assert_derivatives_match(got, want)


@pytest.mark.parametrize("case", ["mesh_rotate", "material_roughness"])
def test_run_fd_matches_jax(case):
    """Central differences, same keys at +-eps: the derivative images of
    the two packages agree (their renders agree per pixel). The rotation's
    eps is in degrees."""
    if case == "material_roughness":
        js, ts = _rough_scene(J, 16, 16, spp=8), _rough_scene(T, 16, 16, spp=8)
        kw, eps = {}, 0.02
    else:
        js, ts = _sphere_pair(width=16, height=16, spp=4)
        kw, eps = dict(mesh_index=0, axis=(0.0, 1.0, 0.0)), 2.0
    want = j_testing.run_fd(js, J.DirectIntegrator(1, 1), case, eps=eps,
                            npass=2, **kw)
    got = t_testing.run_fd(ts, T.DirectIntegrator(1, 1), case, eps=eps,
                           npass=2, **kw)
    _assert_derivatives_match(got, want)


@pytest.mark.parametrize("case", sorted(t_testing.PERTURBATIONS))
def test_apply_perturbation_matches_jax(case):
    """Each mode's perturbed params at P = 0.3 equal the JAX package's, and
    the leaves it does not touch are the same tensors."""
    js = _rough_scene(J)
    js.add_emitter(J.EnvironmentMap(np.ones((4, 8, 3), np.float32)))
    ts = _rough_scene(T)
    ts.add_emitter(T.EnvironmentMap(np.ones((4, 8, 3), np.float32)))
    kw = {"mesh_transform": dict(mesh_index=[0, 1],
                                 direction=[(1.0, 0, 0), (0, 2.0, 0)]),
          "mesh_rotate": dict(axis=(0.2, 1.0, 0.0)),
          "vertex_transform": dict(vertex_index=5),
          "envmap_rotate": dict(emitter_index=1)}.get(case, {})
    jp = jax.tree.map(jnp.asarray, js.params())
    want = J.testing.apply_perturbation(case, jp, jnp.float32(0.3), **kw)
    base = params_from_numpy(js.params(), **CPU)
    got = t_testing.apply_perturbation(case, base, torch.tensor(0.3), **kw)
    changed = 0
    for g in base:
        for i, entry in enumerate(base[g]):
            for k, leaf in entry.items():
                np.testing.assert_allclose(got[g][i][k].numpy(),
                                           np.asarray(want[g][i][k]),
                                           rtol=1e-6, atol=1e-6)
                changed += got[g][i][k] is not leaf
    assert changed == {"mesh_transform": 2, "material_roughness": 2}.get(
        case, 1)


def test_port_ad_matches_fd_interior():
    """tests/test_opt.py::test_harness_ad_matches_fd_interior in the port:
    the roughness derivative image by AD and by FD, 4 passes each; the 95th
    percentile of |AD - FD| under 0.15 of FD's largest entry."""
    sc = _rough_scene(T)
    integ = T.DirectIntegrator(1, 1)
    ad = t_testing.run_ad(sc, integ, "material_roughness", npass=4)
    fd = t_testing.run_fd(sc, integ, "material_roughness", eps=0.01, npass=4)
    assert np.abs(ad).max() > 0.0
    err = np.abs(ad - fd) / np.abs(fd).max()
    assert np.percentile(err, 95) < 0.15


@pytest.mark.parametrize("integ", ["direct", "path"])
def test_run_ad_through_checkpointed_chunks(integ):
    """``resolve_remat`` wraps each pass chunk in a non-reentrant
    ``torch.utils.checkpoint``: forward-mode tangents pass through it, and
    ``run_ad`` with remat on in small chunks equals it with remat off."""
    make = {"direct": lambda: T.DirectIntegrator(1, 1),
            "path": lambda: T.PathTracer(2)}[integ]
    out = []
    for remat in (False, True):
        sc = t_scenes.sphere_light_scene(12, 12, spp=4, sppe=2, sppse=16,
                                         **CPU)
        sc.opts = dataclasses.replace(sc.opts, remat_passes=remat,
                                      pass_lanes=256)
        out.append(t_testing.run_ad(sc, make(), "mesh_transform",
                                    direction=(1.0, 0.0, 0.0)))
    assert np.abs(out[0]).max() > 0.0
    np.testing.assert_array_equal(out[1], out[0])
