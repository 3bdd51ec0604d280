"""The scene-query layer of the port against the JAX package's: the
direction sort in front of a kernel (``_octant_sort``, ``_closest_hit``
with ``sort_rays``), the compacted occlusion sweeps (``ray_test`` with
``sparse``, ``_ray_test_sparse``, ``DirectIntegrator._sparse_or_plain_test``),
the accelerator's selection (``Scene.accel_mode``, ``accel_leaf_size``,
``FlatScene.accel_kind``), the public traversals ``ray_intersect_culled``
and ``ray_intersect_bvh``, and the gather's mode setter.

Inputs come from numpy seeds and go through both packages. The sort's
permutation is exact; hits hold as tests/test_bvh.py:43-50 holds them
(valid equal, tri_id equal but at ties in t, rtol 1e-5); an occlusion
answer is exact. A sorted or compacted query equals the plain one bit for
bit, since a ray's answer does not depend on its batch. The JAX "pallas"
queries run the Pallas kernel in interpret mode on the CPU, as
tests/test_bvh.py:308 runs them; the port's run ``k1_plain`` there."""
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import psdr_tpu as J
import psdr_tpu_torch as T
from psdr_tpu.accel import pallas_kernel
from psdr_tpu.accel.bruteforce import ray_intersect_brute as j_brute
from psdr_tpu.accel.bvh import build_bvh_topology as j_topology
from psdr_tpu.accel.bvh import ray_intersect_bvh as j_walk
from psdr_tpu.accel.bvh import ray_intersect_culled as j_culled
from psdr_tpu.accel.bvh import refit_bvh as j_refit
from psdr_tpu.core.records import Ray as JRay
from psdr_tpu.scene import scene as j_scene
from psdr_tpu_torch.accel import bvh as t_bvh
from psdr_tpu_torch.accel import intersect
from psdr_tpu_torch.convert import params_from_numpy
from psdr_tpu_torch.core import gather, threefry
from psdr_tpu_torch.core.constants import ShadowEpsilon
from psdr_tpu_torch.core.records import Ray as TRay
from psdr_tpu_torch.integrator import direct as t_direct
from psdr_tpu_torch.scene import scene as t_scene
from psdr_tpu_torch.testing import scenes as t_scenes

from scenes import cbox_scene as j_cbox
from test_torch_envmap import _pair as _env_pair

torch.set_num_threads(2)

CPU = dict(device="cpu")     # the port defaults to the card


def _dirs(rng, n):
    """Unit directions, a tenth of them exactly +-1 along an axis (the
    bin's clip at the top)."""
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    axis = rng.integers(0, 3, n)
    pick = rng.uniform(size=n) < 0.1
    d[pick] = 0.0
    d[pick, axis[pick]] = rng.choice([-1.0, 1.0], pick.sum())
    return d


@pytest.mark.parametrize("impl", ["argsort", "counting"])
@pytest.mark.parametrize("n", [1 << 16, 3 * 4096, 1000, 5000])
def test_octant_sort_matches_jax(n, impl):
    """The permutation and its inverse equal JAX's, lane for lane, under
    both implementation names: two 2^15-lane segments, three 4096-lane
    ones (2^15 does not divide), one segment of a small batch, and a size
    that divides into neither (None)."""
    rng = np.random.default_rng(n)
    o = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    d = _dirs(rng, n)
    act = rng.uniform(size=n) < 0.7
    jp, ji = j_scene._octant_sort(JRay(jnp.asarray(o), jnp.asarray(d)),
                                  jnp.asarray(act), impl=impl)
    tp, ti = t_scene._octant_sort(TRay(torch.from_numpy(o),
                                       torch.from_numpy(d)),
                                  torch.from_numpy(act), impl=impl)
    if n == 5000:
        assert jp is None and ti is None and tp is None
        return
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    tq, none = t_scene._octant_sort(
        TRay(torch.from_numpy(o), torch.from_numpy(d)),
        torch.from_numpy(act), want_inv=False, impl=impl)
    assert none is None and torch.equal(tq, tp)


def _scene_pair(mode, leaf_size=4, **kw):
    """(JAX scene, port scene) of the 16 x 16 cbox (1,292 triangles) under
    ``accel_mode`` and ``accel_leaf_size``, their flat scenes built."""
    js = j_cbox(width=16, height=16, **kw)
    ts = t_scenes.cbox_scene(16, 16, **kw, **CPU)
    for s in (js, ts):
        s.accel_mode = mode
        s.accel_leaf_size = leaf_size
        s.prepare_accel()
    return js, ts


def _rays(rng, n, spread=0.8):
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    return o, _dirs(rng, n)


def _assert_hits_match(ref, hit):
    np.testing.assert_array_equal(np.asarray(ref.valid), hit.valid.numpy())
    same = np.asarray(ref.tri_id) == hit.tri_id.numpy()
    tie = np.isclose(np.asarray(ref.t), hit.t.numpy(), rtol=1e-5)
    assert np.all(same | tie)
    v = np.asarray(ref.valid)
    np.testing.assert_allclose(np.asarray(ref.t)[v], hit.t.numpy()[v],
                               rtol=1e-5)


def _assert_records_equal(a, b):
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("mode", ["culled", "bvh_walk"])
def test_sorted_closest_hit_matches_unsorted_and_jax(mode):
    """``_closest_hit(sort_rays=True)`` on 8,192 rays (two 4096-lane
    segments, a third inactive, half under a finite tmax): the record
    equals the unsorted query's bit for bit, and JAX's sorted one; the
    ``test_only`` booleans and the any-hit ones equal the plain answer."""
    js, ts = _scene_pair(mode, spp=1)
    jflat, tflat = js.build(js.params()), ts.flat
    assert tflat.accel_kind == jflat.accel_kind == mode
    rng = np.random.default_rng(5)
    n = 8192
    o, d = _rays(rng, n)
    act = rng.uniform(size=n) < 0.67
    tmax = np.where(rng.uniform(size=n) < 0.5, np.inf,
                    rng.uniform(0.2, 2.0, n)).astype(np.float32)
    tr = TRay(torch.from_numpy(o), torch.from_numpy(d))
    ta, tt = torch.from_numpy(act), torch.from_numpy(tmax)
    plain = t_scene._closest_hit(tflat, tr, ta, tmax=tt)
    srt = t_scene._closest_hit(tflat, tr, ta, tmax=tt, sort_rays=True)
    _assert_records_equal(plain, srt)
    jhit = j_scene._closest_hit(jflat, JRay(jnp.asarray(o), jnp.asarray(d)),
                                jnp.asarray(act), tmax=jnp.asarray(tmax),
                                sort_rays=True)
    _assert_hits_match(jhit, srt)
    for any_hit in (False, True):
        occ = t_scene._closest_hit(tflat, tr, ta, tmax=tt, sort_rays=True,
                                   any_hit=any_hit, test_only=True)
        assert torch.equal(occ, plain.valid)


@pytest.mark.parametrize("case", ["1% active", "overflowing", "all inactive",
                                  "frac_shift=2"])
def test_sparse_ray_test_matches_jax_and_dense(case, monkeypatch):
    """``ray_test(sparse=True)`` under ``accel_mode="pallas"`` on 8,192
    rays (two 4096-lane segments: a cap of 512 lanes each, 1,024 with
    ``frac_shift=2`` through ``DirectIntegrator._sparse_or_plain_test``)
    equals the dense sweep and the brute-force answer lane for lane, and
    JAX's (its Pallas kernel interpreted). The compacted sweep and the
    residue sweep of the lanes past the cap are the two K1 launches; the
    residue has active lanes only where a segment overflows."""
    js, ts = _scene_pair("pallas", spp=1)
    jflat, tflat = js.build(js.params()), ts.flat
    assert tflat.accel_kind == jflat.accel_kind == "pallas"
    rng = np.random.default_rng(31)
    n = 8192
    o, d = _rays(rng, n)
    dist = rng.uniform(0.1, 3.0, n).astype(np.float32)
    frac = {"1% active": 0.01, "overflowing": 0.9, "all inactive": 0.0,
            "frac_shift=2": 0.2}[case]
    act = rng.uniform(size=n) < frac
    if case == "frac_shift=2":      # one segment overflows a quarter cap
        act[:4096] = rng.uniform(size=4096) < 0.4
    tr = TRay(torch.from_numpy(o), torch.from_numpy(d))
    ta, tdist = torch.from_numpy(act), torch.from_numpy(dist)
    launches = []
    k1 = intersect.ray_intersect_k1

    def spy(bvh, o, d, active=None, tmax=None, any_hit=False):
        launches.append((o.shape[0], int(active.sum())))
        return k1(bvh, o, d, active, tmax, any_hit=any_hit)
    with monkeypatch.context() as m:
        m.setattr(t_scene, "ray_intersect_k1", spy)
        if case == "frac_shift=2":
            occ = t_direct.DirectIntegrator._sparse_or_plain_test(
                tflat, tr.o, tr.d, tdist, ta, frac_shift=2)
        else:
            occ = t_scene.ray_test(tflat, tr, tdist, ta, sort_rays=True,
                                   sparse=True)
    shift = 2 if case == "frac_shift=2" else 3
    ks = 4096 >> shift
    counts = act.reshape(2, 4096).sum(axis=1)
    residue = int(np.maximum(counts - ks, 0).sum())
    assert launches == [(n >> shift, int(np.minimum(counts, ks).sum())),
                        (n, residue)]
    assert (residue > 0) == (case in ("overflowing", "frac_shift=2"))
    dense = t_scene.ray_test(tflat, tr, tdist, ta)
    assert torch.equal(occ, dense)
    jr = JRay(jnp.asarray(o), jnp.asarray(d))
    if case == "frac_shift=2":
        jocc = J.DirectIntegrator._sparse_or_plain_test(
            jflat, jr.o, jr.d, jnp.asarray(dist), jnp.asarray(act),
            frac_shift=2)
    else:
        jocc = jax.jit(lambda a: j_scene.ray_test(
            jflat, jr, jnp.asarray(dist), a, sort_rays=True,
            sparse=True))(jnp.asarray(act))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
    hb = j_brute(jflat.tri.p0, jflat.tri.e1, jflat.tri.e2, jr.o, jr.d,
                 jnp.ones(n, bool), tmax=jnp.asarray(dist - ShadowEpsilon))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(hb.valid) & act)
    if case != "all inactive":
        assert occ.any()


def _soup(n_tris, seed):
    rng = np.random.default_rng(seed)
    p0 = rng.uniform(-1, 1, (n_tris, 3)).astype(np.float32)
    e1 = rng.uniform(-0.3, 0.3, (n_tris, 3)).astype(np.float32)
    e2 = rng.uniform(-0.3, 0.3, (n_tris, 3)).astype(np.float32)
    return p0, e1, e2


def _soup_rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


def _trees(p0, e1, e2, leaf_size=4):
    jt = j_topology(p0, e1, e2, leaf_size=leaf_size)
    tt = t_bvh.build_bvh_topology(p0, e1, e2, leaf_size=leaf_size)
    jb = j_refit(jt, *(jnp.asarray(x) for x in (p0, e1, e2)))
    tb = t_bvh.refit_bvh(tt, *(torch.from_numpy(x) for x in (p0, e1, e2)))
    return jb, tb


@pytest.mark.parametrize("fn,n_tris,block", [
    ("bvh", 7, 4), ("bvh", 64, 4), ("bvh", 501, 8), ("bvh", 2048, 4),
    ("culled", 64, 64), ("culled", 501, 128), ("culled", 2048, 512)])
def test_public_traversals_match_brute(fn, n_tris, block):
    """``ray_intersect_bvh`` (leaf size ``block``) and
    ``ray_intersect_culled`` (triangle block ``block``) on random soups
    under 512 rays against brute force and against the JAX function of the
    same name, as tests/test_bvh.py:33 and :110 hold JAX's."""
    p0, e1, e2 = _soup(n_tris, 0 if fn == "bvh" else 3)
    o, d = _soup_rays(512, 1 if fn == "bvh" else 4)
    jb, tb = _trees(p0, e1, e2, leaf_size=block if fn == "bvh" else 4)
    to, tdir = torch.from_numpy(o), torch.from_numpy(d)
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    if fn == "bvh":
        hit, ref = t_bvh.ray_intersect_bvh(tb, to, tdir), j_walk(jb, jo, jd)
    else:
        hit = t_bvh.ray_intersect_culled(tb, to, tdir, tri_block=block)
        ref = j_culled(jb, jo, jd, tri_block=block)
    _assert_hits_match(j_brute(*(jnp.asarray(x) for x in (p0, e1, e2)),
                               jo, jd), hit)
    _assert_hits_match(ref, hit)


@pytest.mark.parametrize("fn", ["bvh", "culled"])
def test_public_traversals_respect_active_and_tmax(fn):
    """Inactive rays miss; under a tmax of half the closest hit a ray
    misses or hits closer (tests/test_bvh.py:53 and :127); with both, the
    record equals JAX's."""
    p0, e1, e2 = _soup(256, 0)
    o, d = _soup_rays(128, 1)
    jb, tb = _trees(p0, e1, e2)
    to, tdir = torch.from_numpy(o), torch.from_numpy(d)
    t_fn = t_bvh.ray_intersect_bvh if fn == "bvh" else \
        t_bvh.ray_intersect_culled
    j_fn = j_walk if fn == "bvh" else j_culled
    active = torch.arange(128) % 2 == 0
    assert not t_fn(tb, to, tdir, active=active).valid[1::2].any()
    hb = j_brute(*(jnp.asarray(x) for x in (p0, e1, e2)), jnp.asarray(o),
                 jnp.asarray(d))
    tmax = np.where(np.asarray(hb.valid), np.asarray(hb.t) * 0.5,
                    np.inf).astype(np.float32)
    hit = t_fn(tb, to, tdir, tmax=torch.from_numpy(tmax))
    assert np.all((hit.t.numpy() <= tmax + 1e-6) | ~hit.valid.numpy())
    both = t_fn(tb, to, tdir, active=active, tmax=torch.from_numpy(tmax))
    _assert_hits_match(j_fn(jb, jnp.asarray(o), jnp.asarray(d),
                            active=jnp.asarray(active.numpy()),
                            tmax=jnp.asarray(tmax)), both)


def test_k3_blocking_maps_the_tpu_schedule():
    """The JAX defaults map onto K3's own blocking; a ray block above
    1024 threads never reaches K3, and a triangle block is a power-of-two
    count of leaves."""
    p0, e1, e2 = _soup(501, 3)
    _, tb = _trees(p0, e1, e2)
    assert t_bvh._k3_blocking(tb, 2048, 512) == (512, 128)
    assert t_bvh._k3_blocking(tb, 8192, 64) == (1024, 16)
    assert t_bvh._k3_blocking(tb, 64, 12) == (32, 4)
    _, tb8 = _trees(p0, e1, e2, leaf_size=8)
    assert t_bvh._k3_blocking(tb8, 2048, 512) == (512, 128)
    assert t_bvh._k3_blocking(tb8, 2048, 200) == (512, 32)


@pytest.mark.parametrize("mode,leaf_size", [
    ("auto", 4), ("brute", 4), ("bvh", 4), ("bvh_walk", 4), ("culled", 4),
    ("pallas", 4), ("culled", 8)])
def test_render_matches_jax_under_accel_mode(mode, leaf_size):
    """renderC of the 16 x 16 cbox (spp 4, 1,292 triangles) under each
    ``accel_mode``, and a leaf size of 8, against JAX's under the same
    settings: as tests/test_torch_render.py holds renders, at least 99% of
    pixels allclose (rtol 1e-4, atol 1e-5) and means to 1e-4; and, within
    the port, equal bit for bit to the "auto" render (tests/test_bvh.py:72
    and :138 hold JAX's modes to each other). ``accel_kind`` resolves as
    JAX's does on a CPU."""
    js, ts = _scene_pair(mode, leaf_size, spp=4, occluder_subdiv=3)
    jflat = js.build(js.params())
    assert ts.flat.accel_kind == jflat.accel_kind
    assert (ts.flat.accel is None) == (jflat.accel is None) == \
        (mode == "brute")
    if ts.flat.accel is not None:
        assert ts.flat.accel.leaf_size == leaf_size
    j_img = np.asarray(J.DirectIntegrator(1, 1).renderC(js, seed=3))
    t_img = T.DirectIntegrator(1, 1).renderC(ts, seed=3)
    close = np.isclose(t_img.numpy(), j_img, rtol=1e-4, atol=1e-5).all(-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(t_img.mean() - j_img.mean()) / j_img.mean() < 1e-4
    _, auto = _scene_pair("auto", spp=4, occluder_subdiv=3)
    assert torch.equal(t_img, T.DirectIntegrator(1, 1).renderC(auto, seed=3))


def test_accel_mode_resolves_as_jax():
    """"auto" is "pallas" on a CUDA scene and "culled" on a CPU one (the
    kind is read at the build; no device is touched); "bvh" is "culled";
    an unknown mode raises."""
    sc = t_scenes.cbox_scene(8, 8, occluder_subdiv=3, **CPU)
    assert sc.accel_mode == "auto" and sc.accel_leaf_size == 4
    assert sc._accel_kind() == "culled"
    sc.device = torch.device("cuda")
    assert sc._accel_kind() == "pallas"
    sc.accel_mode = "bvh"
    assert sc._accel_kind() == "culled"
    with pytest.raises(ValueError, match="accel_mode"):
        sc.accel_mode = "optix"


def test_gather_vjp_mode_round_trips_and_modes_agree():
    """``set_gather_vjp_mode`` sets what ``get_gather_vjp_mode`` reads, as
    JAX's, and refuses an unknown mode; a render's gradient (cbox 8 x 8,
    spp 2) is the same under every mode."""
    from psdr_tpu.core import gather as j_gather
    start = gather.get_gather_vjp_mode()
    assert start == j_gather.get_gather_vjp_mode() == "native"
    sc = t_scenes.cbox_scene(8, 8, spp=2, occluder_subdiv=3, **CPU)
    grads = {}
    try:
        for mode in ("scatter", "sorted", "cumsum", "native"):
            gather.set_gather_vjp_mode(mode)
            assert gather.get_gather_vjp_mode() == mode
            p = params_from_numpy(sc.params(), requires_grad=True, **CPU)
            img = T.DirectIntegrator(1, 1).render_fn(
                sc, with_boundary=False)(p, threefry.PRNGKey(1))
            (img ** 2).mean().backward()
            grads[mode] = torch.cat([x.grad.reshape(-1)
                                     for m in p["meshes"] for x in m.values()])
        with pytest.raises(ValueError, match="vjp mode"):
            gather.set_gather_vjp_mode("atomic")
    finally:
        gather.set_gather_vjp_mode(start)
    assert gather.get_gather_vjp_mode() == start
    assert grads["native"].abs().sum() > 0
    for mode in ("scatter", "sorted", "cumsum"):
        torch.testing.assert_close(grads[mode], grads["native"], rtol=1e-4,
                                   atol=1e-6)


def _big_light(lib, width=8, height=8, spp=2):
    """A diffuse quad lit by an icosphere light of 20,480 faces: more
    emitter faces than the emitter-first query takes (``em_tri_idx`` is
    None), so a bounce runs the full closest hit (``direct.py:200``)."""
    import psdr_tpu.core.transform as jxf
    sc = lib.Scene(**({} if lib is J else CPU))
    b = sc.add_bsdf(lib.Diffuse([0.8, 0.8, 0.8]), "white")
    q = lib.primitives.make_quad(size=4.0, bsdf_id=b, enable_edges=False,
                                 use_face_normals=True)
    sc.add_mesh(q)
    light = lib.primitives.make_icosphere(subdiv=5, radius=0.5, bsdf_id=-1)
    light.set_transform(np.asarray(jxf.translate([0.0, 0.0, 2.0])))
    sc.add_emitter(lib.AreaLight([5.0, 5.0, 5.0],
                                 mesh_index=sc.add_mesh(light)))
    cam = lib.PerspectiveCamera(fov_x=60.0)
    cam.set_transform(np.asarray(jxf.look_at([0, -3, 3], [0, 0, 0],
                                             [0, 0, 1])))
    sc.add_sensor(cam)
    sc.opts = lib.RenderOptions(width=width, height=height, spp=spp)
    return sc


def _site_pair(config):
    """(JAX scene, port scene, JAX integrator, port integrator, boundary)
    of a ``test_query_sites_match_jax`` configuration."""
    if config.startswith("direct"):
        integ = (J.DirectIntegrator(1, 1), T.DirectIntegrator(1, 1))
    elif config == "path boundary":
        integ = (J.PathTracer(2, camera_depth=2),
                 T.PathTracer(2, camera_depth=2))
    else:
        integ = (J.PathTracer(3), T.PathTracer(3))
    if "envmap" in config:
        js, ts, _ = _env_pair(width=16, height=16, spp=4)
    elif config == "direct, big light":
        js, ts = _big_light(J), _big_light(T)
    else:
        boundary = "boundary" in config
        kw = dict(spp=4, occluder_subdiv=3,
                  **(dict(sppe=2, sppse=4) if boundary else {}))
        js, ts = j_cbox(width=16, height=16, **kw), \
            t_scenes.cbox_scene(16, 16, **kw, **CPU)
    for sc in (js, ts):
        sc.accel_mode = "pallas"
        sc.prepare_accel()
    return js, ts, *integ, "boundary" in config


def _record_sites(prefix, scene_mod, mods, run, monkeypatch):
    """The (integrator function, query kind) pairs of every sort and
    compaction that ``run()`` reaches through ``scene_mod``: "sorted"
    (a hit record, permuted back), "sorted test" (booleans only) and
    "compacted 1/k". The port's ``path._connect_camera`` is the
    JAX package's camera connection written out at each of its three
    call sites (``path.py:604``, ``:648``, ``:811``): its caller names
    the site."""
    sites = set()

    def site():
        f = sys._getframe(2)
        while f is not None:
            if (f.f_globals.get("__name__", "").startswith(
                    prefix + ".integrator")
                    and f.f_code.co_name != "_connect_camera"):
                return f.f_code.co_name
            f = f.f_back
        return None

    sort0, sparse0 = scene_mod._octant_sort, scene_mod._ray_test_sparse

    def sort(ray, active, seg=1 << 15, want_inv=True, impl=None):
        f = sys._getframe(1)        # _closest_hit or _ray_test_sparse
        test = f.f_code.co_name != "_closest_hit" or f.f_locals["test_only"]
        sites.add((site(), "sorted test" if test else "sorted"))
        return sort0(ray, active, seg=seg, want_inv=want_inv, impl=impl)

    def sparse(flat, ray, tmax, active, frac_shift=3, seg=1 << 15):
        sites.add((site(), f"compacted 1/{1 << frac_shift}"))
        return sparse0(flat, ray, tmax, active, frac_shift=frac_shift,
                       seg=seg)
    with monkeypatch.context() as m:
        m.setattr(scene_mod, "_octant_sort", sort)
        for mod in mods:
            m.setattr(mod, "_ray_test_sparse", sparse)
        run()
    return sites


@pytest.mark.parametrize("config,reuse", [
    ("direct", "edge"), ("direct", "bern"), ("direct, boundary", "off"),
    ("direct, envmap", "off"), ("direct, big light", "off"),
    ("path, envmap", "off"), ("path boundary", "off")])
def test_query_sites_match_jax(config, reuse, monkeypatch):
    """Under ``accel_mode="pallas"``, the port's integrators sort and
    compact the queries that the JAX package's do, call site by call site
    (by integrator function and kind of query): the emitter-first sweep
    and NEE with visibility reuse, its quarter-cap second sweep, the
    boundary terms' camera connections, NEE under an envmap, a bounce's
    full closest hit, and the PathTracer's bounces. The JAX side is traced
    (``jax.eval_shape``), its kernel stood in for by the block cull."""
    monkeypatch.setenv("PSDR_TPU_VIS_REUSE", reuse)
    if reuse == "bern":
        monkeypatch.setenv("PSDR_TPU_VIS_REUSE_Q", "0.25")
    js, ts, ji, ti, boundary = _site_pair(config)

    def j_run():
        jax.eval_shape(ji.render_fn(js, with_boundary=boundary,
                                    detached=not boundary),
                       js.params(), jax.random.PRNGKey(0))

    def t_run():
        with torch.no_grad():
            ti.render_fn(ts, with_boundary=boundary,
                         detached=not boundary)(
                params_from_numpy(ts.params(), **CPU), threefry.PRNGKey(0))
    monkeypatch.setattr(
        pallas_kernel, "ray_intersect_pallas_culled2",
        lambda bvh, o, d, act, tmax=None, **_: j_culled(bvh, o, d, act,
                                                        tmax=tmax))
    want = _record_sites("psdr_tpu", j_scene, (j_scene,), j_run, monkeypatch)
    got = _record_sites("psdr_tpu_torch", t_scene, (t_scene, t_direct),
                        t_run, monkeypatch)
    assert got == want
    assert got >= SITES[config, reuse]


# the sites each configuration must reach (of those its run reaches)
SITES = {
    ("direct", "edge"): {("Li", "compacted 1/8"),
                         ("_nee_visibility_impl", "compacted 1/8"),
                         ("_sparse_or_plain_test", "compacted 1/4")},
    ("direct", "bern"): {("_nee_visibility_impl", "compacted 1/8")},
    ("direct, boundary", "off"): {("Li", "compacted 1/8")},
    ("direct, envmap", "off"): {("Li", "sorted test")},
    ("direct, big light", "off"): {("Li", "sorted")},
    ("path, envmap", "off"): {("depth_body", "sorted"),
                              ("depth_body", "sorted test")},
    ("path boundary", "off"): {("eval_secondary_edge_camera",
                                "compacted 1/8")},
}
