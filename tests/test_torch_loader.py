"""The port's scene IO against the JAX package's on the CPU: the XML loader
(``load_string``/``load_file``, ``load_integrator``, the transforms, the
textures read from EXR), ``renderC`` of a loaded scene per pixel,
``load_obj``'s faces, uv and normal indices and edge table row for row,
``Mesh.dump``, ``make_box``, ``transform.inverse``, and the copied EXR
codecs, which read what the JAX package's writer wrote and write the same
bytes, for every compression; and ``testing.scenes.write_scene``, whose
files both loaders read back."""
import dataclasses

import numpy as np
import jax
import pytest
import torch

import psdr_tpu as J
import psdr_tpu_torch as T
from psdr_tpu.core import exr as j_exr
from psdr_tpu.core import transform as j_xf
from psdr_tpu.shape import primitives as j_prim
from psdr_tpu_torch.convert import params_from_numpy
from psdr_tpu_torch.core import exr as t_exr
from psdr_tpu_torch.core import threefry
from psdr_tpu_torch.core import transform as t_xf
from psdr_tpu_torch.core.bitmap import from_array
from psdr_tpu_torch.shape import primitives as t_prim
from psdr_tpu_torch.testing import scenes as t_scenes

from test_loader import QUAD_OBJ, SCENE_XML
from test_torch_materials import _assert_images_match

torch.set_num_threads(2)

CPU = dict(device="cpu")     # the port defaults to the card


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("scene")
    (d / "quad.obj").write_text(QUAD_OBJ)
    tex = np.zeros((8, 8, 3), np.float32)
    tex[:, :4] = [0.9, 0.1, 0.1]
    tex[:, 4:] = [0.1, 0.1, 0.9]
    j_exr.write_exr(str(d / "tex.exr"), tex)
    (d / "scene.xml").write_text(SCENE_XML)
    return d


def _leaves(tree):
    out = []
    for g in sorted(tree):
        for i, entry in enumerate(tree[g]):
            for k in sorted(entry):
                v = entry[k]
                out.append(((g, i, k), v.detach().numpy()
                            if isinstance(v, torch.Tensor) else np.asarray(v)))
    return out


def test_load_string_matches_jax(scene_dir):
    """Equal RenderOptions, the same objects and ``param_map`` keys, every
    params leaf equal bit for bit, the integrator the XML names with its
    arguments, and renderC per pixel at tests/test_torch_render.py's
    tolerance (99% of pixels at rtol 1e-4, means to 1e-4)."""
    xml = (scene_dir / "scene.xml").read_text()
    js = J.load_string(xml, base_dir=str(scene_dir))
    ts = T.load_string(xml, base_dir=str(scene_dir), **CPU)
    assert ts.device == torch.device("cpu")
    assert (dataclasses.asdict(ts.opts) == dataclasses.asdict(js.opts))
    assert sorted(ts.param_map) == sorted(js.param_map)
    assert [m.num_faces for m in ts.meshes] == [m.num_faces for m in js.meshes]
    assert ([(m.bsdf_id, m.emitter_id, m.use_face_normals) for m in ts.meshes]
            == [(m.bsdf_id, m.emitter_id, m.use_face_normals)
                for m in js.meshes])
    jl, tl = _leaves(js.params()), _leaves(ts.params())
    assert [p for p, _ in tl] == [p for p, _ in jl]
    for (path, a), (_, b) in zip(jl, tl):
        assert a.shape == b.shape and np.array_equal(a, b), path
    ji, ti = J.load_integrator(js), T.load_integrator(ts)
    assert type(ti).__name__ == type(ji).__name__ == "DirectIntegrator"
    assert (ti.bsdf_samples, ti.light_samples) == (ji.bsdf_samples,
                                                   ji.light_samples) == (2, 2)
    want = np.asarray(ji.renderC(js, seed=0)).reshape(-1, 3)
    got = ti.renderC(ts, seed=0).numpy().reshape(-1, 3)
    _assert_images_match(got, want)
    # the textured quad faces the camera: left half red, right half blue
    img = got.reshape(32, 32, 3)
    assert img[12:20, 4:12, 0].mean() > img[12:20, 4:12, 2].mean()
    assert img[12:20, 20:28, 2].mean() > img[12:20, 20:28, 0].mean()


@pytest.mark.parametrize("spec,want", [
    ("", ("DirectIntegrator", dict(bsdf_samples=1, light_samples=1))),
    ('<integrator type="direct"><integer name="light_samples" value="3"/>'
     '</integrator>',
     ("DirectIntegrator", dict(bsdf_samples=1, light_samples=3))),
    ('<integrator type="path"><integer name="max_depth" value="4"/>'
     '<boolean name="hide_emitters" value="true"/></integrator>',
     ("PathTracer", dict(max_depth=4, hide_emitters=True))),
    ('<integrator type="field"><string name="field" value="depth"/>'
     '</integrator>', ("FieldExtractionIntegrator", dict(field="depth"))),
])
def test_load_integrator_matches_jax(spec, want):
    xml = ('<scene version="0.5.0">' + spec
           + '<sensor type="perspective"/></scene>')
    ji = J.load_integrator(J.load_string(xml))
    ti = T.load_integrator(T.load_string(xml, **CPU))
    name, args = want
    assert type(ji).__name__ == type(ti).__name__ == name
    for k, v in args.items():
        assert getattr(ti, k) == getattr(ji, k) == v, k


def test_load_file_and_scene_entry_points(scene_dir):
    """``load_file`` configures the scene on the device asked for;
    ``Scene.load_file``/``load_string`` are the same loaders; the light
    quad's transform composes scale, then rotate, then translate."""
    ts = T.Scene.load_file(str(scene_dir / "scene.xml"), **CPU)
    assert ts._flat_cache is not None
    assert ts.flat.tri.p0.device == torch.device("cpu")
    assert ts.flat.tri.p0.shape[0] == 4
    ts2 = T.Scene.load_string((scene_dir / "scene.xml").read_text(),
                              base_dir=str(scene_dir), **CPU)
    m = ts2.meshes[1]
    vp = m.world_positions(params_from_numpy(m.params(), **CPU)).numpy()
    assert np.allclose(vp[:, 2], 2.5, atol=1e-5)
    assert np.allclose(np.abs(vp[:, 0] - 1.4).max(), 0.3, atol=1e-5)
    np.testing.assert_array_equal(
        ts2.meshes[1].to_world, J.load_string(
            (scene_dir / "scene.xml").read_text(),
            base_dir=str(scene_dir)).meshes[1].to_world)


def test_loader_rejects_what_it_does_not_know():
    for xml, match in (
            ("<film/>", "root node"),
            ('<scene><bsdf type="plastic"/></scene>', "plastic"),
            ('<scene><sensor type="orthographic"/></scene>', "perspective"),
            ('<scene><integrator type="volpath"/><sensor '
             'type="perspective"/></scene>', "volpath")):
        with pytest.raises(ValueError, match=match):
            T.load_integrator(T.load_string(xml, **CPU))


OBJS = {
    "quad v/t": QUAD_OBJ,
    "fans, negative indices, v//n": (
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0.5 0.5 1\n"
        "vn 0 0 -1\nvn 0 0.7 0.7\n"
        "f 4//1 3//1 2//1 1//1\nf -5//2 -4//2 -1//2\nf 2//2 3//2 5//2\n"
        "f 3//2 4//2 5//2\nf 4//2 1//2 5//2\n"),
    "v/t/n mixed with plain corners": (
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nvt 0 0\nvt 1 0\nvt 1 1\n"
        "vn 0 0 1\nf 1/1/1 2/2/1 3/3/1\nf 1 3 4\n"),
}


@pytest.mark.parametrize("name", list(OBJS))
def test_load_obj_matches_jax(name, tmp_path):
    """faces, uv, uv_idx, normals, normal_idx and the edge table equal the
    JAX loader's row for row (its native parser where it builds, its Python
    loop otherwise: both take the faces in file order)."""
    p = tmp_path / "m.obj"
    p.write_text(OBJS[name])
    jm, tm = J.load_obj(str(p)), T.load_obj(str(p))
    for f in ("vertices", "faces", "uv", "uv_idx", "normals", "normal_idx",
              "edge_indices"):
        a, b = getattr(jm, f), getattr(tm, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == b.dtype and np.array_equal(a, b), f


def test_load_obj_of_the_bench_occluder_matches_jax(tmp_path):
    """A 20,480-face icosphere dumped by the JAX package: the port reads
    the same faces and edge table."""
    p = str(tmp_path / "ico.obj")
    j_prim.make_icosphere(subdiv=5, radius=0.5).dump(p)
    jm, tm = J.load_obj(p), T.load_obj(p)
    assert tm.num_faces == 20480
    np.testing.assert_array_equal(tm.faces, jm.faces)
    np.testing.assert_array_equal(tm.edge_indices, jm.edge_indices)
    np.testing.assert_allclose(tm.vertices, jm.vertices, rtol=0, atol=1e-7)


def test_mesh_dump_roundtrip_matches_jax(tmp_path):
    """``Mesh.dump`` writes the JAX package's file byte for byte (uv
    included) and reads back to the same geometry."""
    jm = j_prim.make_quad(size=0.7)
    tm = t_prim.make_quad(size=0.7)
    jm.dump(str(tmp_path / "j.obj"))
    tm.dump(str(tmp_path / "t.obj"))
    assert (tmp_path / "t.obj").read_bytes() == (tmp_path / "j.obj").read_bytes()
    ti = t_prim.make_icosphere(subdiv=1, radius=1.0)
    ti.vertex_positions = torch.as_tensor(ti.vertices) * 2.0  # a tensor leaf
    ti.dump(str(tmp_path / "i.obj"))
    back = T.load_obj(str(tmp_path / "i.obj"))
    np.testing.assert_allclose(back.vertices, ti.vertices * 2.0, rtol=1e-5)
    np.testing.assert_array_equal(back.faces, ti.faces)


def test_make_box_and_inverse_match_jax():
    for inward in (False, True):
        jb, tb = j_prim.make_box(0.7, inward), t_prim.make_box(0.7, inward)
        np.testing.assert_array_equal(tb.vertices, jb.vertices)
        np.testing.assert_array_equal(tb.faces, jb.faces)
        np.testing.assert_array_equal(tb.edge_indices, jb.edge_indices)
    m = (t_xf.translate([0.3, -1, 2]) @ t_xf.rotate([1, 2, 3], 40.0)
         @ t_xf.scale([1.0, 2.0, 0.5]))
    want = np.asarray(j_xf.inverse(m))
    np.testing.assert_allclose(t_xf.inverse(m), want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(t_xf.inverse(torch.as_tensor(m)).numpy(), want,
                               rtol=1e-5, atol=1e-6)


EXR_CASES = ([(c, h, None) for c in ("none", "rle", "zips", "zip", "piz",
                                     "pxr24", "b44", "b44a")
              for h in (True, False)]
             + [("piz", True, 16), ("zip", False, 16)])


@pytest.mark.parametrize("comp,half,tile", EXR_CASES)
def test_exr_codecs_interchange_with_jax(comp, half, tile, tmp_path):
    """The copied codecs write the JAX package's bytes, read its files and
    it reads theirs, bit for bit, for every compression (HALF and FLOAT
    channels; two tiled cases)."""
    rng = np.random.default_rng(len(comp) * 7 + bool(half))
    img = (rng.standard_normal((37, 53, 3)) * 3).astype(np.float32)
    jp, tp = str(tmp_path / "j.exr"), str(tmp_path / "t.exr")
    j_exr.write_exr(jp, img, compression=comp, half=half, tile=tile)
    t_exr.write_exr(tp, img, compression=comp, half=half, tile=tile)
    assert open(tp, "rb").read() == open(jp, "rb").read()
    a, b = t_exr.read_exr(jp), j_exr.read_exr(tp)
    assert a.dtype == b.dtype == np.float32
    assert a.tobytes() == b.tobytes() == j_exr.read_exr(jp).tobytes()


def test_written_scene_loads_back_in_both_packages(tmp_path):
    """``testing.scenes.write_scene`` of the cbox with a 64 x 64 texture on
    its floor (``chip_smoke.py`` phase 21's scene, cut to size): both
    loaders read it back with every params leaf equal to the written scene
    (vertices within %.6e's rounding, the rest bit for bit), and the loaded
    scene renders per pixel as the written one and as the JAX loader's."""
    sc = t_scenes.cbox_scene(32, 32, spp=4, occluder_subdiv=2, **CPU)
    floor = sc.add_bsdf(T.Diffuse(from_array(t_scenes.checker_texture(64))),
                        "floor")
    sc.meshes[0].bsdf_id = floor
    path = t_scenes.write_scene(sc, str(tmp_path))
    ts = T.load_file(path, **CPU)
    js = J.load_file(path)
    assert isinstance(T.load_integrator(ts), T.DirectIntegrator)
    assert dataclasses.asdict(ts.opts) == dataclasses.asdict(sc.opts)
    want = _leaves(sc.params())
    for got in (_leaves(ts.params()), _leaves(js.params())):
        assert [p for p, _ in got] == [p for p, _ in want]
        for (path_, a), (_, b) in zip(want, got):
            if path_[2] == "vertex_positions":
                np.testing.assert_allclose(b, a, rtol=6e-7, atol=1e-7)
            else:
                assert np.array_equal(a, b), path_
    assert [m.bsdf_id for m in ts.meshes] == [m.bsdf_id for m in sc.meshes]
    assert all(m.enable_edges for m in ts.meshes)
    integ = T.DirectIntegrator(1, 1)
    ref = integ.renderC(sc, seed=4).numpy().reshape(-1, 3)
    _assert_images_match(integ.renderC(ts, seed=4).numpy().reshape(-1, 3),
                         ref)
    _assert_images_match(
        np.asarray(J.DirectIntegrator(1, 1).renderC(js, seed=4)).reshape(
            -1, 3), ref)
