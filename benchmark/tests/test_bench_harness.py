"""The benchmark's own tests (CPU): the loader, the whole-window arithmetic,
the byte bounds, the module check, and the parts of the plain reference:
its geometry, its intersector and its sampling."""
import json
import math
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

import harness  # noqa: E402
import peaks  # noqa: E402
import reference  # noqa: E402
import shapes  # noqa: E402
import stats  # noqa: E402

LIMITS = {"forward": {"bias_all", "bias_region", "noise"},
          "grad_step": {"grad_err"}}


def test_loader_finds_every_named_file():
    bench = harness.Bench(ROOT)
    for w in bench.spec["workloads"]:
        wl = bench.workload(w["name"])
        assert wl["config"] == w["config"]
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        builder = bench.builder(w["config"])
        assert callable(builder.scene) and callable(builder.build)
        data = harness.scene_data(bench, w["name"])
        assert data["meshes"] and data["camera"]
        assert callable(bench.job(wl["kind"]).setup)
        assert set(wl["limits"]) == LIMITS[wl["kind"]]
        assert wl["kind"] != "forward" or wl["passes"] >= 1
        for traced in (False, True):
            for m in bench.metrics(w["name"], traced):
                assert callable(bench.reader(m["name"]).read)
        assert any(m["name"] == "setup_s"
                   for m in bench.metrics(w["name"], False))
        assert len(bench.metrics(w["name"], False)) >= 2
        assert bench.metrics(w["name"], True)


def test_benchmark_json_keeps_to_its_limits():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert spec["paths"] == ["benchmark"]
    names = ([c["name"] for c in spec["configs"]]
             + [w["name"] for w in spec["workloads"]]
             + [m["name"] for m in spec["end_to_end"] + spec["per_layer"]])
    assert len(names) == len(set(names))
    cells = {w["name"] for w in spec["workloads"]}
    for w in spec["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] == 1
    for c in spec["configs"]:
        assert len(c["why"]) <= 200 and len(c["source"]) <= 200
        assert (ROOT / c["file"]).is_file()
    e2e = {m["name"] for m in spec["end_to_end"]}
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    for m in spec["per_layer"]:
        assert m["moves"] in e2e


def test_a_cell_added_as_files_only(tmp_path):
    """A new cell, configuration and metric are new files and new entries;
    no file that is there changes."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH / "configs" / "cbox_direct.json").read_text())
    (tmp_path / "benchmark/configs/cbox_small.json").write_text(
        json.dumps(dict(cfg, name="cbox_small")))
    shutil.copy(BENCH / "configs/cbox_direct.py",
                tmp_path / "benchmark/configs/cbox_small.py")
    (tmp_path / "benchmark/workloads/cbox_small.tiny.json").write_text(
        json.dumps(dict(config="cbox_small", kind="forward", film=[8, 8],
                        spp=2, passes=1, check={}, limits={})))
    (tmp_path / "benchmark/metrics/steps_done.py").write_text(
        "def read(rec):\n    return rec['steps']\n")
    spec["configs"].append(dict(name="cbox_small", source="x",
                                file="benchmark/configs/cbox_small.json",
                                reduced=[], why="x"))
    spec["workloads"].append(dict(name="cbox_small.tiny", config="cbox_small",
                                  traffic="tiny", chips=1, why="x"))
    spec["per_layer"].append(dict(name="steps_done", unit="steps",
                                  better="higher", source="host_clock",
                                  layer="device", moves="setup_s",
                                  workloads=["cbox_small.tiny"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = harness.Bench(tmp_path)
    assert bench.workload("cbox_small.tiny")["spp"] == 2
    assert bench.config("cbox_small")["name"] == "cbox_small"
    assert [m["name"] for m in bench.metrics("cbox_small.tiny", True)] == [
        "capture_s", "steps_done"]
    assert bench.reader("steps_done").read({"steps": 7}) == 7
    assert len(harness.scene_data(bench, "cbox_small.tiny")["meshes"]) == 7


def test_whole_window_arithmetic():
    assert stats.rate(10, 256 * 256 * 160, 2.0) == 10 * 256 * 256 * 160 / 2.0
    # overlapping kernels count once; disjoint ones add
    iv = [(0, 4), (1, 2), (3, 6), (10, 11), (11, 12)]
    assert stats.merged(iv) == [[0, 6], [10, 12]]
    assert sum(e - s for s, e in stats.merged(iv)) == 8
    assert stats.idle_share(8, 20) == pytest.approx(60.0)
    with pytest.raises(ValueError):
        stats.rate(1, 1, 0.0)


def test_byte_bounds():
    assert peaks.k1_bytes(1 << 21, 1000, 20492) == (
        (1 << 21) * 17 + 1000 * 28 + 20492 * 36)
    assert peaks.bound_seconds(3.35e12) == pytest.approx(1.0)
    assert peaks.roofline_percent(3.35e9, 2e-3) == pytest.approx(50.0)
    assert peaks.roofline_percent(1, 0.0) is None


@pytest.mark.parametrize("names,found", [
    (["jax", "numpy"], ["jax"]),
    (["jaxlib.xla_client"], ["jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["psdr_tpu", "psdr_tpu.core.threefry"], ["psdr_tpu"]),
    (["psdr_tpu_torch", "psdr_tpu_torch.program", "jaxtyping"], []),
])
def test_module_check_compares_top_level_names_whole(names, found):
    assert harness.forbidden_modules(names) == found


def test_reference_imports_nothing_of_the_port():
    names = ["reference.py", "shapes.py", "check.py", "scenes.py"]
    names += [f"references/{p.name}"
              for p in sorted((BENCH / "references").glob("*.py"))]
    for name in names:
        text = (BENCH / name).read_text()
        assert "psdr_tpu" not in text and "import jax" not in text


def test_icosphere_counts_and_faces_outward():
    v, f = shapes.icosphere(3, 0.5)
    assert f.shape == (20 * 4 ** 3, 3) and len(v) == 10 * 4 ** 3 + 2
    assert np.allclose(np.linalg.norm(v, axis=1), 0.5)
    n = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    assert (np.einsum("ij,ij->i", n, v[f].mean(axis=1)) > 0).all()


def _brute_closest(p0, e1, e2, o, d):
    t_best = np.full(len(o), np.inf)
    idx = np.full(len(o), -1)
    for k in range(len(p0)):
        pv = np.cross(d, e2[k])
        det = pv @ e1[k]
        with np.errstate(divide="ignore", invalid="ignore"):
            tv = o - p0[k]
            u = np.einsum("ij,ij->i", tv, pv) / det
            qv = np.cross(tv, e1[k])
            v = np.einsum("ij,ij->i", d, qv) / det
            t = qv @ e2[k] / det
        hit = (u >= 0) & (v >= 0) & (u + v <= 1) & (t > reference.T_MIN)
        better = hit & (t < t_best)
        t_best[better], idx[better] = t[better], k
    return t_best, idx


def test_intersector_equals_a_plain_sweep():
    """The clustered closest and any hit against every triangle, one by
    one, on rays from inside and outside a sphere and a box."""
    sv, sf = shapes.icosphere(2, 0.6)
    qv, qf = shapes.quad(1.0)
    data = dict(meshes=[dict(vertices=sv, faces=sf, bsdf=0),
                        dict(vertices=shapes.apply(shapes.translate(
                            [0, 0, -1]), qv), faces=qf, bsdf=0)],
                lights=[dict(mesh=1, radiance=[1.0, 1.0, 1.0])])
    tris = reference.Triangles(data, "cpu", torch.float64)
    g = np.random.default_rng(3)
    n = 2000
    o = g.uniform(-1.5, 1.5, (n, 3))
    d = g.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t, idx = tris.hits(torch.tensor(o), torch.tensor(d),
                       torch.full((n,), math.inf), closest=True)
    p0, e1, e2 = (x.numpy() for x in (tris.p0, tris.e1, tris.e2))
    t_ref, idx_ref = _brute_closest(p0, e1, e2, o, d)
    assert (idx_ref >= 0).sum() > n // 10
    assert np.array_equal(idx.numpy(), idx_ref)
    assert np.allclose(t.numpy()[idx_ref >= 0], t_ref[idx_ref >= 0])
    tmax = np.where(np.isfinite(t_ref), t_ref * 0.5, 1.0)
    tmax[::3] = np.inf
    occ = tris.hits(torch.tensor(o), torch.tensor(d), torch.tensor(tmax),
                    closest=False)
    assert np.array_equal(occ.numpy(), t_ref < tmax)


def test_envmap_sampling_density_is_its_own():
    """The environment's directions, weighted by their density, cover the
    sphere: E[1 / pdf] = 4 pi, and E[L / pdf] equals the mean of L over
    uniform directions."""
    g = np.random.default_rng(5)
    img = g.uniform(0.1, 1.0, (16, 32, 3)).astype(np.float32)
    img[3, 7] = 400.0
    env = reference.Envmap(dict(radiance=img, scale=1.0), "cpu",
                           torch.float64)
    u = torch.tensor(g.uniform(size=(400000, 2)))
    w, pdf = env.sample(u, torch.float64)
    assert torch.allclose(torch.linalg.norm(w, dim=1),
                          torch.ones(len(w), dtype=torch.float64))
    assert float((1 / pdf).mean()) == pytest.approx(4 * math.pi, rel=0.01)
    z = torch.tensor(g.normal(size=(400000, 3)))
    z = z / torch.linalg.norm(z, dim=1, keepdim=True)
    uniform = float(env.radiance(z).mean()) * 4 * math.pi
    importance = float((env.radiance(w).mean(1) / pdf).mean())
    assert importance == pytest.approx(uniform, rel=0.02)


@pytest.mark.parametrize("kind", ["diffuse", "roughconductor"])
def test_bsdf_sampling_agrees_with_uniform_directions(kind):
    """E[f cos / pdf] over the BSDF's own directions equals the integral of
    f cos over uniform directions of the hemisphere."""
    b = dict(kind=kind, reflectance=[0.5, 0.6, 0.7], alpha_u=0.3,
             alpha_v=0.3, eta=[0.2, 0.9, 1.1], k=[3.9, 2.5, 2.1],
             specular_reflectance=[1.0, 1.0, 1.0])
    mats = reference.Materials([b], "cpu", torch.float64)
    g = np.random.default_rng(7)
    m = 400000
    n = torch.tensor([[0.0, 0.0, 1.0]], dtype=torch.float64).expand(m, 3)
    wi = torch.tensor([0.3, -0.2, 0.93], dtype=torch.float64)
    wi = (wi / torch.linalg.norm(wi)).expand(m, 3)
    bid = torch.zeros(m, dtype=torch.int64)
    wo = mats.sample(bid, n, wi, torch.tensor(g.uniform(size=(m, 2))))
    pdf = mats.pdf(bid, n, wi, wo)
    f = mats.eval(bid, n, wi, wo)
    ok = pdf > 0
    own = (f[ok] / pdf[ok, None]).sum(0) / m
    z = torch.tensor(g.normal(size=(m, 3)))
    z = z / torch.linalg.norm(z, dim=1, keepdim=True)
    z[:, 2] = z[:, 2].abs()
    flat = mats.eval(bid, n, wi, z).mean(0) * 2 * math.pi
    assert torch.allclose(own, flat, rtol=0.02)
    # and the density integrates to at most 1 over the hemisphere
    assert float(mats.pdf(bid, n, wi, z).mean() * 2 * math.pi) <= 1.01


def test_key_words_repeat_and_take_large_seeds():
    a, ja = harness.key_words(2 ** 31 + 17, 5)
    b, jb = harness.key_words(2 ** 31 + 17, 5)
    assert np.array_equal(a, b) and ja == jb and 0 <= ja < harness.CHECKED
    assert a.dtype == np.int64 and a.min() >= 0 and a.max() < 2 ** 32
    c, _ = harness.key_words(2 ** 31 + 18, 5)
    assert not np.array_equal(a, c)
