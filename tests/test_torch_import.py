"""The port imports without jax, and the kernels' CUDA wrappers refuse
what they cannot run instead of falling back."""
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from psdr_tpu_torch.accel import bvh as t_bvh
from psdr_tpu_torch.accel import intersect

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "psdr_tpu_torch"


def test_import_without_jax():
    """Every module of the package imports with jax blocked, core.gather
    and the kernel modules included; and, still with jax blocked, the
    boundary code runs: the edge table, the HyperCube functions, the
    guiding preprocess and a boundary render with its backward on the CPU
    at 8x8; and the materials and lights: a rough conductor under an
    environment map, a textured quad and an AOV; and the loader, the EXR
    codecs, an optimizer step and the harness; and the sharding module,
    its launcher and the six examples, with a lane-sliced render of one
    rank's share and an update of the functional Adam; and the programs
    and the hoisted device constants."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import psdr_tpu_torch\n"
        "for m in pkgutil.walk_packages(psdr_tpu_torch.__path__,"
        " 'psdr_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "for m in ('core.gather', 'accel.intersect', 'accel.bruteforce',"
        " 'bsdf.ggx', 'bsdf.roughconductor', 'emitter.envmap',"
        " 'integrator.field', 'core.bitmap', 'scene.loader', 'opt',"
        " 'testing.harness', 'testing.differential', 'profiling',"
        " 'core.exr', 'core.piz', 'core.b44', 'parallel',"
        " 'parallel.sharding', 'parallel.launch', 'testing.ranks',"
        " 'program', 'core.hoist', 'examples.render_simple',"
        " 'examples.validate_gradients', 'examples.inverse_albedo',"
        " 'examples.inverse_geometry', 'examples.multiview_inverse',"
        " 'examples.flagship_recovery'):\n"
        "    assert 'psdr_tpu_torch.' + m in sys.modules, m\n"
        "assert not any(k in ('jax', 'psdr_tpu')"
        " or k.startswith(('jax.', 'psdr_tpu.'))"
        " for k, v in sys.modules.items() if v is not None)\n"
        "import torch\n"
        "from psdr_tpu_torch import DirectIntegrator\n"
        "from psdr_tpu_torch.convert import params_from_numpy\n"
        "from psdr_tpu_torch.core import distribution as D, threefry\n"
        "from psdr_tpu_torch.shape.mesh import build_edges\n"
        "from psdr_tpu_torch.testing.scenes import cbox_scene\n"
        "sc = cbox_scene(8, 8, spp=1, sppe=2, sppse=16, occluder_subdiv=1,"
        " device='cpu')\n"
        "assert build_edges(sc.meshes[5].faces).shape == (120, 5)\n"
        "hc = D.hypercube_set_mass(D.hypercube_init((2, 3, 2),"
        " device='cpu'), torch.arange(12.0))\n"
        "w, pdf = D.hypercube_sample_reuse(hc, torch.rand(64, 3))\n"
        "assert torch.allclose(D.hypercube_pdf(hc, w), pdf)\n"
        "integ = DirectIntegrator(1, 1)\n"
        "integ.preprocess_secondary_edges(sc, 0, (2, 2, 2, 4), seed=1)\n"
        "p = params_from_numpy(sc.params(), device='cpu',"
        " requires_grad=True)\n"
        "img = integ.render_fn(sc, with_boundary=True)(p,"
        " threefry.PRNGKey(1))\n"
        "img.mean().backward()\n"
        "g = p['meshes'][5]['vertex_positions'].grad\n"
        "assert img.shape == (64, 3) and torch.isfinite(g).all()\n"
        "import numpy as np\n"
        "from psdr_tpu_torch import (FieldExtractionIntegrator, PathTracer,"
        " RoughConductor)\n"
        "from psdr_tpu_torch.testing.scenes import (env_scene,"
        " textured_quad_scene)\n"
        "sc = env_scene(RoughConductor(0.3, 0.2), 8, 8, spp=2, device='cpu')\n"
        "p = params_from_numpy(sc.params(), device='cpu',"
        " requires_grad=True)\n"
        "PathTracer(2).render_fn(sc, with_boundary=False)(p,"
        " threefry.PRNGKey(1)).mean().backward()\n"
        "assert torch.isfinite(p['bsdfs'][0]['alpha_u'].grad).all()\n"
        "assert torch.isfinite(p['emitters'][0]['to_world'].grad).all()\n"
        "sc = textured_quad_scene(np.full((4, 4, 3), 0.5, np.float32), 8, 8,"
        " spp=1, device='cpu')\n"
        "assert FieldExtractionIntegrator('uv').renderC(sc).shape"
        " == (8, 8, 3)\n"
        "import os, tempfile\n"
        "from psdr_tpu_torch import load_string, opt, testing\n"
        "from psdr_tpu_torch.core.exr import read_exr, write_exr\n"
        "d = tempfile.mkdtemp()\n"
        "open(os.path.join(d, 'q.obj'), 'w').write('v -1 -1 0\\nv 1 -1 0"
        "\\nv 1 1 0\\nv -1 1 0\\nf 1 2 3 4\\n')\n"
        "write_exr(os.path.join(d, 't.exr'), np.full((4, 4, 3), 0.5,"
        " np.float32), compression='piz')\n"
        "assert read_exr(os.path.join(d, 't.exr')).shape == (4, 4, 3)\n"
        "sc = load_string('<scene><sensor type=\"perspective\"><transform"
        " name=\"to_world\"><lookat origin=\"0,0,3\" target=\"0,0,0\""
        " up=\"0,1,0\"/></transform><film type=\"hdrfilm\"><integer"
        " name=\"width\" value=\"8\"/><integer name=\"height\""
        " value=\"8\"/></film></sensor><bsdf type=\"diffuse\" id=\"w\">"
        "<texture name=\"reflectance\" type=\"bitmap\"><string"
        " name=\"filename\" value=\"t.exr\"/></texture></bsdf><shape"
        " type=\"obj\"><string name=\"filename\" value=\"q.obj\"/>"
        "<ref id=\"w\"/><emitter type=\"area\"><rgb name=\"radiance\""
        " value=\"1\"/></emitter></shape></scene>', base_dir=d,"
        " device='cpu')\n"
        "o = opt.Optimizer(sc, ['BSDF[id=w].reflectance'], lr=0.1)\n"
        "r = DirectIntegrator(1, 1).render_fn(sc, with_boundary=False)\n"
        "o.step(lambda p, k: r(p, k).mean(), threefry.PRNGKey(0))\n"
        "assert o.state['count'] == 1\n"
        "assert testing.run_ad(sc, DirectIntegrator(1, 1),"
        " 'mesh_transform').shape == (8, 8, 3)\n"
        "from psdr_tpu_torch.parallel.sharding import per_device_render_fn\n"
        "sc = cbox_scene(8, 8, spp=3, device='cpu')\n"
        "g = per_device_render_fn(DirectIntegrator(1, 1), sc, 2,"
        " with_boundary=False)\n"
        "p = params_from_numpy(sc.params(), device='cpu')\n"
        "assert g(p, threefry.PRNGKey(0), 1).shape == (64, 3)\n"
        "a = opt.adam(opt.exponential_decay(1e-2, 10, 0.05))\n"
        "u, st = a.update(p, a.init(p), p)\n"
        "assert st['count'] == 1 and len(opt.tree_leaves(u))"
        " == len(opt.tree_leaves(p))\n"
        "assert not any(k in ('jax', 'psdr_tpu')"
        " or k.startswith(('jax.', 'psdr_tpu.'))"
        " for k, v in sys.modules.items() if v is not None)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_no_jax_import_lines():
    """No module of the package, nor chip_smoke.py, names jax or the JAX
    package in an import statement or an ``import_module`` call."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|psdr_tpu)\b"
                     r"|import_module\(\s*['\"](jax|psdr_tpu)\b", re.M)
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 30
    hits = [str(p) for p in files if pat.search(p.read_text())]
    assert not hits


def test_cuda_wrapper_rejects_cpu_tensors():
    topo = t_bvh.build_bvh_topology(*(torch.rand(8, 3).numpy()
                                      for _ in range(3)))
    bvh = t_bvh.refit_bvh(topo, *(torch.rand(8, 3) for _ in range(3)))
    o, d = torch.rand(4, 3), torch.rand(4, 3)
    act, tmax = torch.ones(4, dtype=torch.bool), torch.full((4,), 1e30)
    with pytest.raises(ValueError, match="CUDA"):
        intersect.k1_cuda(bvh, o, d, act, tmax)


@pytest.mark.parametrize("kernel", ["k2", "k3"])
def test_k2_k3_wrappers_reject_cpu_tensors(kernel):
    tris = [torch.rand(8, 3) for _ in range(3)]
    first = (tris if kernel == "k2" else
             [t_bvh.refit_bvh(t_bvh.build_bvh_topology(
                 *(x.numpy() for x in tris)), *tris)])
    o, d = torch.rand(4, 3), torch.rand(4, 3)
    act, tmax = torch.ones(4, dtype=torch.bool), torch.full((4,), 1e30)
    with pytest.raises(ValueError, match="CUDA"):
        getattr(intersect, f"{kernel}_cuda")(*first, o, d, act, tmax)


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    """A CUDA-less toolchain is a clear error, never a silent fallback."""
    monkeypatch.setattr(intersect, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(intersect, "_LIB", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        intersect.load_library(nvcc=str(tmp_path / "no-such-nvcc"))
    assert not any(tmp_path.rglob("*.so"))


def test_profiling_times_and_traces_on_the_cpu(tmp_path, capsys):
    """``timed`` records and prints a block's wall time (``block`` on CPU
    tensors waits for nothing), ``trace`` writes a Chrome trace of the
    block, ``render_timed`` returns renderC's image and its seconds and
    prints only under ``log_level``."""
    import dataclasses

    from psdr_tpu_torch import DirectIntegrator, profiling
    from psdr_tpu_torch.testing.scenes import sphere_light_scene
    holder = {}
    with profiling.timed("block", holder) as h:
        x = h.block({"a": [torch.ones(3) * 2]})
    assert x["a"][0].sum() == 6 and holder["block"] == h.elapsed > 0
    assert "[psdr_tpu_torch] block:" in capsys.readouterr().out
    with profiling.trace(str(tmp_path / "tr")):
        torch.ones(64).cumsum(0)
    assert "aten::cumsum" in (tmp_path / "tr" / "trace.json").read_text()
    sc = sphere_light_scene(8, 8, spp=1, device="cpu")
    img, secs = profiling.render_timed(DirectIntegrator(1, 1), sc)
    assert img.shape == (8, 8, 3) and secs > 0
    assert capsys.readouterr().out == ""
    sc.opts = dataclasses.replace(sc.opts, log_level=1)
    profiling.render_timed(DirectIntegrator(1, 1), sc)
    assert "renderC" in capsys.readouterr().out
