"""The port imports without jax, and K1's CUDA wrapper refuses what it
cannot run instead of falling back."""
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
    """Every module of the package imports with jax blocked."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import psdr_tpu_torch\n"
        "for m in pkgutil.walk_packages(psdr_tpu_torch.__path__,"
        " 'psdr_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert not any(k in ('jax', 'psdr_tpu')"
        " or k.startswith(('jax.', 'psdr_tpu.'))"
        " for k, v in sys.modules.items() if v is not None)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_no_jax_import_lines():
    pat = re.compile(r"^\s*(import|from)\s+(jax|psdr_tpu)\b", re.M)
    hits = [str(p) for p in PKG.rglob("*.py") if pat.search(p.read_text())]
    assert not hits


def test_cuda_wrapper_rejects_cpu_tensors():
    topo = t_bvh.build_bvh_topology(*(torch.rand(8, 3).numpy()
                                      for _ in range(3)))
    bvh = t_bvh.refit_bvh(topo, *(torch.rand(8, 3) for _ in range(3)))
    o, d = torch.rand(4, 3), torch.rand(4, 3)
    act, tmax = torch.ones(4, dtype=torch.bool), torch.full((4,), 1e30)
    with pytest.raises(ValueError, match="CUDA"):
        intersect.k1_cuda(bvh, o, d, act, tmax)


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    """A CUDA-less toolchain is a clear error, never a silent fallback."""
    monkeypatch.setattr(intersect, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(intersect, "_LIB", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        intersect.load_library(nvcc=str(tmp_path / "no-such-nvcc"))
    assert not any(tmp_path.rglob("*.so"))
