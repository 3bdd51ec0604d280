"""The port's sums run in one fixed order (``core/segsum.py``, the default
mode of ``core/gather.py``), on the CPU, where CUDA tensors are absent:

* an op audit: a ``TorchDispatchMode`` records the ATen ops of the default
  forward and backward of small program bodies (``chip_smoke.py``'s (a)
  render, (e) backward, (g) boundary step, (i) trainer step and (j)
  guiding build) and fails on every float sum whose order an atomic
  scatter-add or a look-back scan decides on the card: ``index_add``,
  ``scatter_add``, ``scatter_reduce`` with sum or mean, an accumulating
  ``index_put``, ``embedding_dense_backward``, an accumulating ``put_``, a
  weighted ``bincount`` and a one-dimensional float ``cumsum``. The plain
  version that stands for the card's deterministic form on the CPU,
  ``segsum.prefix_sum`` (``torch.cumsum``, which adds in sequence on the
  CPU), is exempted by name. The audit is shown not to be vacuous;
* the default gather backward of a million lanes onto 2 hot rows and a
  spread of cold rows against ``psdr_tpu.core.gather.gather_rows``'s VJP
  through ``jax.vjp`` on the same numpy inputs: per row within 1e-6 of the
  sum of the row's absolute cotangents (both float32 sums, in other
  orders), and both against a float64 sum; the forward mode (jvp) bit for
  bit;
* ``segsum_plain``, the order of ``csrc/segsum.cu`` (runs added left to
  right in spans of 32 lanes, the spans' pieces scanned over blocks of 64
  spans, levels of block heads; ``test_torch_segsum.py`` pins it), against
  a float64 sum over sizes that take one or two levels, dropped keys and
  column counts above the kernel's channel group; ``index_sum`` forward,
  backward and forward mode; ``segment_sum``'s
  backward, a gather, equal to the scatter-add's VJP bit for bit;
* ``prefix_sum``'s row scan (the card's form) against a float64 running sum;
* the guiding tables of both integrators against the JAX package's
  (``psdr_tpu/integrator/direct.py:642``, ``path.py``'s indirect one).
"""
import traceback

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD
from torch.utils._python_dispatch import TorchDispatchMode

import psdr_tpu as J
import psdr_tpu_torch as T
from psdr_tpu.core import gather as j_gather
from psdr_tpu_torch.convert import params_from_numpy
from psdr_tpu_torch.core import gather as t_gather
from psdr_tpu_torch.core import segsum
from psdr_tpu_torch.core import threefry
from psdr_tpu_torch.core.bitmap import from_array
from psdr_tpu_torch.opt import Optimizer
from psdr_tpu_torch.testing import scenes as t_scenes

from scenes import cbox_scene as j_cbox
import test_torch_program as tp

torch.set_num_threads(2)

CPU = dict(device="cpu")

# functions whose ops stand for the card's deterministic form on the CPU
_EXEMPT = {"prefix_sum"}


class AtomicSumAudit(TorchDispatchMode):
    """Records, by op and caller, every ATen op whose float sum an atomic
    scatter-add or a look-back scan orders on the card."""

    def __init__(self):
        super().__init__()
        self.found = {}

    @staticmethod
    def _denied(name, args, kwargs):
        kwargs = kwargs or {}
        if name in ("index_add", "scatter_add", "embedding_dense_backward"):
            return True
        if name == "scatter_reduce":
            reduce = args[4] if len(args) > 4 else kwargs.get("reduce")
            return reduce in ("sum", "mean")
        if name in ("index_put", "_index_put_impl", "put"):
            return bool(args[3] if len(args) > 3
                        else kwargs.get("accumulate"))
        if name == "bincount":
            return (args[1] if len(args) > 1
                    else kwargs.get("weights")) is not None
        if name == "cumsum":
            x, dim = args[0], args[1]
            return x.is_floating_point() and x.numel() == x.shape[dim]
        return False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__.rstrip("_")
        if self._denied(name, args, kwargs):
            stack = traceback.extract_stack()
            if not any(f.name in _EXEMPT and "psdr_tpu_torch" in f.filename
                       for f in stack):
                site = [f"{f.filename.rsplit('psdr_tpu_torch/', 1)[-1]}:"
                        f"{f.lineno}" for f in stack
                        if "psdr_tpu_torch" in f.filename][-2:]
                key = (name, tuple(site))
                self.found[key] = self.found.get(key, 0) + 1
        return func(*args, **(kwargs or {}))


def _trainer_body():
    """(i): a trainer step's value and gradient and its update: the
    textured cbox (16 x 16, spp 2, every boundary term), ``Optimizer`` on
    the occluder's vertices, one ``step``."""
    sc = t_scenes.cbox_scene(16, 16, spp=2, sppe=2, sppse=4,
                             occluder_subdiv=3, **CPU)
    sc.meshes[0].bsdf_id = sc.add_bsdf(
        T.Diffuse(from_array(t_scenes.checker_texture(16))), "floor")
    integ = T.DirectIntegrator(1, 1)
    with torch.no_grad():
        target = integ.render_fn(sc, with_boundary=False, detached=True)(
            params_from_numpy(sc.params(), **CPU), threefry.PRNGKey(9))
    sc.meshes[5].vertex_positions = t_scenes.flagship_deform(
        np.asarray(sc.meshes[5].vertex_positions))
    opt = Optimizer(sc, ["Mesh[5].vertex_positions"], lr=1e-2)
    render = integ.render_fn(sc, with_boundary=True)

    def step():
        return opt.step(lambda p, k: torch.mean((render(p, k) - target) ** 2),
                        threefry.PRNGKey(0))
    return step


def _audit_body(case, monkeypatch):
    """``case``'s body as a function of no arguments (after its warm-up)."""
    if case == "a":
        prog, args, _ = tp._body("a")
        return lambda: prog.fn(*args)
    if case == "i":
        return _trainer_body()
    name = {"e": "direct backward", "g": "boundary step",
            "j": "guiding build"}[case]
    prog, args, _ = tp._grad_body(name, monkeypatch)

    def run():
        with torch.enable_grad() if prog.grad else torch.no_grad():
            return prog.fn(*args)
    return run


@pytest.mark.parametrize("case", ["a", "e", "g", "i", "j"])
def test_default_path_has_no_atomic_float_sum(case, monkeypatch):
    """With no environment variable set, the forward and backward of
    program body ``case`` (a: ``render_program`` of the cbox, 32 x 32, on
    the BVH; e: ``grad_program``'s backward; g: with every boundary term,
    the secondary wavefront compacted; i: a trainer step through the
    textured floor; j: a guiding build) run no op whose float sum an
    atomic scatter-add or a look-back scan orders on the card."""
    body = _audit_body(case, monkeypatch)
    with AtomicSumAudit() as audit:
        out = body()
    assert out is not None
    assert audit.found == {}, audit.found


def test_audit_finds_an_atomic_sum():
    """The audit is not vacuous: the named baseline ``scatter`` (an
    ``index_add_``), an accumulating ``index_put`` (``table[idx]``'s
    backward) and a 1-D float ``torch.cumsum`` outside ``prefix_sum`` are
    found; the default gather is not."""
    table = torch.randn(7, 3, requires_grad=True)
    idx = torch.tensor([0, 3, 3, 6, 0])
    cases = [lambda: t_gather.gather_rows(table, idx, "scatter"),
             lambda: table[idx]]
    for make in cases:
        with AtomicSumAudit() as audit:
            torch.autograd.grad(make().sum(), table)
        assert audit.found, make
    with AtomicSumAudit() as audit:
        torch.cumsum(torch.rand(9), 0)
    assert audit.found
    with AtomicSumAudit() as audit:
        torch.autograd.grad(t_gather.gather_rows(table, idx).sum(), table)
        segsum.prefix_sum(torch.rand(9))
    assert audit.found == {}


# -- the gather backward against JAX's ------------------------------------------

def test_default_gather_backward_of_hot_rows_matches_jax():
    """2^20 lanes: half onto row 0, a quarter onto row 1, the rest spread
    over 998 cold rows, 3 columns. The default gather's table gradient
    against ``jax.vjp`` of the JAX package's ``gather_rows`` (native) on
    the same numpy inputs: per row within 1e-6 of the row's sum of
    absolute cotangents (float32 sums in two orders), and nearer a float64
    sum than that bound; the forward values and the forward-mode tangents
    bit for bit."""
    rng = np.random.default_rng(12)
    n, F = 1 << 20, 1000
    idx = np.concatenate([np.zeros(n // 2), np.ones(n // 4),
                          rng.integers(2, F, n - n // 2 - n // 4)])
    idx = rng.permutation(idx).astype(np.int32)
    table = rng.normal(size=(F, 3)).astype(np.float32)
    ct = rng.normal(size=(n, 3)).astype(np.float32)
    out_j, vjp_j = jax.vjp(lambda t: j_gather.gather_rows(
        t, jnp.asarray(idx), "native"), jnp.asarray(table))
    (g_j,) = vjp_j(jnp.asarray(ct))
    tt = torch.tensor(table, requires_grad=True)
    out_t = t_gather.gather_rows(tt, torch.from_numpy(idx))
    np.testing.assert_array_equal(out_t.detach().numpy(), np.asarray(out_j))
    (g_t,) = torch.autograd.grad(out_t, tt, torch.from_numpy(ct))
    exact = np.zeros((F, 3))
    np.add.at(exact, idx, ct.astype(np.float64))
    scale = np.zeros((F, 3))
    np.add.at(scale, idx, np.abs(ct).astype(np.float64))
    bound = 1e-6 * scale
    g_t, g_j = g_t.numpy(), np.asarray(g_j)
    assert (np.abs(g_t - g_j) <= bound).all()
    assert (np.abs(g_t - exact) <= bound).all()
    assert (np.abs(g_j - exact) <= bound).all()
    tan = rng.normal(size=(F, 3)).astype(np.float32)
    _, jvp_j = jax.jvp(lambda t: j_gather.gather_rows(
        t, jnp.asarray(idx), "native"), (jnp.asarray(table),),
        (jnp.asarray(tan),))
    with fwAD.dual_level():
        dual = fwAD.make_dual(torch.from_numpy(table), torch.from_numpy(tan))
        jvp_t = fwAD.unpack_dual(t_gather.gather_rows(
            dual, torch.from_numpy(idx))).tangent
    np.testing.assert_array_equal(jvp_t.numpy(), np.asarray(jvp_j))


@pytest.mark.parametrize("n,rows,c", [(1, 3, 1), (255, 40, 3), (257, 5, 45),
                                      (65537, 7, 2), (70000, 2, 33)])
def test_segsum_plain_sums_every_row(n, rows, c):
    """``segsum_plain`` (the kernel's order) against a float64 sum: within
    4e-7 of each row's sum of absolute values, over one or two levels of
    block heads, keys of -1 dropped, and more columns than the kernel's
    channel group of 32; the sorted keys of ``sort_keys``."""
    rng = np.random.default_rng(n)
    idx = torch.as_tensor(rng.integers(-1, rows, n))
    vals = torch.as_tensor(rng.normal(size=(n, c)).astype(np.float32))
    keys, order = segsum.sort_keys(idx, rows)
    assert bool((keys[1:] >= keys[:-1]).all())
    got = segsum.segsum_plain(keys, vals, rows, order).double().numpy()
    ok = (idx >= 0).numpy()
    exact = np.zeros((rows, c))
    np.add.at(exact, idx.numpy()[ok], vals.double().numpy()[ok])
    scale = np.zeros((rows, c))
    np.add.at(scale, idx.numpy()[ok], np.abs(vals.double().numpy()[ok]))
    assert (np.abs(got - exact) <= 4e-7 * scale + 1e-30).all()


def test_index_sum_forward_backward_and_jvp():
    """``index_sum`` against ``index_add`` with negatives dropped: values
    within float rounding (an order of adds apart), the backward a gather of
    the cotangent (0 on dropped lanes) bit for bit, the forward mode the
    same sum of the tangents."""
    rng = np.random.default_rng(3)
    idx = torch.as_tensor(rng.integers(-1, 50, 3000))
    v = torch.as_tensor(rng.normal(size=(3000, 3)).astype(np.float32))
    v.requires_grad_(True)
    out = segsum.index_sum(v, idx, 50)
    keep = idx >= 0
    want = torch.zeros(50, 3).index_add(0, idx[keep], v.detach()[keep])
    torch.testing.assert_close(out.detach(), want, rtol=1e-5, atol=1e-5)
    g = torch.as_tensor(rng.normal(size=(50, 3)).astype(np.float32))
    (gv,) = torch.autograd.grad(out, v, g)
    want_g = torch.where(keep[:, None], g[idx.clamp(min=0)], 0.0)
    assert torch.equal(gv, want_g)
    tan = torch.as_tensor(rng.normal(size=(3000, 3)).astype(np.float32))
    with fwAD.dual_level():
        dual = fwAD.make_dual(v.detach(), tan)
        t_out = fwAD.unpack_dual(segsum.index_sum(dual, idx, 50)).tangent
    assert torch.equal(t_out, segsum.index_sum(tan, idx, 50))


def test_segment_sum_backward_is_a_gather():
    """``segment_sum``'s backward gathers each position's cotangent row:
    equal bit for bit to the VJP of the scatter-add it replaces, and its
    forward-mode tangent to the same sum of the tangents."""
    rng = np.random.default_rng(4)
    index = rng.integers(0, 30, 400)
    table = torch.as_tensor(t_gather.segment_table(index, 30))
    v = torch.as_tensor(rng.normal(size=(400, 3)).astype(np.float32))
    v.requires_grad_(True)
    g = torch.as_tensor(rng.normal(size=(30, 3)).astype(np.float32))
    (got,) = torch.autograd.grad(t_gather.segment_sum(v, table), v, g)
    (want,) = torch.autograd.grad(torch.zeros(30, 3).index_add(
        0, torch.as_tensor(index), v), v, g)
    assert torch.equal(got, want)
    tan = torch.as_tensor(rng.normal(size=(400, 3)).astype(np.float32))
    with fwAD.dual_level():
        out = t_gather.segment_sum(fwAD.make_dual(v.detach(), tan), table)
        assert torch.equal(fwAD.unpack_dual(out).tangent,
                           t_gather.segment_sum(tan, table))


@pytest.mark.parametrize("n", [1, 1000, 1025, 70001])
def test_prefix_sum_row_scan_matches_a_running_sum(n):
    """The card's form of ``prefix_sum`` (rows of ``SCAN_ROW``, the rows'
    totals carried; run here on CPU tensors) against a float64 running
    sum: within 2e-7 of the total of the absolute values."""
    x = torch.as_tensor(np.random.default_rng(n).uniform(
        0.0, 1.0, n).astype(np.float32))
    got = segsum._row_scan(x).double().numpy()
    want = np.cumsum(x.double().numpy())
    assert got.shape == (n,)
    assert np.abs(got - want).max() <= 2e-7 * want[-1]
    assert torch.equal(segsum.prefix_sum(x), torch.cumsum(x, 0))


# -- guiding against JAX --------------------------------------------------------

@pytest.mark.parametrize("kind", ["direct", "indirect"])
def test_guiding_table_matches_jax(kind):
    """The cell masses of ``preprocess_secondary_edges`` ((8, 3, 3, 4), 3
    rounds) and ``PathTracer.preprocess_indirect_edges`` ((4, 4, 4, 2), 2
    rounds), whose per-cell sums run in one fixed order, against the JAX
    package's on the same scene: rtol 1e-4, atol 1e-4 of the largest cell
    (a cell that holds one grazing sample), as
    ``tests/test_torch_boundary.py`` holds the direct one."""
    kw = dict(width=16, height=16, spp=2, sppse=4, occluder_subdiv=3)
    js = j_cbox(**kw)
    ts = t_scenes.cbox_scene(**kw, **CPU)
    if kind == "direct":
        ji, ti = J.DirectIntegrator(1, 1), T.DirectIntegrator(1, 1)
        for integ, sc in ((ji, js), (ti, ts)):
            integ.preprocess_secondary_edges(sc, 0, (8, 3, 3, 4), nrounds=3,
                                             seed=7)
    else:
        ji, ti = J.PathTracer(max_depth=2), T.PathTracer(max_depth=2)
        for integ, sc in ((ji, js), (ti, ts)):
            integ.preprocess_indirect_edges(sc, 0, (4, 4, 4, 2), nrounds=2,
                                            seed=7)
    table = "warpper" if kind == "direct" else "ind_warpper"
    mj = np.asarray(getattr(ji, table)[0].distrb.pmf)
    mt = getattr(ti, table)[0].distrb.pmf.numpy()
    assert mt.shape == mj.shape and (mt > 0).any()
    np.testing.assert_allclose(mt, mj, rtol=1e-4, atol=1e-4 * mj.max())


def test_segsum_wrapper_rejects_cpu_tensors():
    """The kernel's wrapper launches or raises: CPU tensors take the plain
    version through ``segment_sum_sorted``, never the wrapper."""
    keys, order = segsum.sort_keys(torch.tensor([2, 0, 2]), 3)
    with pytest.raises(ValueError, match="CUDA"):
        segsum.segsum_cuda(keys, torch.ones(3, 2), 3, order)
    out = segsum.segment_sum_sorted(keys, torch.ones(3, 2), 3, order)
    assert torch.equal(out, torch.tensor([[1.0, 1.0], [0.0, 0.0],
                                          [2.0, 2.0]]))
