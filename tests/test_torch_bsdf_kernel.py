"""The materials kernel (``csrc/bsdf.cu``) against the BSDF dispatch's
tensor code (``eval_bsdf_plain``, ``pdf_bsdf_plain``, ``sample_bsdf_plain``).

On the CPU: the kernel's source compiled by g++ behind a prelude that
stands in for CUDA, launched through ``bsdf/kernel.py``'s own wrapper on
CPU tensors, in each mode, for a list of four diffuse BSDFs and a rough
conductor, with constant and textured (8x16) maps, masked lanes, lanes of
id -1 and horizon-grazing, vertical and degenerate directions. Two of the
kernel's operations round otherwise in PyTorch's CPU kernels than in its
CUDA ones: the square root (a vector library routine here, off by one unit
in the last place on 0.6% of inputs; IEEE on the card and in the kernel)
and sinf and cosf (SLEEF here, the C library in the g++ build). So on the
CPU: eval and pdf bit for bit on the diffuse lanes, which take neither,
and within VALUE_ULPS units in the last place on the rough conductor's;
sample's wo within WO_ULPS units in the last place of 1 (a unit vector's
component), and its pdf and valid against the tensor code's at the
kernel's own wo, as eval and pdf. Which lanes are zero is bit for bit
everywhere. Also: the descriptor table built from a ``params_list`` and
its refusals, and the dispatch rule: CPU lanes take the tensor code and
launch nothing; a call is recorded (and takes the tensor code on the card)
where an input requires grad with grad enabled or carries a forward-mode
tangent, ``no_grad`` or not.

On the card (``gpu``; skips without CUDA): the built kernel against the
tensor code on the card, every output bit for bit, at 2^16 lanes, one
launch a call, strided inputs as contiguous ones; and ``launches.bsdf``
counting every BSDF call of a render program's forward and none of a
gradient program's differentiable calls, eager and replayed; calls on
dual inputs (forward mode) taking the tensor code, tangents and all, and
``run_ad``'s derivative image on the card against the CPU's. Imports no
jax:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_bsdf_kernel.py
"""
import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from psdr_tpu_torch import profiling
from psdr_tpu_torch.accel import intersect
from psdr_tpu_torch.bsdf import (eval_bsdf, eval_bsdf_plain, kernel,
                                 pdf_bsdf, pdf_bsdf_plain, recorded,
                                 sample_bsdf, sample_bsdf_plain)
from psdr_tpu_torch.core.records import Intersection

# On the CPU (module docstring): a value that passes through a square root
# against the tensor code's, in units in its last place (2^-23 of it; the
# rough conductor's eval and pdf read up to 5.2 over three seeds); sample's
# wo, in units in the last place of 1.0 (sinf, cosf and square roots a unit
# off there, carried on by the cosine hemisphere's z, the visible-normal
# slope's 1 / (sin y + cos z) near the horizon and the two normalizations:
# up to 420)
VALUE_ULPS = 16
WO_ULPS = 1024
KINDS = ("diffuse", "diffuse", "diffuse", "diffuse", "roughconductor")
_PLAIN = {kernel.EVAL: eval_bsdf_plain, kernel.PDF: pdf_bsdf_plain,
          kernel.SAMPLE: sample_bsdf_plain}
_MODES = {"eval": kernel.EVAL, "pdf": kernel.PDF, "sample": kernel.SAMPLE}


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _directions(rng, n):
    """(n, 3) float32 directions: uniform over the sphere, with runs of
    horizon-grazing ones (z = 0, -0, 1e-8, 1e-4, -1e-6), nearly vertical
    ones (|xy| from 1e-4 to 1e-1, across ggx_sample's 4e-5 cut-off on
    |xy|^2), zero vectors and unnormalized tiny ones (norm 1e-12, under
    normalize's 1e-20 clamp on the squared norm)."""
    d = _unit(rng.standard_normal((n, 3)))
    k = n // 16
    z = np.array([0.0, -0.0, 1e-8, 1e-4, -1e-6])[rng.integers(0, 5, k)]
    xy = _unit(rng.standard_normal((k, 2))) * np.sqrt(1.0 - z * z)[:, None]
    d[:k] = np.concatenate([xy, z[:, None]], axis=1)
    eps = 10.0 ** rng.uniform(-4, -1, k)
    phi = rng.uniform(0, 2 * np.pi, k)
    d[k:2 * k] = _unit(np.stack([eps * np.cos(phi), eps * np.sin(phi),
                                 np.ones(k)], axis=1))
    d[2 * k:2 * k + 8] = 0.0
    d[2 * k + 8:2 * k + 64] *= 1e-12
    return d.astype(np.float32)


def _lanes(n, seed, device="cpu"):
    """Intersection (wi, uv, bsdf_id), wo, sample3 and active for n lanes:
    ids over the list and -1, 15% of lanes masked; among the wo, runs of
    -wi (a zero half vector), wi itself and wi's mirror image (the
    specular peak), and a run of pairs both above the horizon by 1e-5 to
    1e-1 (a nearly horizontal half vector, across GGX's 1e-5 cut-off on
    D cos); uv over [-2, 3] with runs at 0, 1, -1e-9 and 0.9999999;
    samples with runs at 0 and 0.5 (the concentric map's origin and its
    axes)."""
    rng = np.random.default_rng(seed)
    wi = _directions(rng, n)
    wo = _directions(rng, n)
    k = n // 16
    wo[3 * k:4 * k] = -wi[3 * k:4 * k]
    wo[4 * k:5 * k] = wi[4 * k:5 * k]
    wo[5 * k:6 * k] = wi[5 * k:6 * k] * np.float32([-1, -1, 1])
    for d in (wi, wo):
        z = 10.0 ** rng.uniform(-5, -1, k)
        xy = _unit(rng.standard_normal((k, 2))) * np.sqrt(1 - z * z)[:, None]
        d[6 * k:7 * k] = np.concatenate([xy, z[:, None]], axis=1)
    uv = rng.uniform(-2, 3, (n, 2)).astype(np.float32)
    uv[:k] = np.float32([0.0, 1.0, -1e-9, 0.9999999])[rng.integers(0, 4,
                                                                 (k, 2))]
    s3 = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    s3[k:2 * k, :2] = np.float32([0.0, 0.5])[rng.integers(0, 2, (k, 2))]
    ids = rng.integers(-1, len(KINDS), n).astype(np.int32)
    active = rng.uniform(size=n) < 0.85
    t = {k_: torch.from_numpy(v).to(device) for k_, v in (
        ("wi", wi), ("wo", wo), ("uv", uv), ("s3", s3), ("ids", ids),
        ("active", active))}
    its = Intersection(valid=None, t=None, p=None, n=None, sh_frame=None,
                       uv=t["uv"], wi=t["wi"], J=None, mesh_id=None,
                       tri_id=None, bsdf_id=t["ids"], emitter_id=None)
    return its, t["wo"], t["s3"], t["active"]


def _params(textured, device="cpu", seed=3):
    """Four diffuse BSDFs (white, red, green and the light's black) and a
    rough conductor (gold, alphas 0.25 and 0.1), each map a constant or,
    with ``textured``, an 8x16 image: the conductor's alphas and specular
    reflectance of one channel (read for all three), the rest of three."""
    rng = np.random.default_rng(seed)

    def tex(value, c, lo, hi):
        if textured:
            return rng.uniform(lo, hi, (8, 16, c)).astype(np.float32)
        return np.broadcast_to(np.float32(value), (1, 1, c)).copy()

    maps = [{"reflectance": tex(v, 3, 0.0, 1.0)} for v in (
        (0.8, 0.8, 0.8), (0.6, 0.05, 0.05), (0.1, 0.5, 0.1), (0.0, 0.0, 0.0))]
    maps.append({"alpha_u": tex(0.25, 1, 0.05, 0.6),
                 "alpha_v": tex(0.1, 1, 0.05, 0.6),
                 "eta": tex((0.2004, 0.9240, 1.1022), 3, 0.1, 1.5),
                 "k": tex((3.9129, 2.4528, 2.1421), 3, 1.0, 4.0),
                 "specular_reflectance": tex(1.0, 1, 0.5, 1.0)})
    return tuple({k: torch.from_numpy(v).to(device) for k, v in m.items()}
                 for m in maps)


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _assert_ulps(got, want, ulps, what, exact=None):
    """Zero where ``want`` is zero, NaN where it is NaN, within ``ulps``
    units in its last place elsewhere, and bit for bit on the lanes
    ``exact``."""
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert torch.equal(got == 0, want == 0), f"{what}: zero lanes differ"
    assert torch.equal(torch.isnan(got), torch.isnan(want)), what
    live = (want != 0) & torch.isfinite(want)
    err = ((got - want).abs() / want.abs())[live] / 2.0 ** -23
    assert err.numel() == 0 or float(err.max()) <= ulps, (what, float(
        err.max()))
    if exact is not None:
        _assert_bit_equal(got[exact], want[exact], f"{what}, exact lanes")


def _assert_bit_equal(got, want, what):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    bad = _bits(got) != _bits(want)
    if bad.ndim > 1:
        bad = bad.any(-1)
    assert not bool(bad.any()), (
        f"{what}: {int(bad.sum())} lanes differ, first "
        f"{torch.nonzero(bad)[:5].flatten().tolist()}")


# -- the kernel's arithmetic on the CPU ----------------------------------------

_PRELUDE = r"""
#include <math.h>
#include <stdint.h>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(n)
#define __grid_constant__
typedef void* cudaStream_t;
struct Index { unsigned x; };
static Index blockIdx, threadIdx;
inline int cudaGetLastError() { return 0; }
// PyTorch's CPU kernels, which the tensor code runs here: rsqrt is one over
// an IEEE square root, and torch.sum over three elements adds them in order
inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }
inline float __fsqrt_rn(float x) { return sqrtf(x); }
#define PSDR_SUM3(a0, a1, a2) ((((a0) + (a1)) + (a2)) + 0.0f)
#define LAUNCH(grid, block, kernel, ...)                          \
  do {                                                            \
    for (unsigned b_ = 0; b_ < (grid); ++b_)                      \
      for (unsigned t_ = 0; t_ < (block); ++t_) {                 \
        blockIdx.x = b_;                                          \
        threadIdx.x = t_;                                         \
        kernel(__VA_ARGS__);                                      \
      }                                                           \
  } while (0)
"""


@pytest.fixture(scope="module")
def bsdf_host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ unavailable")
    src = (intersect._CSRC / "bsdf.cu").read_text()
    src = src.replace("#include <cuda_runtime.h>", _PRELUDE)
    src, launches = re.subn(
        r"([\w<>]+?)<<<(.+?), (\w+), 0, (.+?)>>>\(\s*",
        r"LAUNCH(\2, \3, \1, ", src, flags=re.S)
    assert launches == 3
    d = tmp_path_factory.mktemp("bsdf_host")
    (d / "bsdf.cpp").write_text(src)
    subprocess.run(["g++", "-std=c++17", "-O2", "-ffp-contract=off",
                    "-shared", "-fPIC", "-o", str(d / "libbsdf.so"),
                    str(d / "bsdf.cpp")], check=True)
    lib = ctypes.CDLL(str(d / "libbsdf.so"))
    lib.psdr_bsdf.argtypes = [ctypes.c_int32] + [ctypes.c_void_p] * 4
    lib.psdr_bsdf.restype = ctypes.c_int32
    return lib


@pytest.fixture
def host_kernel(bsdf_host_lib, monkeypatch):
    """``kernel.launch`` on CPU tensors, into the g++ build."""
    def launch(name, fn, *args, dev):
        assert name == "bsdf" and dev.type == "cpu"
        assert fn(*args, None) == 0
    monkeypatch.setattr(intersect, "load_library", lambda: bsdf_host_lib)
    monkeypatch.setattr(intersect, "_launch", launch)
    return kernel.launch


def _sample_checks(got, want, its, params, active):
    """sample on the CPU: wo within WO_ULPS of the tensor code's; valid,
    and the pdf the dispatch's blend keeps (the kind's pdf at its wo, valid
    or not), against the tensor code's at the kernel's own wo."""
    ulps = ((got.wo - want.wo).abs() / 2.0 ** -23).nan_to_num(0.0)
    assert float(ulps.max()) <= WO_ULPS, float(ulps.max())
    assert torch.equal(torch.isnan(got.wo), torch.isnan(want.wo))
    lane = active & (its.bsdf_id >= 0)
    diffuse = lane & (its.bsdf_id < 4)
    conductor = lane & (its.bsdf_id == 4)
    # the diffuse pdf: InvPi * z, InvPi the Python number rounded to float32
    pdf = torch.where(diffuse, float(np.float32(1.0 / np.pi)) * got.wo[:, 2],
                      torch.zeros_like(got.pdf))
    pdf = torch.where(conductor, pdf_bsdf_plain(
        KINDS, params, its, got.wo, conductor), pdf)
    _assert_ulps(got.pdf, pdf, VALUE_ULPS, "sample pdf at the kernel's wo",
                 exact=~conductor)
    valid = lane & (its.wi[:, 2] > 0.0)
    valid = valid & ~(conductor & ((pdf == 0.0) | (got.wo[:, 2] <= 0.0)))
    assert torch.equal(got.valid, valid)
    assert not bool(got.wo[~lane].any()) and not bool(got.pdf[~lane].any())


@pytest.mark.parametrize("textured", [False, True])
@pytest.mark.parametrize("mode", ["eval", "pdf", "sample"])
def test_bsdf_cu_equals_the_tensor_code_on_the_cpu(host_kernel, mode,
                                                   textured):
    """One launch of each mode on 4,099 lanes of four diffuse BSDFs and a
    rough conductor against the tensor code: eval and pdf bit for bit on
    the diffuse lanes and within VALUE_ULPS on the conductor's; sample as
    ``_sample_checks`` says."""
    its, wo, s3, active = _lanes(4099, seed=11)
    params = _params(textured)
    m = _MODES[mode]
    x = s3 if m == kernel.SAMPLE else wo
    got = host_kernel(m, KINDS, params, its, x, active)
    want = _PLAIN[m](KINDS, params, its, x, active)
    if m == kernel.SAMPLE:
        _sample_checks(got, want, its, params, active)
    else:
        _assert_ulps(got, want, VALUE_ULPS, mode, exact=its.bsdf_id != 4)
        assert bool((got[its.bsdf_id == 4] != 0).any())


def test_bsdf_cu_reads_strided_and_batched_lanes_on_the_cpu(host_kernel):
    """Inputs that are views with row and column strides (slices of wider
    tensors, a transposed uv) and lanes of two dimensions give what
    contiguous (N,) lanes give."""
    its, wo, s3, active = _lanes(1030, seed=5)
    params = _params(True)

    def strided(x):
        wide = torch.zeros((x.shape[0], 2 * x.shape[1] + 1), dtype=x.dtype)
        wide[:, 1::2] = x
        return wide[:, 1::2]

    uv_t = its.uv.t().contiguous().t()
    s_its = its._replace(wi=strided(its.wi), uv=uv_t,
                         bsdf_id=torch.stack([its.bsdf_id] * 2, 1)[:, 1])
    for m, x in ((kernel.EVAL, wo), (kernel.PDF, wo), (kernel.SAMPLE, s3)):
        want = host_kernel(m, KINDS, params, its, x, active)
        got = host_kernel(m, KINDS, params, s_its, strided(x), active)
        b_its = its._replace(wi=its.wi.reshape(2, -1, 3),
                             uv=its.uv.reshape(2, -1, 2),
                             bsdf_id=its.bsdf_id.reshape(2, -1))
        batched = host_kernel(m, KINDS, params, b_its, x.reshape(2, -1, 3),
                              active.reshape(2, -1))
        for g, b, w in zip(*(v if m == kernel.SAMPLE else (v,)
                             for v in (got, batched, want))):
            _assert_bit_equal(g, w, f"strided, mode {m}")
            _assert_bit_equal(b.reshape(w.shape), w, f"batched, mode {m}")


# -- the descriptor table and the dispatch rule ----------------------------------

def test_descriptor_table_of_a_params_list():
    """Kind codes, map pointers, shapes and channels, the textured flag,
    and the count, for constant and textured lists."""
    cpu = torch.device("cpu")
    for textured in (False, True):
        params = _params(textured)
        t = kernel.table(KINDS, params, cpu)
        assert t.count == len(KINDS)
        for entry, kind, p in zip(t.bsdf, KINDS, params):
            code, names = kernel.KINDS[kind]
            assert entry.kind == code
            assert entry.textured == textured
            for j, name in enumerate(names):
                h, w, c = p[name].shape
                assert entry.map[j].data == p[name].data_ptr()
                assert (entry.map[j].h, entry.map[j].w) == (h, w)
                assert entry.channels[j] == c
    assert kernel.table((), (), cpu).count == 0


@pytest.mark.parametrize("case", ["33 bsdfs", "kind", "1x16", "2 channels",
                                  "float64", "strided", "device"])
def test_descriptor_table_refuses_what_the_kernel_cannot_read(case):
    """A list over the table's capacity raises naming its length; so do an
    unknown kind and a map the kernel cannot read. Nothing falls back."""
    kinds, params = list(KINDS), list(_params(True))
    refl = params[0]["reflectance"]
    err, match = ValueError, None
    if case == "33 bsdfs":
        kinds, params = ["diffuse"] * 33, [params[0]] * 33
        match = "at most 32 BSDFs; the list has 33"
    elif case == "kind":
        kinds[1], err, match = "dielectric", NotImplementedError, "dielectric"
    elif case == "1x16":
        params[0] = {"reflectance": refl[:1]}
    elif case == "2 channels":
        params[0] = {"reflectance": refl[..., :2].contiguous()}
    elif case == "float64":
        params[0] = {"reflectance": refl.double()}
    elif case == "strided":
        params[0] = {"reflectance": refl[:, ::2]}
    elif case == "device":
        params[0] = {"reflectance": refl.to("meta")}
    with pytest.raises(err, match=match):
        kernel.table(kinds, params, torch.device("cpu"))


def _dual_inputs(params, its, x, where):
    """The inputs with a tangent of ones on ``where``: "wi", "x" or a map
    of the rough conductor ("map"). Call inside a dual level."""
    def dual(t):
        return fwAD.make_dual(t, torch.ones_like(t))
    if where == "wi":
        its = its._replace(wi=dual(its.wi))
    elif where == "x":
        x = dual(x)
    else:
        params = params[:-1] + ({**params[-1],
                                 "alpha_u": dual(params[-1]["alpha_u"])},)
    return params, its, x


def _tangents(r):
    return [fwAD.unpack_dual(t).tangent for t in (
        (r.valid, r.pdf, r.wo) if isinstance(r, tuple) else (r,))]


@pytest.mark.parametrize("grad", [False, True, "forward"])
def test_cpu_lanes_take_the_tensor_code(grad, monkeypatch):
    """CPU lanes, with inputs that require grad, carry forward-mode
    tangents or neither, take the tensor code: the entry points equal it,
    tangents too, load no kernel library, and add nothing to
    ``launches.bsdf`` or ``bsdf.plain``."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU call reached the kernel library")

    monkeypatch.setattr(intersect, "load_library", refuse)
    its, wo, s3, active = _lanes(256, seed=2)
    params = _params(True)
    if grad is True:
        params = tuple({k: v.requires_grad_() for k, v in p.items()}
                       for p in params)
        its = its._replace(wi=its.wi.requires_grad_())
    before = profiling.counters()
    with fwAD.dual_level():
        for fn, plain, x in ((eval_bsdf, eval_bsdf_plain, wo),
                             (pdf_bsdf, pdf_bsdf_plain, wo),
                             (sample_bsdf, sample_bsdf_plain, s3)):
            args = ((params, its, x) if grad != "forward"
                    else _dual_inputs(params, its, x, "wi"))
            got = fn(KINDS, *args, active)
            want = plain(KINDS, *args, active)
            for g, w in zip(*((got, want) if fn is sample_bsdf
                              else ((got,), (want,)))):
                assert torch.equal(_bits(g.detach()), _bits(w.detach()))
                assert g.requires_grad == w.requires_grad
            for g, w in zip(_tangents(got), _tangents(want)):
                assert (g is None) == (w is None)
                assert g is None or torch.equal(_bits(g), _bits(w))
    after = profiling.counters()
    for name in ("launches.bsdf", "bsdf.plain"):
        assert after.get(name, 0) == before.get(name, 0)


@pytest.mark.parametrize("case, want", [
    ("plain", False), ("requires grad", True),
    ("requires grad, no_grad", False), ("dual level, no tangent", False),
    ("tangent on wi", True), ("tangent on wi, no_grad", True),
    ("tangent on the sample", True), ("tangent on a map, no_grad", True)])
def test_a_call_is_recorded_under_either_mode_of_autograd(case, want):
    """``recorded`` (which sends a call on the card to the tensor code):
    an input requiring grad counts with grad enabled only; a forward-mode
    tangent on any input counts under ``no_grad`` too, since that leaves
    the tangents on."""
    its, _, s3, _ = _lanes(64, seed=4)
    params = _params(False)
    if case.startswith("requires grad"):
        its = its._replace(wi=its.wi.requires_grad_())
    with fwAD.dual_level():
        if case.startswith("tangent"):
            where = {"wi,": "wi", "wi": "wi", "the": "x",
                     "a": "map"}[case.split()[2]]
            params, its, s3 = _dual_inputs(params, its, s3, where)
        if case.endswith("no_grad"):
            with torch.no_grad():
                assert recorded(params, its, s3) is want
        else:
            assert recorded(params, its, s3) is want


# -- on the card ----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("textured", [False, True])
@pytest.mark.parametrize("mode", ["eval", "pdf", "sample"])
def test_bsdf_kernel_equals_the_tensor_code_on_the_card(cuda, mode,
                                                        textured):
    """The entry point on 2^16 lanes on the card (one launch of the
    kernel, no call of the tensor code) against the tensor code on the
    card, every output bit for bit; strided views of the inputs give the
    same."""
    its, wo, s3, active = _lanes(1 << 16, seed=7, device=cuda)
    params = _params(textured, device=cuda)
    entry = {"eval": eval_bsdf, "pdf": pdf_bsdf, "sample": sample_bsdf}[mode]
    m = _MODES[mode]
    x = s3 if m == kernel.SAMPLE else wo
    before = profiling.counters()
    got = entry(KINDS, params, its, x, active)
    after = profiling.counters()
    assert after["launches.bsdf"] - before.get("launches.bsdf", 0) == 1
    assert after.get("bsdf.plain", 0) == before.get("bsdf.plain", 0)
    want = _PLAIN[m](KINDS, params, its, x, active)

    def columns(t):      # the same values, stored column by column
        return t.t().contiguous().t()
    again = entry(KINDS, params, its._replace(wi=columns(its.wi),
                                              uv=columns(its.uv)),
                  columns(x), active)
    pairs = zip(got, want, again) if m == kernel.SAMPLE else [
        (got, want, again)]
    for g, w, a in pairs:
        assert g.is_cuda
        _assert_bit_equal(g, w, mode)
        _assert_bit_equal(a, w, f"{mode}, strided")
    torch.cuda.synchronize()


def _cbox(cuda):
    from psdr_tpu_torch.convert import params_from_numpy
    from psdr_tpu_torch.core import threefry
    from psdr_tpu_torch.testing.scenes import cbox_scene
    sc = cbox_scene(64, 64, spp=4, occluder_subdiv=2, device=cuda)
    p = params_from_numpy(sc.params(), device=cuda)
    return sc, p, threefry.PRNGKey(7, device=cuda)


def _calls(fn):
    """(BSDF calls, ``launches.bsdf``, ``bsdf.plain``) that ``fn()`` adds."""
    def read():
        c = profiling.counters()
        return (profiling.spans().get("bsdf", {"count": 0})["count"],
                c.get("launches.bsdf", 0), c.get("bsdf.plain", 0))
    before = read()
    fn()
    torch.cuda.synchronize()
    return tuple(b - a for a, b in zip(before, read()))


@pytest.mark.gpu
@pytest.mark.parametrize("integ", ["direct", "path"])
def test_launches_count_every_forward_call_and_no_gradient_call(cuda, integ):
    """A render program's body (``DirectIntegrator(2, 2)``,
    ``PathTracer(3)``) launches the kernel at every BSDF call and takes
    the tensor code at none; its replays add the same; a gradient
    program's differentiable calls take the tensor code, each counting
    ``bsdf.plain``, and launch nothing, eager and replayed."""
    from psdr_tpu_torch import DirectIntegrator, PathTracer
    sc, p, key = _cbox(cuda)
    it = DirectIntegrator(2, 2) if integ == "direct" else PathTracer(3)
    prog = it.render_program(sc)
    image = prog(p, key)
    with torch.no_grad():
        calls, launches, plain = _calls(lambda: prog.fn(p, key))
    assert calls > 0 and launches == calls and plain == 0
    assert _calls(lambda: prog(p, key))[1:] == (launches, 0)
    assert torch.equal(prog(p, key), image)

    grad = it.grad_program(sc, image.detach())
    grad(p, key)
    with torch.enable_grad():
        calls, launches, plain = _calls(lambda: grad.fn(p, key))
    assert calls > 0 and launches == 0 and plain == calls
    assert _calls(lambda: grad(p, key))[1:] == (0, plain)


@pytest.mark.gpu
@pytest.mark.parametrize("where", ["wi", "x", "map"])
@pytest.mark.parametrize("mode", ["eval", "pdf", "sample"])
def test_dual_inputs_take_the_tensor_code_on_the_card(cuda, mode, where):
    """A call on the card whose inputs carry forward-mode tangents, under
    ``no_grad`` as ``run_ad`` makes it, launches nothing, counts
    ``bsdf.plain`` and equals the tensor code, primal and tangent, bit for
    bit."""
    its, wo, s3, active = _lanes(1 << 12, seed=9, device=cuda)
    params = _params(True, device=cuda)
    entry = {"eval": eval_bsdf, "pdf": pdf_bsdf, "sample": sample_bsdf}[mode]
    m = _MODES[mode]
    with fwAD.dual_level(), torch.no_grad():
        args = _dual_inputs(params, its, s3 if m == kernel.SAMPLE else wo,
                            where)
        before = profiling.counters()
        got = entry(KINDS, *args, active)
        after = profiling.counters()
        want = _PLAIN[m](KINDS, *args, active)
        assert after.get("launches.bsdf", 0) == before.get("launches.bsdf",
                                                            0)
        assert after["bsdf.plain"] - before.get("bsdf.plain", 0) == 1
        for g, w in zip(_tangents(got), _tangents(want)):
            assert (g is None) == (w is None)
            if g is not None:
                _assert_bit_equal(g, w, f"{mode} tangent")
        assert any(t is not None and bool(t.any()) for t in _tangents(got))
        for g, w in zip(*((got, want) if m == kernel.SAMPLE
                          else ((got,), (want,)))):
            _assert_bit_equal(fwAD.unpack_dual(g).primal,
                              fwAD.unpack_dual(w).primal, mode)


@pytest.mark.gpu
def test_run_ad_on_the_card_matches_the_cpu(cuda):
    """``run_ad``'s derivative image of a sphere translation (forward mode
    under ``no_grad``, inside a captured program) on the card against the
    CPU's, relative L2 under 1e-4, and not zero."""
    from psdr_tpu_torch import DirectIntegrator
    from psdr_tpu_torch.testing import run_ad
    from psdr_tpu_torch.testing.scenes import sphere_light_scene
    imgs = [run_ad(sphere_light_scene(width=32, height=32, spp=8, sppe=2,
                                      sppse=8, device=d),
                   DirectIntegrator(1, 1), "mesh_transform", npass=2,
                   direction=(1.0, 0.0, 0.0))
            for d in (cuda, torch.device("cpu"))]
    card, cpu = imgs
    assert np.isfinite(card).all() and np.abs(card).max() > 0
    assert np.linalg.norm(card - cpu) / np.linalg.norm(cpu) < 1e-4
