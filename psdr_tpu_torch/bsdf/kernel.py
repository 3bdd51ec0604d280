"""The materials kernel (``csrc/bsdf.cu``): one launch runs a whole call of
the BSDF dispatch, one thread a lane, each lane only its own BSDF's
arithmetic. This module lays out its arguments: the scene's BSDF list as a
fixed-size descriptor table passed by value, and the lanes' pointers with
their strides, so that no input is copied. ``bsdf/__init__.py`` decides
which calls launch it."""
from __future__ import annotations

import ctypes
import math

import torch

from ..core.records import BSDFSample, Intersection

MAX_BSDFS = 32      # entries of the table (kMaxBsdfs)
EVAL, PDF, SAMPLE = 0, 1, 2
# each kind's code and its parameter maps, in the order the kernel reads
# them (kDiffuse, kRoughConductor and their maps in csrc/bsdf.cu)
KINDS = {"diffuse": (0, ("reflectance",)),
         "roughconductor": (1, ("alpha_u", "alpha_v", "eta", "k",
                                "specular_reflectance"))}
# the maps whose channels the kernel reads (the others: channel 0 alone);
# a map of one channel stands for all three
_COLOR = {"reflectance", "eta", "k", "specular_reflectance"}
_MAPS = 5


class _Map(ctypes.Structure):
    _fields_ = [("data", ctypes.c_void_p), ("h", ctypes.c_int32),
                ("w", ctypes.c_int32)]


class _Entry(ctypes.Structure):
    _fields_ = [("map", _Map * _MAPS), ("kind", ctypes.c_int32),
                ("channels", ctypes.c_uint8 * _MAPS),
                ("textured", ctypes.c_uint8)]


class Table(ctypes.Structure):
    """``PsdrBsdfTable``: the scene's BSDF list."""
    _fields_ = [("bsdf", _Entry * MAX_BSDFS), ("count", ctypes.c_int32)]


class _Lanes(ctypes.Structure):
    _fields_ = [("wi", ctypes.c_void_p), ("uv", ctypes.c_void_p),
                ("x", ctypes.c_void_p), ("id", ctypes.c_void_p),
                ("active", ctypes.c_void_p),
                ("wi_s", ctypes.c_int64 * 2), ("uv_s", ctypes.c_int64 * 2),
                ("x_s", ctypes.c_int64 * 2), ("id_s", ctypes.c_int64),
                ("active_s", ctypes.c_int64), ("n", ctypes.c_int64)]


class _Out(ctypes.Structure):
    _fields_ = [("f", ctypes.c_void_p), ("pdf", ctypes.c_void_p),
                ("valid", ctypes.c_void_p)]


def table(kinds, params_list, device: torch.device) -> Table:
    """The descriptor table of a BSDF list. Raises where the kernel cannot
    read it: more than MAX_BSDFS entries, a kind it does not know, a map
    that is not an (h, w, c) float32 tensor on ``device``, contiguous, with
    one or three channels where three are read, and 1x1 or at least 2x2
    texels."""
    if len(kinds) > MAX_BSDFS:
        raise ValueError(f"the materials kernel takes at most {MAX_BSDFS} "
                         f"BSDFs; the list has {len(kinds)}")
    t = Table(count=len(kinds))
    for entry, kind, params in zip(t.bsdf, kinds, params_list):
        if kind not in KINDS:
            raise NotImplementedError(f"BSDF kind {kind!r} has no kernel")
        entry.kind, names = KINDS[kind]
        for j, name in enumerate(names):
            data = params[name]
            if not (isinstance(data, torch.Tensor) and data.ndim == 3
                    and data.dtype == torch.float32
                    and data.device == device and data.is_contiguous()):
                raise ValueError(f"{kind} {name}: the kernel reads an (h, w, "
                                 f"c) float32 tensor on {device}, contiguous")
            h, w, c = data.shape
            if (h, w) != (1, 1) and min(h, w) < 2:
                raise ValueError(f"{kind} {name}: a {h}x{w} map; the bilinear "
                                 "lookup needs 1x1 or at least 2x2 texels")
            if c < 1 or (name in _COLOR and c not in (1, 3)):
                raise ValueError(f"{kind} {name}: {c} channels")
            entry.map[j] = _Map(data.data_ptr(), h, w)
            entry.channels[j] = c
            entry.textured |= (h, w) != (1, 1)
    return t


def _lane_input(name, x, dtype, dev, n, width=None):
    shape = (n,) if width is None else (n, width)
    if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape:
        raise ValueError(f"the materials kernel: {name} is {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}; it reads {dtype} "
                         f"{shape} on {dev}")
    return x


def launch(mode: int, kinds, params_list, its: Intersection,
           x: torch.Tensor, active: torch.Tensor):
    """One launch of ``psdr_bsdf`` on the current stream: ``eval`` (x is wo)
    -> (..., 3), ``pdf`` -> (...), ``sample`` (x is the sample) ->
    ``BSDFSample``. The lanes lie on one CUDA device; every parameter map
    there too."""
    from ..accel import intersect as lib_mod
    lanes = x.shape[:-1]
    dev = x.device
    n = math.prod(lanes)
    wi = _lane_input("wi", its.wi.reshape(-1, 3), torch.float32, dev, n, 3)
    uv = _lane_input("uv", its.uv.reshape(-1, 2), torch.float32, dev, n, 2)
    xs = _lane_input("wo" if mode != SAMPLE else "sample3", x.reshape(-1, 3),
                     torch.float32, dev, n, 3)
    ids = _lane_input("bsdf_id", its.bsdf_id.reshape(-1), torch.int32, dev, n)
    act = _lane_input("active", active.reshape(-1), torch.bool, dev, n)
    desc = table(kinds, params_list, dev)
    f = (torch.empty((n, 3), dtype=torch.float32, device=dev)
         if mode != PDF else None)
    pdf = (torch.empty((n,), dtype=torch.float32, device=dev)
           if mode != EVAL else None)
    valid = (torch.empty((n,), dtype=torch.bool, device=dev)
             if mode == SAMPLE else None)
    if n > 0:
        lanes_arg = _Lanes(wi.data_ptr(), uv.data_ptr(), xs.data_ptr(),
                           ids.data_ptr(), act.data_ptr(), wi.stride(),
                           uv.stride(), xs.stride(), ids.stride(0),
                           act.stride(0), n)
        out = _Out(*(None if t is None else t.data_ptr()
                     for t in (f, pdf, valid)))
        lib = lib_mod.load_library()
        lib_mod._launch("bsdf", lib.psdr_bsdf, mode, ctypes.addressof(desc),
                        ctypes.addressof(lanes_arg), ctypes.addressof(out),
                        dev=dev)
        lib_mod.BSDF_LAUNCHES["bsdf"] += 1
    if mode == EVAL:
        return f.reshape(lanes + (3,))
    if mode == PDF:
        return pdf.reshape(lanes)
    return BSDFSample(valid=valid.reshape(lanes), pdf=pdf.reshape(lanes),
                      wo=f.reshape(lanes + (3,)))
