"""Host data on the device, made once and outside any captured program.

A captured CUDA graph (``program.py``) may not copy from host memory: the
copy synchronizes, and a synchronize is illegal while a stream captures.
So every tensor that a render reads from host data (the film size, the
tile order, a mesh's topology, the BVH's permutation, small literal
tables) is made on the first call, which runs eagerly, and read from a
cache after that:

* ``const(values, dtype, device)``: a small literal, memoised by value;
* ``upload(owner, array, device, dtype)``: a host array that ``owner``
  keeps (a mesh's faces, a topology's permutation), memoised on ``owner``
  by the array's identity, so that replacing the array uploads the new
  one;
* ``memo(owner, key, make)``: any other tensor derived from host state,
  memoised on ``owner`` under ``key``.

Cached tensors are shared by every caller, who never writes into them.

A graph holds addresses, not tensors, so a cache entry that a program's
capture read must outlive the program, even where the cache evicts it.
``holding()`` collects what ``const``, ``upload``, ``memo`` and ``hold``
hand out while it stands (a ``Program`` holds its capture's collection
until it drops its graph); a cache outside this module hands its tensors
out through ``hold``.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

_CONSTS: dict = {}
_HOLDERS: list = []


@contextlib.contextmanager
def holding():
    """A dict that receives, by identity, everything ``const``,
    ``upload``, ``memo`` and ``hold`` hand out while the context stands."""
    held: dict = {}
    _HOLDERS.append(held)
    try:
        yield held
    finally:
        _HOLDERS.pop()


def hold(x):
    """``x``, kept by every ``holding()`` that stands."""
    for held in _HOLDERS:
        held[id(x)] = x
    return x


def _device(device) -> torch.device:
    """``device`` with the current CUDA index filled in, so that "cuda"
    and "cuda:0" name one cache entry."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def const(values, dtype, device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)`` for a small
    literal (numbers, nested lists or tuples of them, a numpy array), made
    once per value, dtype and device."""
    a = np.asarray(values)
    dev = _device(device)
    key = (a.tobytes(), a.shape, a.dtype.str, dtype, dev)
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.as_tensor(a, dtype=dtype, device=dev)
    return hold(t)


def upload(owner, array, device, dtype=None) -> torch.Tensor:
    """``array`` (host data that ``owner`` keeps) as a tensor on
    ``device``, uploaded once. The entry holds the array, so its identity
    cannot be reused while the entry lives."""
    if isinstance(array, torch.Tensor):
        return array.to(device=device, dtype=dtype)
    dev = _device(device)
    cache = owner.__dict__.setdefault("_uploads", {})
    key = (id(array), dev, dtype)
    hit = cache.get(key)
    if hit is None:
        hit = cache[key] = (array, torch.as_tensor(array, dtype=dtype,
                                                   device=dev))
    return hold(hit[1])


def forget(owner, *arrays) -> None:
    """Drop ``owner``'s uploads of ``arrays`` (``upload``), freeing their
    device copies once nothing else holds them."""
    cache = owner.__dict__.get("_uploads", {})
    for key in [k for k, (a, _) in cache.items()
                if any(a is x for x in arrays)]:
        del cache[key]


def memo(owner, key, make):
    """``make()``, made once per ``key`` and kept on ``owner``."""
    cache = owner.__dict__.setdefault("_memo", {})
    if key not in cache:
        cache[key] = make()
    return hold(cache[key])
