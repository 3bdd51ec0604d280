"""Wavefront row gather with a selectable backward reduction.
Counterpart of ``psdr_tpu/core/gather.py``.

The backward of ``table[idx]`` (idx: N wavefront lanes, table: F rows)
adds N cotangent rows into F table rows. The modes choose how:

- ``native``: ``torch.index_select``, whose backward is PyTorch's own,
  an ``index_add_`` (atomic adds on the card). Plain ``table[idx]`` is not
  used: its backward, an accumulating ``index_put_``, walks each run of
  equal indices serially on the card, and the wavefront's lanes pile onto
  a few rows (the walls' and the light's faces);
- ``scatter``: an explicit ``index_add_`` of the cotangent rows (the same
  reduction as native; it exists as a named baseline, as in JAX);
- ``sorted``: sort the lanes by destination row, then a segment sum
  (``torch.segment_reduce``) over the sorted rows;
- ``cumsum``: sort, an exclusive-padded prefix sum, and per-row
  differences at the segment bounds; no scatter at all, but float32
  prefix sums lose precision as N grows.

Every mode but ``native`` is one ``torch.autograd.Function``; its forward
mode (``jvp``) gathers the tangent rows, as the gather is linear in the
table. ``PSDR_TPU_GATHER_VJP`` sets the process default (``native``),
and ``set_gather_vjp_mode`` changes it.

``select_rows`` is the JAX package's gather into a small table (up to 16
rows): a chain of selects, whose backward is a sum over the lanes of each
row's mask, with no scatter at all.
"""
from __future__ import annotations

import os

import numpy as np
import torch

_MODES = ("native", "scatter", "sorted", "cumsum")
# the process default, read at import
_DEFAULT_MODE = os.environ.get("PSDR_TPU_GATHER_VJP", "native")


def set_gather_vjp_mode(mode: str) -> None:
    """Set the process default backward mode. A call reads the default as
    it runs, so a captured program keeps the mode it was captured under
    until it captures again, as a jitted JAX program keeps its trace's."""
    global _DEFAULT_MODE
    if mode not in _MODES:
        raise ValueError(f"gather vjp mode {mode!r} not in {_MODES}")
    _DEFAULT_MODE = mode


def get_gather_vjp_mode() -> str:
    return _DEFAULT_MODE


def _resolve(mode: str | None) -> str:
    mode = mode or _DEFAULT_MODE
    if mode not in _MODES:
        raise ValueError(f"gather vjp mode {mode!r} not in {_MODES}")
    return mode


def _sorted_reduce(mode: str, idx_s, ct_s, F: int):
    """Reduce cotangent rows sorted by destination into (F, ...) rows."""
    if mode == "sorted":
        lengths = torch.bincount(idx_s, minlength=F)
        return torch.segment_reduce(ct_s, "sum", lengths=lengths, unsafe=True)
    csum = torch.cat([torch.zeros((1,) + ct_s.shape[1:], dtype=ct_s.dtype,
                                  device=ct_s.device),
                      torch.cumsum(ct_s, dim=0)])
    rows = torch.arange(F, dtype=idx_s.dtype, device=idx_s.device)
    left = torch.searchsorted(idx_s, rows, side="left")
    right = torch.searchsorted(idx_s, rows, side="right")
    return csum[right] - csum[left]


class _GatherRows(torch.autograd.Function):
    """``tuple(table[idx + o] for o in offsets)``; one sort of ``idx``
    serves every offset's reduction (adding a constant keeps the order)."""

    @staticmethod
    def forward(ctx, table, idx, offsets, mode):
        ctx.save_for_backward(idx)
        ctx.save_for_forward(idx)
        ctx.offsets, ctx.mode, ctx.table_shape = offsets, mode, table.shape
        return tuple(table[idx + o] for o in offsets)

    @staticmethod
    def backward(ctx, *cts):
        (idx,) = ctx.saved_tensors
        shape, mode = ctx.table_shape, ctx.mode
        rf = idx.reshape(-1)
        rows = [ct.reshape((-1,) + ct.shape[idx.ndim:]) for ct in cts]
        d = torch.zeros(shape, dtype=rows[0].dtype, device=rows[0].device)
        if mode == "scatter":
            for o, ct in zip(ctx.offsets, rows):
                d.index_add_(0, rf + o, ct)
            return d, None, None, None
        order = torch.argsort(rf, stable=True)
        idx_s = rf[order]
        for o, ct in zip(ctx.offsets, rows):
            d = d + _sorted_reduce(mode, idx_s + o, ct[order], shape[0])
        return d, None, None, None

    @staticmethod
    def jvp(ctx, t_table, _idx, _offsets, _mode):
        (idx,) = ctx.saved_tensors
        return tuple(t_table[idx + o] for o in ctx.offsets)


def gather_rows(table: torch.Tensor, idx: torch.Tensor,
                mode: str | None = None) -> torch.Tensor:
    """``table[idx]`` whose backward reduction is selectable (``mode=None``
    reads the process default)."""
    return gather_rows_offsets(table, idx, (0,), mode)[0]


def _index_select(table, idx):
    return torch.index_select(table, 0, idx.reshape(-1)).reshape(
        idx.shape + table.shape[1:])


def gather_rows_offsets(table: torch.Tensor, idx: torch.Tensor,
                        offsets: tuple[int, ...],
                        mode: str | None = None) -> tuple[torch.Tensor, ...]:
    """``tuple(table[idx + o] for o in offsets)`` sharing one backward
    sort."""
    mode = _resolve(mode)
    idx = idx.long()
    if mode == "native":
        return tuple(_index_select(table, idx + o) for o in offsets)
    return _GatherRows.apply(table, idx, tuple(offsets), mode)


def segment_table(index, n: int) -> np.ndarray:
    """(n, K) int64: for each destination d < n, the positions i with
    ``index[i] == d`` in ascending order, padded with ``len(index)``; K is
    the most positions a destination has. Made on the host from a fixed
    index array (a mesh's faces or edges), for ``segment_sum``."""
    index = np.asarray(index, np.int64).reshape(-1)
    order = np.argsort(index, kind="stable")
    counts = np.bincount(index, minlength=n)
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(index.size) - np.repeat(first, counts)
    table = np.full((n, max(int(counts.max(initial=0)), 1)), index.size,
                    np.int64)
    table[index[order], slot] = order
    return table


def segment_sum(values: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``zeros(n).index_add_(0, index, values)`` for ``table =
    segment_table(index, n)``, summed one slot at a time in the order of
    the positions: bit for bit a sequential scatter-add (the CPU's), on the
    card too, where an atomic scatter-add sums in another order on every
    run. Differentiable in both modes (row gathers and adds)."""
    pad = torch.cat([values, torch.zeros_like(values[:1])])
    out = torch.index_select(pad, 0, table[:, 0])
    for k in range(1, table.shape[1]):
        out = out + torch.index_select(pad, 0, table[:, k])
    return out


def select_rows(table: torch.Tensor, idx: torch.Tensor,
                max_unroll: int = 16) -> torch.Tensor:
    """``table[idx]``: a select chain for a table of up to ``max_unroll``
    rows, ``gather_rows`` above. ``table``: (L, ...); ``idx``: (N,)."""
    L = table.shape[0]
    if L > max_unroll:
        return gather_rows(table, idx)
    expand = (slice(None),) + (None,) * (table.ndim - 1)
    out = table[0].expand(idx.shape + table.shape[1:])
    for i in range(1, L):
        out = torch.where((idx == i)[expand], table[i], out)
    return out
