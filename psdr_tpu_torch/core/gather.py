"""Wavefront row gather with a selectable backward reduction.
Counterpart of ``psdr_tpu/core/gather.py``.

The backward of ``table[idx]`` (idx: N wavefront lanes, table: F rows)
adds N cotangent rows into F table rows. The modes choose how:

- ``native`` (the default): the lanes are sorted by row in the forward
  (``core.segsum.sort_keys``, stable), where the table requires grad, and
  the backward sums the cotangent rows in that order with
  ``core.segsum.segment_sum_sorted``: one fixed order of adds, the same on
  every run (``csrc/segsum.cu`` on the card), as XLA's scatter-add is on
  the JAX package's chip. Neither ``index_select``'s own backward (an
  atomic ``index_add_`` on the card, whose order changes from run to run)
  nor plain ``table[idx]`` (an accumulating ``index_put_``, which walks
  each run of equal indices serially on the card, while the wavefront's
  lanes pile onto a few rows: the walls' and the light's faces);
- ``scatter``: an explicit ``index_add_`` of the cotangent rows, the named
  baseline as in JAX. On the card it is atomic: its sums round in another
  order on every run;
- ``sorted``: the same fixed-order reduction, with the sort made in the
  backward, as the JAX package's ``sorted`` mode argsorts in its
  transpose;
- ``cumsum``: sort, an exclusive-padded prefix sum, and per-row
  differences at the segment bounds; no scatter at all, but float32
  prefix sums lose precision as N grows (and a 1-D one, a table of single
  values, runs CUB's look-back scan on the card, whose order varies).

Every mode is one ``torch.autograd.Function``; its forward mode (``jvp``)
gathers the tangent rows, as the gather is linear in the table.
``PSDR_TPU_GATHER_VJP`` sets the process default (``native``), and
``set_gather_vjp_mode`` changes it.

``select_rows`` is the JAX package's gather into a small table (up to 16
rows): a chain of selects, whose backward is a sum over the lanes of each
row's mask, with no scatter at all. ``segment_sum`` sums values into rows
through a host-made ``segment_table``, in the order of the positions.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .segsum import segment_sum_sorted, sort_keys

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


def _cumsum_reduce(idx_s, ct_s, F: int):
    """Reduce cotangent rows sorted by destination into (F, ...) rows by
    differences of a prefix sum at the segment bounds."""
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
        ctx.sort = (sort_keys(idx, table.shape[0])
                    if mode == "native" and ctx.needs_input_grad[0] else None)
        return tuple(_index_select(table, idx + o) for o in offsets)

    @staticmethod
    def backward(ctx, *cts):
        (idx,) = ctx.saved_tensors
        shape, mode = ctx.table_shape, ctx.mode
        rf = idx.reshape(-1)
        rows = [ct.reshape((-1,) + ct.shape[idx.ndim:]) for ct in cts]
        if mode == "scatter":
            d = torch.zeros(shape, dtype=rows[0].dtype, device=rows[0].device)
            for o, ct in zip(ctx.offsets, rows):
                d.index_add_(0, rf + o, ct)
            return d, None, None, None
        if mode == "cumsum":
            order = torch.argsort(rf, stable=True)
            idx_s = rf[order]
            d = torch.zeros(shape, dtype=rows[0].dtype, device=rows[0].device)
            for o, ct in zip(ctx.offsets, rows):
                d = d + _cumsum_reduce(idx_s + o, ct[order], shape[0])
            return d, None, None, None
        keys, order = ctx.sort or sort_keys(idx, shape[0])
        d = None
        for o, ct in zip(ctx.offsets, rows):
            part = segment_sum_sorted(
                torch.where(keys >= 0, keys + o, -1) if o else keys,
                ct.reshape(ct.shape[0], -1).float().contiguous(), shape[0],
                order).reshape(shape).to(ct.dtype)
            d = part if d is None else d + part
        return d, None, None, None

    @staticmethod
    def jvp(ctx, t_table, _idx, _offsets, _mode):
        (idx,) = ctx.saved_tensors
        return tuple(_index_select(t_table, idx + o) for o in ctx.offsets)


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
    return _GatherRows.apply(table, idx.long(), tuple(offsets),
                             _resolve(mode))


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


class _SegmentSum(torch.autograd.Function):
    """``segment_sum``: the forward sums slot by slot; the backward is the
    transpose, a gather of each position's row of the cotangent (no
    scatter); the forward mode sums the tangents as the forward does."""

    @staticmethod
    def forward(ctx, values, table):
        ctx.save_for_backward(table)
        ctx.save_for_forward(table)
        ctx.n_values = values.shape[0]
        return _slot_sum(values, table)

    @staticmethod
    def backward(ctx, g):
        (table,) = ctx.saved_tensors
        n, k = table.shape
        # each position's destination: position i sits in row d of the
        # table; the padding slots all name position n_values, which is
        # dropped (the only index written twice)
        rows = torch.arange(n, dtype=table.dtype, device=table.device)
        dest = torch.full((ctx.n_values + 1,), n, dtype=table.dtype,
                          device=table.device).scatter_(
            0, table.reshape(-1), rows[:, None].expand(n, k).reshape(-1))
        ext = torch.cat([g, torch.zeros_like(g[:1])])
        return torch.index_select(ext, 0, dest[:-1]), None

    @staticmethod
    def jvp(ctx, t_values, _table):
        (table,) = ctx.saved_tensors
        return _slot_sum(t_values, table)


def _slot_sum(values, table):
    pad = torch.cat([values, torch.zeros_like(values[:1])])
    out = torch.index_select(pad, 0, table[:, 0])
    for k in range(1, table.shape[1]):
        out = out + torch.index_select(pad, 0, table[:, k])
    return out


def segment_sum(values: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``zeros(n).index_add_(0, index, values)`` for ``table =
    segment_table(index, n)``, summed one slot at a time in the order of
    the positions: bit for bit a sequential scatter-add (the CPU's), on the
    card too, where an atomic scatter-add sums in another order on every
    run. Differentiable in both modes; the backward gathers (no
    scatter-add)."""
    return _SegmentSum.apply(values, table)


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
