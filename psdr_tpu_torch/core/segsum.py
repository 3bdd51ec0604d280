"""Sums whose order does not depend on scheduling.

On the card an atomic scatter-add (``index_add_``, the backward of
``index_select`` or of ``table[idx]``) adds the lanes of a row in whatever
order they arrive, and a one-dimensional float ``torch.cumsum`` runs CUB's
scan, whose look-back adds the tiles' sums in an order that depends on which
tile has finished. Both move the last bits from run to run, and discrete
tests downstream (hit or miss, which cmf entry a sample lands on) amplify
those bits. The JAX package's sums run in one order on its chip (XLA's
scatter-add and scan), so the port's default path uses these instead:

* ``segment_sum_sorted(keys, values, num_rows, order)``: ``out[k] = sum of
  values[order[i]] over the lanes i with keys[i] == k``, for keys sorted
  ascending (a key below 0 is dropped), in the fixed order of
  ``csrc/segsum.cu`` (its module comment): chunks of ``CHUNK`` lanes, a
  segmented scan inside each, the chunks' pieces of a row added level by
  level. CUDA tensors launch the kernel (``segsum_cuda``), CPU tensors run
  ``segsum_plain``, the same order in tensor code, bit for bit;
* ``sort_keys(idx, num_rows)``: the stable sort of lane indices into
  (keys, order), one sort for every sum keyed by ``idx``; entries outside
  ``[0, num_rows)`` become the dropped key -1;
* ``index_sum(values, idx, num_rows)``: ``zeros(num_rows, ...)`` with the
  lanes' values added at ``idx`` (negatives dropped), differentiable: its
  backward gathers the cotangent rows back to the lanes, its forward-mode
  derivative sums the tangents the same way;
* ``prefix_sum(x)``: a 1-D inclusive prefix sum; on CUDA tensors a scan of
  rows of ``SCAN_ROW`` entries (never the one-row form that runs CUB's
  look-back) plus the rows' carried sums, on CPU tensors ``torch.cumsum``.
"""
from __future__ import annotations

import torch

CHUNK = 256        # lanes a chunk (csrc/segsum.cu kChunk)
SCAN_ROW = 1024    # entries a row of prefix_sum's scan on the card


def sort_keys(idx: torch.Tensor, num_rows: int):
    """(keys int32 (n,), order int64 (n,)): ``idx`` flattened, entries
    outside ``[0, num_rows)`` set to -1, stably sorted; ``order`` gives the
    lane of each sorted entry."""
    if num_rows >= (1 << 31):
        raise ValueError("segment sums index rows with int32")
    idx = idx.reshape(-1)
    keys = torch.where((idx >= 0) & (idx < num_rows), idx, -1).to(torch.int32)
    return torch.sort(keys, stable=True)


def segment_sum_sorted(keys: torch.Tensor, values: torch.Tensor,
                       num_rows: int, order: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """(num_rows, c) float32 sums of the rows of ``values`` ((m, c), float32;
    lane i's row is ``values[order[i]]``, or ``values[i]`` without
    ``order``) by ``keys`` ((n,) int32, sorted; -1 dropped), in the fixed
    order of ``csrc/segsum.cu``."""
    if values.device.type == "cuda":
        return segsum_cuda(keys, values, num_rows, order)
    return segsum_plain(keys, values, num_rows, order)


def segsum_plain(keys, values, num_rows: int, order=None) -> torch.Tensor:
    """``csrc/segsum.cu``'s reduction in tensor code, level by level, add
    for add: the kernel's plain version."""
    c = values.shape[1]
    dev = values.device
    out = torch.zeros((num_rows + 1, c), dtype=values.dtype, device=dev)
    vals = values if order is None else torch.index_select(values, 0, order)
    first = True
    while True:
        n = keys.shape[0]
        if n == 0:
            break
        nb = -(-n // CHUNK)
        pad = nb * CHUNK - n
        k = torch.cat([keys, keys.new_full((pad,), -1)]).reshape(nb, CHUNK)
        v = torch.cat([vals, vals.new_zeros((pad, c))]).reshape(nb, CHUNK, c)
        s = 1
        while s < CHUNK:
            same = (k[:, s:] == k[:, :-s])[..., None]
            v = torch.cat([v[:, :s], torch.where(same, v[:, s:] + v[:, :-s],
                                                 v[:, s:])], dim=1)
            s *= 2
        before = torch.cat([k.new_full((1,), -1), k[:-1, -1]])
        open_ = (k[:, 0] >= 0) & (before == k[:, 0])
        run_end = torch.ones_like(k, dtype=torch.bool)
        run_end[:, :-1] = k[:, 1:] != k[:, :-1]
        head = run_end & open_[:, None] & (k == k[:, :1])
        owner = run_end & ~head & (k >= 0)
        dst = torch.where(owner, k, num_rows).reshape(-1).long()
        flat = v.reshape(-1, c)
        out = out.index_put((dst,), flat if first else out[dst] + flat)
        out[num_rows] = 0.0
        if nb == 1:
            break
        # each chunk's head: its first run's sum where that run is open
        last = torch.where(head, torch.arange(CHUNK, device=dev), -1).amax(1)
        keys = torch.where(open_, k[:, 0], -1)
        vals = torch.where(open_[:, None], v[torch.arange(nb, device=dev),
                                             torch.clamp(last, min=0)], 0.0)
        first = False
    return out[:num_rows]


def segsum_cuda(keys, values, num_rows: int, order=None) -> torch.Tensor:
    """Launch ``csrc/segsum.cu`` on the current stream, one launch a level
    (``accel.intersect.LAUNCHES["segsum"]`` counts each)."""
    from ..accel import intersect as lib_mod
    dev = values.device
    if dev.type != "cuda":
        raise ValueError(f"segsum_cuda takes CUDA tensors, got {dev}")
    m, c = values.shape
    n = keys.shape[0]
    if n >= (1 << 31):
        raise ValueError("segsum indexes lanes with int32")
    specs = [("keys", keys, torch.int32, (n,)),
             ("values", values, torch.float32, (m, c))]
    if order is not None:
        specs.append(("order", order, torch.int64, (n,)))
    lib_mod._check("segsum", specs, dev)
    out = torch.zeros((num_rows, c), dtype=torch.float32, device=dev)
    if n == 0 or c == 0:
        return out
    lib = lib_mod.load_library()
    vals, accumulate = values, 0
    while True:
        nb = -(-n // CHUNK)
        heads = ((torch.empty((nb,), dtype=torch.int32, device=dev),
                  torch.empty((nb, c), dtype=torch.float32, device=dev))
                 if nb > 1 else (None, None))
        lib_mod._launch(
            "segsum", lib.psdr_segsum, keys.data_ptr(),
            None if order is None else order.data_ptr(), vals.data_ptr(), n,
            c, out.data_ptr(), accumulate,
            *(None if h is None else h.data_ptr() for h in heads), dev=dev)
        lib_mod.LAUNCHES["segsum"] += 1
        if nb == 1:
            return out
        (keys, vals), order, n, accumulate = heads, None, nb, 1


def _rows(values: torch.Tensor) -> torch.Tensor:
    return values.reshape(values.shape[0], -1).float().contiguous()


class _IndexSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, idx, num_rows):
        keys, order = sort_keys(idx, num_rows)
        ctx.save_for_backward(idx)
        ctx.keys, ctx.order, ctx.num_rows = keys, order, num_rows
        out = segment_sum_sorted(keys, _rows(values), num_rows, order)
        return out.reshape((num_rows,) + values.shape[1:]).to(values.dtype)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        n = ctx.num_rows
        ok = (idx >= 0) & (idx < n)
        ext = torch.cat([g, g.new_zeros((1,) + g.shape[1:])])
        return (torch.index_select(ext, 0, torch.where(ok, idx, n).long()),
                None, None)

    @staticmethod
    def jvp(ctx, t_values, _idx, _num_rows):
        n = ctx.num_rows
        out = segment_sum_sorted(ctx.keys, _rows(t_values), n, ctx.order)
        return out.reshape((n,) + t_values.shape[1:]).to(t_values.dtype)


def index_sum(values: torch.Tensor, idx: torch.Tensor,
              num_rows: int) -> torch.Tensor:
    """``zeros((num_rows,) + values.shape[1:]).index_add_(0, idx, values)``
    with negative (or too large) ``idx`` dropped, summed in one fixed order
    (``segment_sum_sorted``); differentiable in ``values``."""
    return _IndexSum.apply(values, idx.reshape(-1), num_rows)


def prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of a 1-D tensor, in one fixed order on the
    card (``_row_scan``); ``torch.cumsum`` on the CPU, which adds in
    sequence."""
    if x.device.type != "cuda":
        return torch.cumsum(x, dim=0)
    return _row_scan(x)


def _row_scan(x: torch.Tensor) -> torch.Tensor:
    """The entries in rows of ``SCAN_ROW`` (at least two rows, so that
    ``torch.cumsum`` takes its row kernel and not CUB's look-back scan),
    each row's scan plus the prefix of the rows' totals, found the same
    way (a short tensor scans as one row beside a row of zeros)."""
    n = x.shape[0]
    if n <= SCAN_ROW:
        return torch.stack([x, torch.zeros_like(x)]).cumsum(dim=1)[0]
    r = -(-n // SCAN_ROW)
    rows = torch.cat([x, x.new_zeros((r * SCAN_ROW - n,))]).reshape(
        r, SCAN_ROW).cumsum(dim=1)
    carry = torch.cat([x.new_zeros((1,)), _row_scan(rows[:-1, -1])])
    return (rows + carry[:, None]).reshape(-1)[:n]
