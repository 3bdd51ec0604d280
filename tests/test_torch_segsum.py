"""The order of the port's fixed-order sum (``core/segsum.py``,
``csrc/segsum.cu``), on the CPU:

* ``reference_sum``, a scalar reading of the order the kernel's comment
  states (levels, blocks, spans, lanes and the steps of the spans' scan as
  Python loops, each add a float32 add), equals ``segsum_plain`` bit for
  bit: runs that cross a span, a block and a level, one row holding every
  lane, every lane dropped, no lane, 1 to 64 columns, with and without
  ``order``, and with the block cut down so that runs cross three levels;
* ``segsum_plain`` against a float64 sum on the same shapes, within 4e-7
  of each row's sum of absolute values (``test_torch_determinism.py``'s
  bound);
* ``sort_keys``'s int16 sort (below 2^15 rows) gives the int32 sort's keys
  and permutation.

On the card ``tests/test_torch_gpu.py`` and ``chip_smoke.py`` phase 31 hold
the kernel against ``segsum_plain``.
"""
import numpy as np
import pytest
import torch

from psdr_tpu_torch.core import segsum


def reference_sum(keys, values, num_rows, order, span, spans):
    """``out[k]``, the sum of ``values[order[i]]`` over the sorted lanes i
    of key k (keys below 0 dropped), in ``csrc/segsum.cu``'s order with
    spans of ``span`` lanes and blocks of ``spans`` spans."""
    vals = values if order is None else values[order]
    keys = [int(k) for k in keys]
    c = values.shape[1]
    out = np.zeros((num_rows, c), np.float32)
    block = span * spans
    later = False
    while keys:
        nb = -(-len(keys) // block)
        pad = nb * block - len(keys)
        key = keys + [-1] * pad
        val = np.concatenate([vals, np.zeros((pad, c), np.float32)])
        heads = []
        for b in range(nb):
            base = b * block
            # each run of a span, left to right from its first lane there
            piece = []
            for i in range(block):
                if i % span and key[base + i] == key[base + i - 1]:
                    piece.append(piece[-1] + val[base + i])
                else:
                    piece.append(val[base + i].copy())
            # the spans' last pieces: a segmented Hillis-Steele scan
            tk = [key[base + s * span + span - 1] for s in range(spans)]
            z = [piece[s * span + span - 1] for s in range(spans)]
            step = 1
            while step < spans:
                z = [z[j] + z[j - step]
                     if j >= step and tk[j - step] == tk[j] else z[j]
                     for j in range(spans)]
                step *= 2
            first = key[base]
            is_open = b > 0 and first >= 0 and key[base - 1] == first
            head = (-1, np.zeros(c, np.float32))
            for i in range(block):
                k = key[base + i]
                if i + 1 < block and key[base + i + 1] == k:
                    continue                     # not the run's last lane
                s0 = i - i % span                # its span's first lane
                entered = (s0 > 0 and key[base + s0 - 1] == k
                           and all(key[base + j] == k
                                   for j in range(s0, i + 1)))
                total = z[s0 // span - 1] + piece[i] if entered else piece[i]
                if is_open and k == first:
                    head = (k, total)
                elif k >= 0:
                    out[k] = out[k] + total if later else total
            heads.append(head)
        if nb == 1:
            break
        keys = [k for k, _ in heads]
        vals = np.stack([v for _, v in heads])
        later = True
    return out


def _case(kind, c, rng):
    """(idx (n,) int64, rows): lanes in lane order, before the sort."""
    if kind == "crossing":      # one row over two blocks, the rest spread
        idx = np.concatenate([np.full(2300, 2), rng.integers(-1, 6, 2700)])
        return rng.permutation(idx), 6
    if kind == "one row":
        return np.full(4500, 1), 3
    if kind == "dropped":
        return np.full(3000, -1), 5
    if kind == "none":
        return np.zeros(0, np.int64), 5
    # "levels": blocks of 16 lanes, so 1,300 lanes take three levels
    idx = np.concatenate([np.full(300, 5), rng.integers(-1, 40, 1000)])
    return rng.permutation(idx), 40


CASES = ([("crossing", c, o) for c in (1, 3, 9, 32, 33, 64)
          for o in (True, False)]
         + [("one row", 3, True), ("dropped", 2, True), ("none", 4, True),
            ("levels", 3, True), ("levels", 33, False)])


def _inputs(kind, c, with_order, monkeypatch):
    if kind == "levels":
        monkeypatch.setattr(segsum, "SPAN", 4)
        monkeypatch.setattr(segsum, "SPANS", 4)
    rng = np.random.default_rng(c)
    idx, rows = _case(kind, c, rng)
    idx = torch.as_tensor(idx.astype(np.int64))
    vals = torch.as_tensor(rng.normal(size=(idx.numel(), c)).astype(
        np.float32))
    keys, order = segsum.sort_keys(idx, rows)
    if not with_order:           # the values already in sorted order
        return idx, keys, vals[order], rows, None, vals
    return idx, keys, vals, rows, order, vals


@pytest.mark.parametrize("kind,c,with_order", CASES)
def test_segsum_plain_adds_in_the_stated_order(kind, c, with_order,
                                               monkeypatch):
    """``segsum_plain`` equals ``reference_sum`` bit for bit."""
    _, keys, vals, rows, order, _ = _inputs(kind, c, with_order,
                                            monkeypatch)
    got = segsum.segsum_plain(keys, vals, rows, order).numpy()
    want = reference_sum(keys.numpy(), vals.numpy(), rows,
                         None if order is None else order.numpy(),
                         segsum.SPAN, segsum.SPANS)
    assert got.shape == want.shape == (rows, c)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("kind,c,with_order", CASES)
def test_segsum_plain_against_a_float64_sum(kind, c, with_order,
                                            monkeypatch):
    """``segsum_plain`` within 4e-7 of each row's sum of absolute values
    of the float64 sum; rows without a lane exactly 0."""
    idx, keys, vals, rows, order, lane_vals = _inputs(kind, c, with_order,
                                                      monkeypatch)
    got = segsum.segsum_plain(keys, vals, rows, order).double().numpy()
    lane_vals = lane_vals.double().numpy()
    ok = (idx >= 0).numpy()
    exact = np.zeros((rows, c))
    np.add.at(exact, idx.numpy()[ok], lane_vals[ok])
    scale = np.zeros((rows, c))
    np.add.at(scale, idx.numpy()[ok], np.abs(lane_vals[ok]))
    assert (np.abs(got - exact) <= 4e-7 * scale).all()


@pytest.mark.parametrize("rows", [3, (1 << 15) - 1, 1 << 15])
def test_sort_keys_narrow_sort_gives_the_same_permutation(rows):
    """Below 2^15 rows ``sort_keys`` sorts int16 keys: its int32 keys and
    its order equal the int32 stable sort's, dropped lanes (-1) first."""
    idx = torch.as_tensor(np.random.default_rng(rows).integers(
        -2, rows + 2, 5000))
    keys, order = segsum.sort_keys(idx, rows)
    want = torch.sort(torch.where((idx >= 0) & (idx < rows), idx, -1).to(
        torch.int32), stable=True)
    assert keys.dtype == torch.int32 and order.dtype == torch.int64
    assert torch.equal(keys, want.values)
    assert torch.equal(order, want.indices)
