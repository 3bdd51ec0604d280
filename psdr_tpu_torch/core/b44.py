"""OpenEXR B44 / B44A tile codec, numpy-vectorized.

B44 stores each 4x4 tile of HALF pixels in 14 bytes: one exact 16-bit
anchor value plus fifteen 6-bit deltas (shifted by a per-tile exponent)
along fixed column-then-row chains.  B44A additionally collapses flat
tiles (all deltas zero) to 3 bytes, marked by a 0xfc type byte.  Non-HALF
channels are stored uncompressed (planar) inside the block.

The whole tile population of a channel block is packed/unpacked as one
numpy batch; only the B44A variable-length tile scan is a Python loop.

Beyond-reference capability: the reference's vendored tinyexr
(include/psdr/core/tinyexr.h, used by src/core/bitmap_loader.cpp:13-53)
cannot read B44 at all.
"""
from __future__ import annotations

import numpy as np

# decode chains: t[dst] = t[src] + (r[k] - 32) << shift  (uint16 wraparound)
_CHAIN = [(4, 0, 0), (8, 4, 1), (12, 8, 2),
          (1, 0, 3), (5, 4, 4), (9, 8, 5), (13, 12, 6),
          (2, 1, 7), (6, 5, 8), (10, 9, 9), (14, 13, 10),
          (3, 2, 11), (7, 6, 12), (11, 10, 13), (15, 14, 14)]


def _fwd(s: np.ndarray) -> np.ndarray:
    """Half bit pattern -> monotonic unsigned ordering (uint16)."""
    s = s.astype(np.uint16)
    t = np.where(s & 0x8000, ~s, s | np.uint16(0x8000))
    return np.where((s & 0x7C00) == 0x7C00, np.uint16(0x8000), t)


def _inv(t: np.ndarray) -> np.ndarray:
    """Inverse of _fwd (inf/nan collapse to +0 — B44 is lossy there)."""
    t = t.astype(np.uint16)
    return np.where(t & 0x8000, t & np.uint16(0x7FFF), ~t)


def _unpack_tiles(b: np.ndarray, flat: np.ndarray) -> np.ndarray:
    """(N, 14) tile bytes (+flat mask) -> (N, 16) half bit patterns."""
    b = b.astype(np.uint16)
    anchor = (b[:, 0] << 8) | b[:, 1]
    shift = (b[:, 2] >> 2).astype(np.uint16)
    r = np.stack([
        ((b[:, 2] << 4) | (b[:, 3] >> 4)),
        ((b[:, 3] << 2) | (b[:, 4] >> 6)),
        b[:, 4],
        b[:, 5] >> 2,
        ((b[:, 5] << 4) | (b[:, 6] >> 4)),
        ((b[:, 6] << 2) | (b[:, 7] >> 6)),
        b[:, 7],
        b[:, 8] >> 2,
        ((b[:, 8] << 4) | (b[:, 9] >> 4)),
        ((b[:, 9] << 2) | (b[:, 10] >> 6)),
        b[:, 10],
        b[:, 11] >> 2,
        ((b[:, 11] << 4) | (b[:, 12] >> 4)),
        ((b[:, 12] << 2) | (b[:, 13] >> 6)),
        b[:, 13],
    ], axis=1) & np.uint16(0x3F)
    add = ((r.astype(np.int32) - 32) << shift[:, None].astype(np.int32))
    add = add.astype(np.uint16)                       # mod 2^16, as spec'd
    t = np.empty((b.shape[0], 16), np.uint16)
    t[:, 0] = anchor
    for dst, src, k in _CHAIN:
        t[:, dst] = t[:, src] + add[:, k]
    t = np.where(flat[:, None], anchor[:, None], t)
    return _inv(t)


def _tiles_to_plane(t16: np.ndarray, nx: int, ny: int) -> np.ndarray:
    """(ty*tx, 16) half bits in row-major tile order -> (ny, nx) uint16."""
    tx, ty = -(-nx // 4), -(-ny // 4)
    p = t16.reshape(ty, tx, 4, 4).swapaxes(1, 2).reshape(ty * 4, tx * 4)
    return p[:ny, :nx]


def _plane_to_tiles(plane: np.ndarray) -> np.ndarray:
    """(ny, nx) uint16 -> (ty*tx, 16), edge-clamped to 4x4 multiples."""
    ny, nx = plane.shape
    py, px = (-ny) % 4, (-nx) % 4
    p = np.pad(plane, ((0, py), (0, px)), mode="edge")
    ty, tx = p.shape[0] // 4, p.shape[1] // 4
    return p.reshape(ty, 4, tx, 4).swapaxes(1, 2).reshape(ty * tx, 16)


def decode_channel(raw: bytes, pos: int, nx: int, ny: int,
                   b44a: bool) -> tuple[np.ndarray, int]:
    """Decode one HALF channel's tile stream -> ((ny, nx) uint16, new pos)."""
    n_tiles = (-(-nx // 4)) * (-(-ny // 4))
    if not b44a:
        b = np.frombuffer(raw, np.uint8, n_tiles * 14, pos).reshape(-1, 14)
        flat = np.zeros(n_tiles, bool)
        pos += n_tiles * 14
    else:
        b = np.zeros((n_tiles, 14), np.uint8)
        flat = np.zeros(n_tiles, bool)
        for i in range(n_tiles):
            if pos + 3 > len(raw):
                raise ValueError("b44a: tile stream truncated")
            if raw[pos + 2] == 0xFC:
                b[i, :2] = np.frombuffer(raw, np.uint8, 2, pos)
                flat[i] = True
                pos += 3
            else:
                if pos + 14 > len(raw):
                    raise ValueError("b44a: tile stream truncated")
                b[i] = np.frombuffer(raw, np.uint8, 14, pos)
                pos += 14
    return _tiles_to_plane(_unpack_tiles(b, flat), nx, ny), pos


def _shift_round(x: np.ndarray, shift: int) -> np.ndarray:
    """OpenEXR shiftAndRound: nearest, ties resolved by the next bit."""
    x = x.astype(np.int32) << 1
    a = (1 << shift) - 1
    b = (x >> (shift + 1)) & 1
    return (x + a + b) >> (shift + 1)


# r[k] = d[a_k] - d[b_k] + 32, in stream order
_R_PAIRS = [(0, 4), (4, 8), (8, 12),
            (0, 1), (4, 5), (8, 9), (12, 13),
            (1, 2), (5, 6), (9, 10), (13, 14),
            (2, 3), (6, 7), (10, 11), (14, 15)]


def encode_channel(plane: np.ndarray, b44a: bool) -> bytes:
    """Encode a (ny, nx) uint16 half-bit plane as a B44(A) tile stream."""
    t = _fwd(_plane_to_tiles(np.ascontiguousarray(plane))).astype(np.int32)
    n = t.shape[0]
    t_max = t.max(axis=1)
    ia, ib = (np.array([p[0] for p in _R_PAIRS]),
              np.array([p[1] for p in _R_PAIRS]))
    shift_sel = np.full(n, -1, np.int32)
    d_sel = np.zeros((n, 16), np.int32)
    r_sel = np.zeros((n, 15), np.int32)
    for shift in range(17):
        d = _shift_round(t_max[:, None] - t, shift)
        r = d[:, ia] - d[:, ib] + 32
        ok = ((r >= 0) & (r <= 0x3F)).all(axis=1) & (shift_sel < 0)
        shift_sel = np.where(ok, shift, shift_sel)
        d_sel = np.where(ok[:, None], d, d_sel)
        r_sel = np.where(ok[:, None], r, r_sel)
    anchor = (t[:, 0] | 0) & 0xFFFF  # t[0] stored exactly
    s, r = shift_sel, r_sel
    b = np.empty((n, 14), np.uint8)
    b[:, 0] = anchor >> 8
    b[:, 1] = anchor & 0xFF
    b[:, 2] = (s << 2) | (r[:, 0] >> 4)
    b[:, 3] = (r[:, 0] << 4) | (r[:, 1] >> 2)
    b[:, 4] = (r[:, 1] << 6) | r[:, 2]
    b[:, 5] = (r[:, 3] << 2) | (r[:, 4] >> 4)
    b[:, 6] = (r[:, 4] << 4) | (r[:, 5] >> 2)
    b[:, 7] = (r[:, 5] << 6) | r[:, 6]
    b[:, 8] = (r[:, 7] << 2) | (r[:, 8] >> 4)
    b[:, 9] = (r[:, 8] << 4) | (r[:, 9] >> 2)
    b[:, 10] = (r[:, 9] << 6) | r[:, 10]
    b[:, 11] = (r[:, 11] << 2) | (r[:, 12] >> 4)
    b[:, 12] = (r[:, 12] << 4) | (r[:, 13] >> 2)
    b[:, 13] = (r[:, 13] << 6) | r[:, 14]
    if not b44a:
        return b.tobytes()
    flat = (r == 32).all(axis=1)
    b[flat, 2] = 0xFC
    keep = np.arange(14)[None, :] < np.where(flat, 3, 14)[:, None]
    return b[keep].tobytes()
