"""PIZ codec (OpenEXR compression type 4): encode and decode.

From-scratch numpy implementation, written from the OpenEXR file-format
description of the PIZ scheme (range-compaction LUT + hierarchical 2D
integer wavelet + canonical Huffman coding).  PIZ is implementation-defined
— its bitstream is "whatever ILM's transform produces" — so the arithmetic
below must match that transform bit-for-bit, but the code is organised the
way a numpy library wants to be: the wavelet runs vectorised over whole
strided planes per level, the LUTs are numpy gathers, and only the
inherently serial Huffman bit stream is a Python loop.

Parity context: the reference loads PIZ files through its vendored tinyexr
(src/core/bitmap_loader.cpp:13-53); this module plus core/exr.py replaces
that entire vendored stack.

Block layout (all little-endian), per 32-scanline block:
    u16 lo, u16 hi              occupied byte range of the presence bitmap
    u8  bitmap[hi - lo + 1]     only if lo <= hi; bit v&7 of byte v>>3 set
                                iff u16 value v occurs (v=0 never stored:
                                zero is implicitly always present)
    i32 hlen                    byte length of the Huffman section
    u8  huf[hlen]               see _entropy_* below
and the Huffman section is
    u32 lo_sym, u32 hi_sym      symbol range covered by the length table
    u32 table_bytes             length-table size (informational; parsing
                                is delimited by symbol count)
    u32 nbits                   number of payload bits
    u32 reserved
    packed code-length table, then the payload bit stream.
"""
from __future__ import annotations

import struct

import numpy as np

# ---------------------------------------------------------------------------
# Wavelet: hierarchical 2x2 integer butterflies, in place over a 2D plane.
#
# Two arithmetic flavours, selected by the post-LUT value range: a plain
# signed average/difference pair when everything fits in 14 bits, and a
# mod-2^16 offset variant otherwise.
# ---------------------------------------------------------------------------

_U16 = 0xFFFF
_BIAS = 0x8000


def _fwd14(a, b):
    """(a, b) -> (avg, diff), int16 wraparound semantics."""
    ai = a.astype(np.int16).astype(np.int32)
    bi = b.astype(np.int16).astype(np.int32)
    return ((ai + bi) >> 1).astype(np.uint16), (ai - bi).astype(np.uint16)


def _inv14(lo, hi):
    d = hi.astype(np.int16).astype(np.int32)
    a = lo.astype(np.int16).astype(np.int32) + (d & 1) + (d >> 1)
    return a.astype(np.uint16), (a - d).astype(np.uint16)


def _fwd16(a, b):
    ao = (a.astype(np.int32) + _BIAS) & _U16
    bi = b.astype(np.int32)
    avg = (ao + bi) >> 1
    d = ao - bi
    avg = np.where(d < 0, (avg + _BIAS) & _U16, avg)
    return avg.astype(np.uint16), (d & _U16).astype(np.uint16)


def _inv16(lo, hi):
    d = hi.astype(np.int32)
    b = (lo.astype(np.int32) - (d >> 1)) & _U16
    return ((d + b - _BIAS) & _U16).astype(np.uint16), b.astype(np.uint16)


def _levels(ny, nx):
    """Per-level pair distances, coarsest first: ..., 4, 2, 1 capped so the
    coarsest 2x2 block still fits the smaller plane dimension."""
    n = min(nx, ny)
    out = []
    p = 1
    while 2 * p <= n:
        out.append(p)
        p <<= 1
    return out[::-1]


def _wavelet_level(plane, p, butterfly, forward):
    """One hierarchical level over `plane` (uint16, 2D, possibly strided).

    Grid points sit at multiples of 2p; each full cell is the 2x2 quad
    {(y,x), (y,x+p), (y+p,x), (y+p,x+p)}.  A trailing column (when nx has
    bit p set) gets a vertical 1D pass, a trailing row a horizontal one;
    the far corner cell is untouched at this level.
    """
    ny, nx = plane.shape
    p2 = 2 * p
    r0 = slice(0, ny - p2 + 1, p2)
    r1 = slice(p, ny - p2 + 1 + p, p2)
    c0 = slice(0, nx - p2 + 1, p2)
    c1 = slice(p, nx - p2 + 1 + p, p2)
    q00, q01 = plane[r0, c0], plane[r0, c1]
    q10, q11 = plane[r1, c0], plane[r1, c1]
    if forward:
        t00, t01 = butterfly(q00, q01)          # horizontal first
        t10, t11 = butterfly(q10, q11)
        o00, o10 = butterfly(t00, t10)          # then vertical
        o01, o11 = butterfly(t01, t11)
    else:
        t00, t10 = butterfly(q00, q10)          # vertical first
        t01, t11 = butterfly(q01, q11)
        o00, o01 = butterfly(t00, t01)          # then horizontal
        o10, o11 = butterfly(t10, t11)
    plane[r0, c0], plane[r0, c1] = o00, o01
    plane[r1, c0], plane[r1, c1] = o10, o11
    if nx & p:                                  # odd column: vertical pairs
        xl = len(range(0, nx - p2 + 1, p2)) * p2
        a, b = butterfly(plane[r0, xl], plane[r1, xl])
        plane[r0, xl], plane[r1, xl] = a, b
    if ny & p:                                  # odd row: horizontal pairs
        yl = len(range(0, ny - p2 + 1, p2)) * p2
        a, b = butterfly(plane[yl, c0], plane[yl, c1])
        plane[yl, c0], plane[yl, c1] = a, b


def wavelet_encode(plane: np.ndarray, max_value: int) -> None:
    bf = _fwd14 if max_value < (1 << 14) else _fwd16
    for p in reversed(_levels(*plane.shape)):   # fine to coarse
        _wavelet_level(plane, p, bf, forward=True)


def wavelet_decode(plane: np.ndarray, max_value: int) -> None:
    bf = _inv14 if max_value < (1 << 14) else _inv16
    for p in _levels(*plane.shape):             # coarse to fine
        _wavelet_level(plane, p, bf, forward=False)


# ---------------------------------------------------------------------------
# Canonical Huffman codes.
#
# Code words are assigned from lengths alone: shorter codes are numerically
# higher when right-padded, and within one length codes increase with the
# symbol value — so only the length table travels in the file.
# ---------------------------------------------------------------------------

_NSYM = (1 << 16) + 1      # 16-bit data symbols + the run-length pseudo-symbol
_FASTBITS = 14             # direct-lookup prefix width for decoding
_FASTMASK = (1 << _FASTBITS) - 1
_MAXLEN = 58


def _codes_from_lengths(lengths: np.ndarray) -> np.ndarray:
    """lengths (_NSYM,) int -> canonical code values (int64)."""
    per_len = np.bincount(lengths, minlength=_MAXLEN + 1).astype(np.int64)
    first = np.zeros(_MAXLEN + 1, np.int64)
    acc = 0
    for ln in range(_MAXLEN, 0, -1):
        first[ln] = acc
        acc = (acc + int(per_len[ln])) >> 1
    syms = np.nonzero(lengths)[0]
    lns = lengths[syms]
    by_len = np.argsort(lns, kind="stable")     # grouped by length, sym asc
    sorted_lns = lns[by_len]
    group0 = np.searchsorted(sorted_lns, sorted_lns, side="left")
    codes = np.zeros(_NSYM, np.int64)
    codes[syms[by_len]] = first[sorted_lns] + np.arange(lns.size) - group0
    if np.any(codes[syms] >> lns):
        raise ValueError("piz: corrupt Huffman length table")
    return codes


def _build_lengths(freq: np.ndarray) -> np.ndarray:
    """Huffman code lengths from symbol frequencies (standard two-queue
    merge via a heap; ties broken by first-created)."""
    import heapq

    syms = np.nonzero(freq)[0]
    heap = [(int(freq[s]), i, [int(s)]) for i, s in enumerate(syms)]
    heapq.heapify(heap)
    lengths = np.zeros(_NSYM, np.int64)
    serial = len(heap)
    while len(heap) > 1:
        fa, _, members_a = heapq.heappop(heap)
        fb, _, members_b = heapq.heappop(heap)
        lengths[members_a] += 1
        lengths[members_b] += 1
        heapq.heappush(heap, (fa + fb, serial, members_a + members_b))
        serial += 1
    if np.any(lengths > _MAXLEN):
        raise ValueError("piz: Huffman tree too deep")
    return lengths


# Length-table wire format: 6 bits per symbol length, with zero runs packed
# as 59+(run-2) for runs of 2..5 and 63 followed by 8 bits of (run-6) for
# runs of 6..261.
_ZRUN_BASE = 59
_ZRUN_LONG = 63
_ZRUN_LONG_MIN = 6
_ZRUN_MAX = 255 + _ZRUN_LONG_MIN


def _read_length_table(buf, pos, end, lo_sym, hi_sym):
    lengths = np.zeros(_NSYM, np.int64)
    acc = 0
    nbits = 0
    s = lo_sym
    while s <= hi_sym:
        if nbits < 6:
            if pos >= end:
                raise ValueError("piz: length table truncated")
            acc = (acc << 8) | buf[pos]
            pos += 1
            nbits += 8
        nbits -= 6
        v = (acc >> nbits) & 63
        if v == _ZRUN_LONG:
            if nbits < 8:
                if pos >= end:
                    raise ValueError("piz: length table truncated")
                acc = (acc << 8) | buf[pos]
                pos += 1
                nbits += 8
            nbits -= 8
            run = ((acc >> nbits) & 255) + _ZRUN_LONG_MIN
            if s + run > hi_sym + 1:
                raise ValueError("piz: zero run past table end")
            s += run
        elif v >= _ZRUN_BASE:
            run = v - _ZRUN_BASE + 2
            if s + run > hi_sym + 1:
                raise ValueError("piz: zero run past table end")
            s += run
        else:
            lengths[s] = v
            s += 1
    return lengths, pos


def _write_length_table(put, lengths, lo_sym, hi_sym):
    s = lo_sym
    while s <= hi_sym:
        ln = int(lengths[s])
        if ln == 0:
            run = 1
            while (s + run <= hi_sym and run < _ZRUN_MAX
                   and lengths[s + run] == 0):
                run += 1
            if run >= _ZRUN_LONG_MIN:
                put(6, _ZRUN_LONG)
                put(8, run - _ZRUN_LONG_MIN)
                s += run
                continue
            if run >= 2:
                put(6, _ZRUN_BASE + run - 2)
                s += run
                continue
        put(6, ln)
        s += 1


# ---------------------------------------------------------------------------
# Entropy coding of the wavelet coefficients.
#
# The payload stream has one extra feature over plain Huffman: the highest
# symbol of the table is a run-length escape — after it, 8 raw bits give a
# count of extra repetitions of the previously emitted value.
# ---------------------------------------------------------------------------

_WORD = (1 << 64) - 1


def _decode_tables(lengths, codes):
    """Build the direct table (prefix -> packed len<<20|sym) and the spill
    lists for codes longer than _FASTBITS, bucketed by leading prefix."""
    fast = np.zeros(1 << _FASTBITS, np.int64)
    spill: dict[int, list] = {}
    syms = np.nonzero(lengths)[0]
    for s in syms.tolist():
        ln = int(lengths[s])
        code = int(codes[s])
        if ln <= _FASTBITS:
            base = code << (_FASTBITS - ln)
            fast[base:base + (1 << (_FASTBITS - ln))] = (ln << 20) | s
        else:
            spill.setdefault(code >> (ln - _FASTBITS), []).append(
                (s, ln, code))
    return fast.tolist(), spill


def _entropy_decode(buf, pos, end, nbits, lengths, codes, run_sym, n_out):
    if nbits < 0 or pos + ((nbits + 7) >> 3) > end:
        raise ValueError("piz: Huffman payload truncated")
    end = pos + ((nbits + 7) >> 3)
    fast, spill = _decode_tables(lengths, codes)
    out: list[int] = []
    acc = 0
    have = 0
    i = pos
    while i < end:
        acc = ((acc << 8) | buf[i]) & _WORD
        i += 1
        have += 8
        while have >= _FASTBITS:
            entry = fast[(acc >> (have - _FASTBITS)) & _FASTMASK]
            if entry:
                have -= entry >> 20
                sym = entry & 0xFFFFF
            else:
                bucket = spill.get((acc >> (have - _FASTBITS)) & _FASTMASK)
                if not bucket:
                    raise ValueError("piz: invalid code word")
                for sym, ln, code in bucket:
                    while have < ln and i < end:
                        acc = ((acc << 8) | buf[i]) & _WORD
                        i += 1
                        have += 8
                    if have >= ln and code == (
                            (acc >> (have - ln)) & ((1 << ln) - 1)):
                        have -= ln
                        break
                else:
                    raise ValueError("piz: invalid long code word")
            if sym == run_sym:
                if have < 8:
                    if i >= end:
                        raise ValueError("piz: run escape truncated")
                    acc = ((acc << 8) | buf[i]) & _WORD
                    i += 1
                    have += 8
                have -= 8
                rep = (acc >> have) & 0xFF
                if not out or len(out) + rep > n_out:
                    raise ValueError("piz: run overflows output")
                out.extend([out[-1]] * rep)
            else:
                if len(out) >= n_out:
                    raise ValueError("piz: output overflow")
                out.append(sym)
    # Residual bits: the final byte was padded on the right, so trim the
    # pad and decode the remaining (necessarily short) codes.
    pad = (8 - nbits) & 7
    acc >>= pad
    have -= pad
    while have > 0:
        entry = fast[(acc << (_FASTBITS - have)) & _FASTMASK]
        if not entry:
            raise ValueError("piz: invalid trailing code word")
        have -= entry >> 20
        sym = entry & 0xFFFFF
        if sym == run_sym:
            if have < 8:
                raise ValueError("piz: run escape truncated")
            have -= 8
            rep = (acc >> have) & 0xFF
            if not out or len(out) + rep > n_out:
                raise ValueError("piz: run overflows output")
            out.extend([out[-1]] * rep)
        else:
            if len(out) >= n_out:
                raise ValueError("piz: output overflow")
            out.append(sym)
    if len(out) != n_out:
        raise ValueError(f"piz: decoded {len(out)} of {n_out} values")
    return np.asarray(out, np.uint16)


def _entropy_encode(values: np.ndarray) -> bytes:
    """Huffman-compress a uint16 coefficient stream -> the full Huffman
    section (header + length table + payload)."""
    v64 = values.astype(np.int64)
    freq = np.bincount(v64, minlength=_NSYM)
    lo_sym = int(np.nonzero(freq)[0][0])
    run_sym = int(np.nonzero(freq)[0][-1]) + 1   # pseudo-symbol for runs
    freq[run_sym] = 1
    hi_sym = run_sym
    lengths = _build_lengths(freq)
    codes = _codes_from_lengths(lengths)

    chunks = bytearray()
    state = [0, 0]                               # bit accumulator, fill

    def put(nb, val):
        acc = (state[0] << nb) | val
        fill = state[1] + nb
        while fill >= 8:
            fill -= 8
            chunks.append((acc >> fill) & 0xFF)
        state[0] = acc & ((1 << fill) - 1) if fill else 0
        state[1] = fill

    _write_length_table(put, lengths, lo_sym, hi_sym)
    if state[1]:
        chunks.append((state[0] << (8 - state[1])) & 0xFF)
        state[0] = state[1] = 0
    table_bytes = len(chunks)

    # Payload: run-length segment the data, then emit either literal
    # repeats or the run escape, whichever is shorter.
    run_len = int(lengths[run_sym])
    run_code = int(codes[run_sym])
    edges = np.nonzero(np.diff(v64))[0]
    starts = np.concatenate([[0], edges + 1])
    counts = np.diff(np.append(starts, v64.size))
    for sym, total in zip(v64[starts].tolist(), counts.tolist()):
        s_len = int(lengths[sym])
        s_code = int(codes[sym])
        while total > 0:
            n = min(total, 256)
            total -= n
            if s_len + run_len + 8 < s_len * (n - 1):
                put(s_len, s_code)
                put(run_len, run_code)
                put(8, n - 1)
            else:
                for _ in range(n):
                    put(s_len, s_code)
    nbits = 8 * (len(chunks) - table_bytes) + state[1]
    if state[1]:
        chunks.append((state[0] << (8 - state[1])) & 0xFF)
    header = struct.pack("<5I", lo_sym, hi_sym, table_bytes, nbits, 0)
    return header + bytes(chunks)


def _entropy_section(buf, pos, end, n_out):
    if pos + 20 > end:
        raise ValueError("piz: Huffman header truncated")
    lo_sym, hi_sym, _tbytes, nbits, _ = struct.unpack_from("<5I", buf, pos)
    pos += 20
    if not (0 <= lo_sym < _NSYM and 0 <= hi_sym < _NSYM):
        raise ValueError("piz: Huffman symbol range out of bounds")
    lengths, pos = _read_length_table(buf, pos, end, lo_sym, hi_sym)
    codes = _codes_from_lengths(lengths)
    return _entropy_decode(buf, pos, end, nbits, lengths, codes, hi_sym,
                           n_out)


# ---------------------------------------------------------------------------
# Range compaction: map the u16 values that actually occur to a dense
# 0..max_value range (better wavelet/Huffman behaviour), via a presence
# bitmap stored in the block header.  Zero is always implicitly present.
# ---------------------------------------------------------------------------

def _dense_from_bitmap(bitmap_bits: np.ndarray):
    """bitmap_bits: (65536,) bool -> (dense->value LUT, max_value)."""
    bitmap_bits = bitmap_bits.copy()
    bitmap_bits[0] = True
    values = np.nonzero(bitmap_bits)[0].astype(np.uint16)
    lut = np.zeros(1 << 16, np.uint16)
    lut[:values.size] = values
    return lut, values.size - 1


# ---------------------------------------------------------------------------
# Block API.  Channels are planar uint16 arrays of shape (ny, nx * size)
# where size is the number of u16 words per sample (1 = HALF, 2 = FLOAT
# or UINT); sample x of channel c occupies words [x*size, (x+1)*size).
# ---------------------------------------------------------------------------

def compress_block(channels: list[np.ndarray], sizes: list[int]) -> bytes:
    """channels[i]: uint16 (ny_i, nx_i * sizes[i]); returns the PIZ block."""
    flat = np.concatenate([np.ascontiguousarray(ch, np.uint16).ravel()
                           for ch in channels])
    present = np.zeros(1 << 16, bool)
    present[flat] = True
    present[0] = False
    bitmap = np.packbits(present, bitorder="little")
    occupied = np.nonzero(bitmap)[0]
    if occupied.size:
        lo_b, hi_b = int(occupied[0]), int(occupied[-1])
        bm_bytes = bitmap[lo_b:hi_b + 1].tobytes()
    else:
        lo_b, hi_b = len(bitmap) - 1, 0
        bm_bytes = b""

    present[0] = True
    vals = np.nonzero(present)[0]
    dense = np.zeros(1 << 16, np.uint16)
    dense[vals] = np.arange(vals.size, dtype=np.uint16)
    max_value = vals.size - 1
    flat = dense[flat]

    off = 0
    for ch, size in zip(channels, sizes):
        ny, row = ch.shape
        nx = row // size
        n = ny * row
        view = flat[off:off + n].reshape(ny, nx, size)
        for w in range(size):
            wavelet_encode(view[:, :, w], max_value)
        off += n

    huf = _entropy_encode(flat)
    return (struct.pack("<HH", lo_b, hi_b) + bm_bytes
            + struct.pack("<i", len(huf)) + huf)


def decompress_block(block: bytes, shapes: list[tuple[int, int, int]]
                     ) -> list[np.ndarray]:
    """shapes[i] = (ny, nx, size); returns uint16 arrays (ny, nx * size)."""
    buf = block
    end = len(buf)
    if end < 4:
        raise ValueError("piz: block header truncated")
    lo_b, hi_b = struct.unpack_from("<HH", buf, 0)
    pos = 4
    bitmap_bits = np.zeros(1 << 16, bool)
    if hi_b >= (1 << 13):
        raise ValueError("piz: bitmap range out of bounds")
    if lo_b <= hi_b:
        nb = hi_b - lo_b + 1
        if pos + nb > end:
            raise ValueError("piz: bitmap truncated")
        chunk = np.frombuffer(buf, np.uint8, nb, pos)
        bits = np.unpackbits(chunk, bitorder="little")
        bitmap_bits[8 * lo_b:8 * lo_b + bits.size] = bits
        pos += nb
    lut, max_value = _dense_from_bitmap(bitmap_bits)

    if pos + 4 > end:
        raise ValueError("piz: block length field truncated")
    (hlen,) = struct.unpack_from("<i", buf, pos)
    pos += 4
    if hlen < 0 or pos + hlen > end:
        raise ValueError("piz: Huffman section truncated")

    total = sum(ny * nx * size for ny, nx, size in shapes)
    flat = _entropy_section(buf, pos, pos + hlen, total)

    out = []
    off = 0
    for ny, nx, size in shapes:
        n = ny * nx * size
        chan = flat[off:off + n].reshape(ny, nx, size)
        for w in range(size):
            wavelet_decode(chan[:, :, w], max_value)
        out.append(lut[chan.reshape(ny, nx * size)])
        off += n
    return out
