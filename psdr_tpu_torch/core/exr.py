"""OpenEXR scanline codec (numpy): read/write NONE/RLE/ZIPS/ZIP/PIZ/PXR24/
B44/B44A.

Replaces the reference's vendored tinyexr + miniz (~18k LoC;
src/core/bitmap_loader.cpp:13-53 ``load_openexr_rgba``) with a compact
implementation of the subset a differentiable renderer needs: RGB(A)/Y
scanline images, HALF or FLOAT channels.  Compression coverage is a
superset of the reference's (tinyexr reads NONE/RLE/ZIPS/ZIP/PIZ; PXR24
and B44/B44A are extra).  DWA remains unsupported, as in the reference.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from . import b44, piz

_MAGIC = 0x01312F76
_PIXEL_TYPES = {0: np.uint32, 1: np.float16, 2: np.float32}
_COMPRESSION_NAMES = {0: "none", 1: "rle", 2: "zips", 3: "zip", 4: "piz",
                      5: "pxr24", 6: "b44", 7: "b44a", 8: "dwaa", 9: "dwab"}
_LINES_PER_BLOCK = {0: 1, 1: 1, 2: 1, 3: 16, 4: 32, 5: 16, 6: 32, 7: 32}


def _read_attrs(buf: memoryview, pos: int):
    attrs = {}
    while True:
        end = bytes(buf[pos:pos + 256]).index(b"\0") + pos
        name = bytes(buf[pos:end]).decode()
        pos = end + 1
        if not name:
            return attrs, pos
        end = bytes(buf[pos:pos + 256]).index(b"\0") + pos
        typ = bytes(buf[pos:end]).decode()
        pos = end + 1
        size = struct.unpack_from("<I", buf, pos)[0]
        pos += 4
        attrs[name] = (typ, bytes(buf[pos:pos + size]))
        pos += size


def _parse_channels(raw: bytes):
    chans = []
    pos = 0
    while raw[pos] != 0:
        end = raw.index(b"\0", pos)
        name = raw[pos:end].decode()
        pos = end + 1
        ptype, _lin, _xs, ys = struct.unpack_from("<IIII", raw, pos)
        # layout: pixel_type(4) pLinear+reserved(4) xSampling(4) ySampling(4)
        pos += 16
        chans.append((name, _PIXEL_TYPES[ptype]))
    return chans


def _unpredict(data: bytes) -> bytes:
    """OpenEXR zip/rle reconstruction: byte-delta decode, de-interleave."""
    arr = np.frombuffer(bytes(data), np.uint8).astype(np.int64)
    arr[1:] -= 128
    arr = np.cumsum(arr).astype(np.uint8)
    n = arr.shape[0]
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[0::2] = arr[:half]
    out[1::2] = arr[half:]
    return out.tobytes()


def _predict(data: bytes) -> bytes:
    arr = np.frombuffer(data, np.uint8)
    n = arr.shape[0]
    half = (n + 1) // 2
    inter = np.concatenate([arr[0::2], arr[1::2]])
    d = inter.astype(np.int64)
    d[1:] = d[1:] - d[:-1] + 128
    return d.astype(np.uint8).tobytes()


# ---------------------------------------------------------------------------
# RLE (compression 1): predictor + interleave as for zip, then a byte-level
# run-length code — control byte c>=128 means 256-c literal bytes follow,
# c<128 means one byte follows repeated c+1 times.
# ---------------------------------------------------------------------------

def _rle_decode(src: bytes, n_out: int) -> bytes:
    out = bytearray()
    i = 0
    n = len(src)
    while i < n:
        c = src[i]
        if c > 127:
            cnt = 256 - c
            i += 1
            if i + cnt > n:
                raise ValueError("rle: literal run truncated")
            out += src[i:i + cnt]
            i += cnt
        else:
            if i + 1 >= n:
                raise ValueError("rle: repeat run truncated")
            out += src[i + 1:i + 2] * (c + 1)
            i += 2
        if len(out) > n_out:
            raise ValueError("rle: output overflow")
    if len(out) != n_out:
        raise ValueError("rle: short output")
    return _unpredict(bytes(out))


def _rle_encode(raw: bytes) -> bytes:
    data = _predict(raw)
    arr = np.frombuffer(data, np.uint8)
    # maximal equal runs
    edges = np.nonzero(np.diff(arr))[0]
    starts = np.concatenate([[0], edges + 1])
    counts = np.diff(np.append(starts, arr.size))
    out = bytearray()
    lit = bytearray()

    def flush_literals():
        k = 0
        while k < len(lit):
            n = min(127, len(lit) - k)
            out.append(256 - n)
            out.extend(lit[k:k + n])
            k += n
        lit.clear()

    for val, cnt in zip(arr[starts].tolist(), counts.tolist()):
        if cnt >= 3:
            flush_literals()
            while cnt > 0:
                n = min(128, cnt)
                out.append(n - 1)
                out.append(val)
                cnt -= n
        else:
            lit += bytes([val]) * cnt
    flush_literals()
    return bytes(out)


# ---------------------------------------------------------------------------
# PXR24 (compression 5): floats rounded to 24 bits, per-channel-scanline
# byte planes with a running pixel difference, then zlib.
# ---------------------------------------------------------------------------

def _f32_to_f24(u: np.ndarray) -> np.ndarray:
    """Round float32 bit patterns (uint32) to 24-bit floats (top 3 bytes)."""
    s = u & np.uint32(0x80000000)
    e = u & np.uint32(0x7F800000)
    m = u & np.uint32(0x007FFFFF)
    is_special = e == np.uint32(0x7F800000)
    mn = m >> np.uint32(8)
    spec = (e >> np.uint32(8)) | mn | (mn == 0).astype(np.uint32)
    spec = np.where(m != 0, spec, e >> np.uint32(8))     # NaN keeps a bit; inf doesn't
    fin = ((e | m) + (m & np.uint32(0x80))) >> np.uint32(8)
    fin = np.where(fin >= 0x7F8000, (e | m) >> np.uint32(8), fin)
    return (s >> np.uint32(8)) | np.where(is_special, spec, fin)


def _pxr24_planes(vals: np.ndarray, typ) -> list[np.ndarray]:
    """Per-scanline channel data -> list of byte planes, MSB first."""
    if typ is np.float32:
        v24 = _f32_to_f24(vals.view(np.uint32))
        d = np.empty_like(v24)
        d[0] = v24[0]
        d[1:] = v24[1:] - v24[:-1]
        return [((d >> 16) & 0xFF).astype(np.uint8),
                ((d >> 8) & 0xFF).astype(np.uint8),
                (d & 0xFF).astype(np.uint8)]
    if typ is np.float16:
        v = vals.view(np.uint16).astype(np.uint32)
        d = np.empty_like(v)
        d[0] = v[0]
        d[1:] = v[1:] - v[:-1]
        return [((d >> 8) & 0xFF).astype(np.uint8),
                (d & 0xFF).astype(np.uint8)]
    v = vals.view(np.uint32)
    d = np.empty_like(v)
    d[0] = v[0]
    d[1:] = v[1:] - v[:-1]
    return [((d >> 24) & 0xFF).astype(np.uint8),
            ((d >> 16) & 0xFF).astype(np.uint8),
            ((d >> 8) & 0xFF).astype(np.uint8),
            (d & 0xFF).astype(np.uint8)]


def _pxr24_unplane(raw: bytes, pos: int, width: int, typ):
    """Inverse of _pxr24_planes; returns (float32 scanline, new pos)."""
    nb = {np.float32: 3, np.float16: 2, np.uint32: 4}[typ]
    planes = [np.frombuffer(raw, np.uint8, width, pos + k * width)
              .astype(np.uint64) for k in range(nb)]
    pos += nb * width
    d = np.zeros(width, np.uint64)
    for p in planes:
        d = (d << np.uint64(8)) | p
    v = np.cumsum(d)
    if typ is np.float32:
        v = ((v << np.uint64(8)) & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        return v.view(np.float32).astype(np.float32), pos
    if typ is np.float16:
        v = (v & np.uint64(0xFFFF)).astype(np.uint16)
        return v.view(np.float16).astype(np.float32), pos
    v = (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return v.astype(np.float32), pos


def _tile_counts(width: int, height: int, tiledesc: bytes):
    """Chunk count across all levels + level-0 tile grid, from a tiledesc
    attribute (xSize u32, ySize u32, mode u8: levelMode + roundingMode*16).
    Covers ONE_LEVEL, MIPMAP, and RIPMAP level layouts; the reader consumes
    level (0,0) and skips the rest."""
    tx, ty, mode = struct.unpack("<IIB", tiledesc[:9])
    level_mode = mode & 0xF
    round_up = (mode >> 4) & 0xF == 1

    def n_levels(extent):
        # ROUND_DOWN: floor(log2(e))+1 levels; ROUND_UP: ceil(log2(e))+1
        n = extent.bit_length()
        if round_up and (extent & (extent - 1)) != 0:
            n += 1
        return n

    def level_size(extent, lv):
        return max(1, -(-extent // (1 << lv)) if round_up else extent >> lv)

    def n_tiles(extent, lv, tsz):
        return -(-level_size(extent, lv) // tsz)

    if level_mode == 0:
        return (-(-width // tx)) * (-(-height // ty)), tx, ty
    if level_mode == 2:  # RIPMAP: independent x/y level grids
        total = sum(n_tiles(width, lx, tx) * n_tiles(height, ly, ty)
                    for lx in range(n_levels(width))
                    for ly in range(n_levels(height)))
        return total, tx, ty
    total = sum(n_tiles(width, lv, tx) * n_tiles(height, lv, ty)
                for lv in range(n_levels(max(width, height))))
    return total, tx, ty


def read_exr(path: str) -> np.ndarray:
    """Load a scanline or tiled (ONE_LEVEL / MIPMAP level 0) EXR as float32
    (H, W, C); channel order RGB(A) or Y."""
    with open(path, "rb") as f:
        data = memoryview(f.read())
    magic, version = struct.unpack_from("<II", data, 0)
    if magic != _MAGIC:
        raise ValueError(f"{path}: not an OpenEXR file")
    attrs, pos = _read_attrs(data, 8)
    if version & 0x200 or "tiles" in attrs:
        return _read_tiled(path, data, attrs, pos)

    comp = attrs["compression"][1][0]
    if comp not in _LINES_PER_BLOCK:
        raise ValueError(
            f"{path}: {_COMPRESSION_NAMES.get(comp, comp)} compression not "
            "supported (supported: none, rle, zips, zip, piz, pxr24, "
            "b44, b44a)")
    x0, y0, x1, y1 = struct.unpack("<4i", attrs["dataWindow"][1])
    width, height = x1 - x0 + 1, y1 - y0 + 1
    chans = _parse_channels(attrs["channels"][1])  # alphabetical in file

    lines_pb = _LINES_PER_BLOCK[comp]
    n_blocks = -(-height // lines_pb)
    pos += 8 * n_blocks  # skip offset table; blocks are sequential

    planes = {name: np.empty((height, width), np.float32) for name, _ in chans}
    for _ in range(n_blocks):
        y, size = struct.unpack_from("<iI", data, pos)
        pos += 8
        raw = bytes(data[pos:pos + size])
        pos += size
        ny = min(lines_pb, y1 - y + 1)
        decoded = _decode_chunk(raw, chans, width, ny, comp)
        for name, _ in chans:
            planes[name][y - y0:y - y0 + ny] = decoded[name]
    return _assemble(planes, chans)


def _decode_chunk(raw: bytes, chans, nx: int, ny: int, comp: int):
    """Decode one compressed chunk (scanline block or tile) into a dict of
    (ny, nx) float32 channel planes. Shared by the scanline and tiled
    readers; nx is the block's pixel width (tile width for tiles)."""
    out = {}
    bytes_per_line = sum(np.dtype(t).itemsize for _, t in chans) * nx
    expect = bytes_per_line * ny
    if len(raw) >= expect:  # stored raw: scanline interleave
        off = 0
        planes = {n: np.empty((ny, nx), np.float32) for n, _ in chans}
        for line in range(ny):
            for name, typ in chans:
                nb = np.dtype(typ).itemsize * nx
                planes[name][line] = np.frombuffer(
                    raw[off:off + nb], typ).astype(np.float32)
                off += nb
        return planes
    if comp == 4:  # PIZ
        shapes = [(ny, nx, np.dtype(t).itemsize // 2) for _, t in chans]
        decoded = piz.decompress_block(raw, shapes)
        for (name, typ), plane in zip(chans, decoded):
            out[name] = np.frombuffer(plane.tobytes(), typ).reshape(
                ny, nx).astype(np.float32)
        return out
    if comp in (6, 7):  # B44(A)
        off = 0
        for name, typ in chans:
            if typ is np.float16:
                p16, off = b44.decode_channel(raw, off, nx, ny, comp == 7)
                out[name] = p16.view(np.float16).astype(np.float32)
            else:
                nb = np.dtype(typ).itemsize * nx * ny
                out[name] = np.frombuffer(raw[off:off + nb], typ).reshape(
                    ny, nx).astype(np.float32)
                off += nb
        return out
    if comp == 5:  # PXR24
        raw = zlib.decompress(raw)
        off = 0
        for name, _ in chans:
            out[name] = np.empty((ny, nx), np.float32)
        for line in range(ny):
            for name, typ in chans:
                vals, off = _pxr24_unplane(raw, off, nx, typ)
                out[name][line] = vals
        return out
    if comp == 1:
        raw = _rle_decode(raw, expect)
    elif comp in (2, 3):
        raw = _unpredict(zlib.decompress(raw))
    off = 0
    for name, _ in chans:
        out[name] = np.empty((ny, nx), np.float32)
    for line in range(ny):
        for name, typ in chans:
            nb = np.dtype(typ).itemsize * nx
            out[name][line] = np.frombuffer(
                raw[off:off + nb], typ).astype(np.float32)
            off += nb
    return out


def _assemble(planes, chans):
    names = [n for n, _ in chans]
    for order in ("RGBA", "RGB", "Y"):
        if sorted(order) == sorted(names):
            return np.stack([planes[c] for c in order], axis=-1)
    return np.stack([planes[c] for c in sorted(names)], axis=-1)


def _read_tiled(path: str, data: memoryview, attrs: dict, pos: int):
    """Tiled EXR reader: ONE_LEVEL fully; MIPMAP reads level (0,0) and
    skips the rest (tinyexr parity: the reference loads tiled images too).
    Chunk = tileX i32, tileY i32, levelX i32, levelY i32, size u32, data."""
    comp = attrs["compression"][1][0]
    if comp not in _LINES_PER_BLOCK:
        raise ValueError(f"{path}: unsupported tiled compression {comp}")
    x0, y0, x1, y1 = struct.unpack("<4i", attrs["dataWindow"][1])
    width, height = x1 - x0 + 1, y1 - y0 + 1
    chans = _parse_channels(attrs["channels"][1])
    n_chunks, tx, ty = _tile_counts(width, height, attrs["tiles"][1])
    pos += 8 * n_chunks  # offset table; chunks follow sequentially
    planes = {name: np.zeros((height, width), np.float32)
              for name, _ in chans}
    for _ in range(n_chunks):
        tix, tiy, lx, ly = struct.unpack_from("<4i", data, pos)
        size = struct.unpack_from("<I", data, pos + 16)[0]
        raw = bytes(data[pos + 20:pos + 20 + size])
        pos += 20 + size
        if lx != 0 or ly != 0:
            continue  # mip levels beyond (0,0)
        px, py = tix * tx, tiy * ty
        nx = min(tx, width - px)
        ny = min(ty, height - py)
        decoded = _decode_chunk(raw, chans, nx, ny, comp)
        for name, _ in chans:
            planes[name][py:py + ny, px:px + nx] = decoded[name]
    return _assemble(planes, chans)


_WRITE_COMP = {"none": 0, "rle": 1, "zips": 2, "zip": 3, "piz": 4,
               "pxr24": 5, "b44": 6, "b44a": 7}


def _encode_region(region: np.ndarray, names, src, dtype, comp_id: int,
                   half: bool) -> bytes:
    """Compress one pixel region (ny, nx, C) as a chunk payload."""
    ny, nx = region.shape[:2]
    raw = b"".join(
        region[line, :, src[n]].astype(dtype).tobytes()
        for line in range(ny) for n in names)
    if comp_id == 4:
        words = np.dtype(dtype).itemsize // 2
        chans16 = [
            np.frombuffer(region[:, :, src[n]].astype(dtype).tobytes(),
                          np.uint16).reshape(ny, nx * words)
            for n in names]
        packed = piz.compress_block(chans16, [words] * len(names))
    elif comp_id in (6, 7):
        parts = []
        for n in names:
            ch = region[:, :, src[n]].astype(dtype)
            if half:
                parts.append(b44.encode_channel(
                    ch.view(np.uint16), comp_id == 7))
            else:  # non-HALF channels are stored planar, uncompressed
                parts.append(ch.tobytes())
        packed = b"".join(parts)
    elif comp_id == 5:
        parts = []
        for line in range(ny):
            for n in names:
                vals = region[line, :, src[n]].astype(dtype)
                parts.extend(p.tobytes() for p in _pxr24_planes(vals, dtype))
        packed = zlib.compress(b"".join(parts))
    elif comp_id == 1:
        packed = _rle_encode(raw)
    elif comp_id in (2, 3):
        packed = zlib.compress(_predict(raw))
    else:
        packed = raw
    if comp_id != 0 and len(packed) >= len(raw):
        packed = raw
    return packed


def _level_extents(width: int, height: int, level_mode: int, round_up: bool):
    """(lx, ly, w, h) for every level of a tiled image, in file order."""
    def n_levels(extent):
        n = extent.bit_length()
        if round_up and (extent & (extent - 1)) != 0:
            n += 1
        return n

    def size(extent, lv):
        return max(1, -(-extent // (1 << lv)) if round_up else extent >> lv)

    if level_mode == 0:
        return [(0, 0, width, height)]
    if level_mode == 2:  # RIPMAP
        return [(lx, ly, size(width, lx), size(height, ly))
                for ly in range(n_levels(height))
                for lx in range(n_levels(width))]
    return [(lv, lv, size(width, lv), size(height, lv))
            for lv in range(n_levels(max(width, height)))]


def write_exr(path: str, img: np.ndarray, compression: str = "zip",
              half: bool = False, tile: int | None = None,
              level_mode: str = "one", round_up: bool = False) -> None:
    """Write (H, W, C) float array; C in {1 (Y), 3 (RGB), 4 (RGBA)}.
    ``tile``: write a tiled file with square tiles of that size instead of
    scanline blocks. ``level_mode`` (tiled only): "one" (single level),
    "mipmap" or "ripmap" — levels beyond (0,0) are nearest-sample
    downscaled (level sizes follow the chosen rounding mode; level
    content beyond (0,0) is advisory for this writer). The reference's tinyexr cannot write tiles at all
    (bitmap_loader.cpp wraps its scanline save path only)."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    height, width, nc = img.shape
    names = {1: ["Y"], 3: ["B", "G", "R"], 4: ["A", "B", "G", "R"]}[nc]
    src = {1: {"Y": 0}, 3: {"R": 0, "G": 1, "B": 2},
           4: {"R": 0, "G": 1, "B": 2, "A": 3}}[nc]
    dtype = np.float16 if half else np.float32
    ptype = 1 if half else 2
    comp_id = _WRITE_COMP[compression]
    lines_pb = _LINES_PER_BLOCK[comp_id]

    def attr(name, typ, val):
        return (name.encode() + b"\0" + typ.encode() + b"\0"
                + struct.pack("<I", len(val)) + val)

    chan_raw = b"".join(
        n.encode() + b"\0" + struct.pack("<IIII", ptype, 0, 1, 1)
        for n in names) + b"\0"
    dw = struct.pack("<4i", 0, 0, width - 1, height - 1)
    header = struct.pack("<II", _MAGIC, 2 | (0x200 if tile else 0))
    header += attr("channels", "chlist", chan_raw)
    header += attr("compression", "compression", bytes([comp_id]))
    header += attr("dataWindow", "box2i", dw)
    header += attr("displayWindow", "box2i", dw)
    header += attr("lineOrder", "lineOrder", b"\0")
    header += attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0))
    header += attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    lv_mode = {"one": 0, "mipmap": 1, "ripmap": 2}[level_mode]
    if tile:
        header += attr("tiles", "tiledesc",
                       struct.pack("<IIB", tile, tile,
                                   lv_mode | (16 if round_up else 0)))
    header += b"\0"

    blocks = []
    if tile:
        for lx, ly, w, h in _level_extents(width, height, lv_mode, round_up):
            if (lx, ly) == (0, 0):
                lvl = img
            else:  # nearest-sample downscale; level content is advisory
                ys = np.minimum((np.arange(h) * height) // h, height - 1)
                xs = np.minimum((np.arange(w) * width) // w, width - 1)
                lvl = img[ys][:, xs]
            for tiy in range(-(-h // tile)):
                for tix in range(-(-w // tile)):
                    py, px = tiy * tile, tix * tile
                    region = lvl[py:py + tile, px:px + tile]
                    packed = _encode_region(region, names, src, dtype,
                                            comp_id, half)
                    blocks.append((struct.pack("<4i", tix, tiy, lx, ly),
                                   packed))
    else:
        for b in range(-(-height // lines_pb)):
            y = b * lines_pb
            region = img[y:y + lines_pb]
            packed = _encode_region(region, names, src, dtype, comp_id, half)
            blocks.append((struct.pack("<i", y), packed))

    out = bytearray(header)
    table_pos = len(out)
    out += b"\0" * (8 * len(blocks))
    offsets = []
    for head, packed in blocks:
        offsets.append(len(out))
        out += head + struct.pack("<I", len(packed)) + packed
    for i, off in enumerate(offsets):
        struct.pack_into("<Q", out, table_pos + 8 * i, off)
    with open(path, "wb") as f:
        f.write(bytes(out))
