"""Image I/O (SURVEY.md §2 row R12 — the reference writes BMP/PPM from C++).

A minimal PNG codec on zlib + struct: 8-bit RGB, written unfiltered;
reading accepts 8-bit gray/RGB/RGBA (non-interlaced) with any of the five
PNG row filters, which covers what this package writes and the golden
images it ships.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}     # PNG color type → samples per pixel


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def save_png(path, image):
    """(H, W, 3) float [0,1] or uint8 → PNG file."""
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    h, w, _ = arr.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           arr.reshape(h, w * 3)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIG + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _chunk(b"IEND", b""))
    return path


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype = raw[y * (stride + 1)]
        line = raw[y * (stride + 1) + 1:(y + 1) * (stride + 1)].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        else:
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                c = prev[x - bpp] if x >= bpp else 0
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + b) // 2
                else:                               # 4: Paeth
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[x] = (line[x] + pred) & 0xFF
        out[y] = cur
        prev = cur
    return out


def load_png(path, dtype=np.float32):
    """PNG file → (H, W, 3) float [0,1] (or uint8 if dtype=np.uint8)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"{path}: unsupported PNG (depth {depth}, color "
                         f"type {ctype}, interlace {interlace})")
    ch = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    arr = _unfilter(raw, h, w * ch, ch).reshape(h, w, ch)
    arr = np.repeat(arr, 3, axis=2) if ch == 1 else arr[..., :3]
    if dtype == np.uint8:
        return arr
    return arr.astype(dtype) / 255.0
