"""Minimal PNG codec on the standard library's zlib and numpy.

Reads 8-bit grayscale, RGB and RGBA images, non-interlaced, with all five
scanline filter types (PNG spec section 9); writes 8-bit RGB or RGBA with
filter type 0. It stands in for Pillow, which the serving machines lack.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # color type -> samples per pixel


def _chunks(data: bytes):
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        ctype = data[pos + 4 : pos + 8]
        yield ctype, data[pos + 8 : pos + 8 + length]
        pos += 12 + length


def _header(ihdr: bytes):
    width, height, depth, color, _, _, interlace = struct.unpack(">IIBBBBB", ihdr)
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"unsupported PNG (bit depth {depth}, color type {color}, "
            f"interlace {interlace}); only 8-bit gray/RGB/RGBA, non-interlaced"
        )
    return width, height, _CHANNELS[color]


def read_png_size(path: str) -> tuple[int, int]:
    """(width, height) from the IHDR chunk, without decoding pixels."""
    with open(path, "rb") as f:
        head = f.read(33)
    if head[:8] != _SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    width, height = struct.unpack(">II", head[16:24])
    return width, height


def _unfilter_sequential(ftype: int, cur: bytearray, up: bytes, bpp: int):
    """Average (3) and Paeth (4) depend on the reconstructed left byte."""
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = up[i]
        if ftype == 3:
            cur[i] = (cur[i] + ((a + b) >> 1)) & 0xFF
        else:
            c = up[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
            cur[i] = (cur[i] + pred) & 0xFF


def read_png(path: str) -> np.ndarray:
    """Decode to uint8 (H, W, C) with C = 1 (gray), 3 (RGB) or 4 (RGBA)."""
    with open(path, "rb") as f:
        data = f.read()
    width = height = bpp = None
    idat = []
    for ctype, body in _chunks(data):
        if ctype == b"IHDR":
            width, height, bpp = _header(body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if width is None:
        raise ValueError(f"{path}: PNG without IHDR")
    raw = zlib.decompress(b"".join(idat))
    stride = width * bpp
    if len(raw) != height * (stride + 1):
        raise ValueError(f"{path}: truncated PNG image data")
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        ftype, line = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:  # Sub: running sum per channel, mod 256
            cur = np.cumsum(line.reshape(width, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            cur = line + prev
        elif ftype in (3, 4):
            buf = bytearray(line.tobytes())
            _unfilter_sequential(ftype, buf, prev.tobytes(), bpp)
            cur = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"{path}: bad PNG filter type {ftype}")
        out[y] = cur
        prev = out[y]
    return out.reshape(height, width, bpp)


def _chunk(ctype: bytes, body: bytes) -> bytes:
    crc = zlib.crc32(ctype + body) & 0xFFFFFFFF
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", crc)


def write_png(path: str, img: np.ndarray):
    """Encode uint8 (H, W, 3) or (H, W, 4) as an RGB or RGBA PNG."""
    arr = np.ascontiguousarray(img)
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] not in (3, 4):
        raise ValueError(f"write_png takes uint8 (H, W, 3|4), got {arr.dtype} {arr.shape}")
    height, width, ch = arr.shape
    color = 2 if ch == 3 else 6
    rows = np.concatenate(
        [np.zeros((height, 1), np.uint8), arr.reshape(height, width * ch)], axis=1
    )
    ihdr = struct.pack(">IIBBBBB", width, height, 8, color, 0, 0, 0)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", ihdr))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))
