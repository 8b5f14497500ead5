"""PNG codec on the standard library's zlib and numpy.

Reads every standard PNG the way Pillow opens it: gray (1, 2, 4, 8 and
16 bits), RGB and RGBA (8 and 16 bits), palette (1, 2, 4 and 8 bits, with
tRNS alpha), gray+alpha (8 and 16 bits), gray and RGB with a tRNS colour key,
non-interlaced or Adam7, with all five scanline filter types (PNG spec
sections 7-9). `open_png` gives the pixels in Pillow's mode for the file
(`np.asarray(Image.open(path))`: "1" as bool, "L", "I;16" as uint16, "P" as
palette indices, "LA", "RGB", "RGBA"; 16-bit colour keeps each sample's high
byte, and 16-bit gray+alpha opens as RGBA, as Pillow's unpackers do);
`resize` and `to_rgba` repeat `Image.resize` and `Image.convert("RGBA")` on
it. Writes 8-bit RGB or RGBA with filter type 0. It stands in for Pillow,
which the serving machines lack.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import NamedTuple

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # color type -> samples per pixel
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7 passes: (x0, y0, dx, dy).
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


class PngImage(NamedTuple):
    """A decoded PNG in Pillow's terms: `pixels` is np.asarray(Image.open()),
    (H, W) for "1", "L", "I;16" and "P", else (H, W, C); `palette` the
    (n, 4) RGBA palette of a "P" image (tRNS alpha, else 255);
    `transparency` the tRNS colour key of a gray or RGB image (Pillow's
    info["transparency"]: the raw sample values) or None."""

    pixels: np.ndarray
    mode: str
    palette: np.ndarray | None = None
    transparency: int | tuple | None = None


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
    if color not in _CHANNELS or depth not in _DEPTHS[color] or interlace not in (0, 1):
        raise ValueError(f"invalid PNG header (bit depth {depth}, color type {color}, interlace {interlace})")
    return width, height, depth, color, interlace


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


def _unfilter(raw: memoryview, pos: int, height: int, stride: int, bpp: int, path: str):
    """Reconstruct `height` filtered scanlines of `stride` bytes starting at
    raw[pos]; returns ((height, stride) uint8, the next position)."""
    if pos + height * (stride + 1) > len(raw):
        raise ValueError(f"{path}: truncated PNG image data")
    rows = np.frombuffer(raw, np.uint8, height * (stride + 1), pos).reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        ftype, line = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:  # Sub: running sum per byte lane, mod 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
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
    return out, pos + height * (stride + 1)


def _samples(rows: np.ndarray, width: int, channels: int, depth: int) -> np.ndarray:
    """(h, stride) reconstructed bytes -> (h, width, channels) raw samples
    (uint8 below 16 bits, big-endian uint16 as native uint16 at 16)."""
    h = rows.shape[0]
    n = width * channels
    if depth == 16:
        s = rows[:, : 2 * n].reshape(h, n, 2).astype(np.uint16)
        s = (s[..., 0] << 8) | s[..., 1]
    elif depth == 8:
        s = rows[:, :n]
    else:
        bits = np.unpackbits(rows, axis=1)[:, : n * depth].reshape(h, n, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        s = (bits * weights).sum(axis=-1, dtype=np.uint8)
    return s.reshape(h, width, channels)


def _decode_samples(data: bytes, path: str):
    """(raw samples (H, W, channels), depth, color, PLTE bytes, tRNS bytes)."""
    header, plte, trns, idat = None, None, None, []
    for ctype, body in _chunks(data):
        if ctype == b"IHDR":
            header = _header(body)
        elif ctype == b"PLTE":
            plte = body
        elif ctype == b"tRNS":
            trns = body
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, color, interlace = header
    channels = _CHANNELS[color]
    bpp = max(1, channels * depth // 8)  # the filters' byte distance
    raw = memoryview(zlib.decompress(b"".join(idat)))

    def stride(w):
        return (w * channels * depth + 7) // 8

    if not interlace:
        rows, _ = _unfilter(raw, 0, height, stride(width), bpp, path)
        return _samples(rows, width, channels, depth), depth, color, plte, trns
    out = np.zeros((height, width, channels), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in _ADAM7:
        pw, ph = (width - x0 + dx - 1) // dx, (height - y0 + dy - 1) // dy
        if pw <= 0 or ph <= 0:
            continue  # an empty pass has no scanlines, not even filter bytes
        rows, pos = _unfilter(raw, pos, ph, stride(pw), bpp, path)
        out[y0::dy, x0::dx] = _samples(rows, pw, channels, depth)
    return out, depth, color, plte, trns


def open_png(path: str) -> PngImage:
    """Decode as Pillow 12's PngImagePlugin opens the file (see PngImage)."""
    with open(path, "rb") as f:
        data = f.read()
    s, depth, color, plte, trns = _decode_samples(data, path)
    hi = (s >> 8).astype(np.uint8) if depth == 16 else s  # the ";16B" unpackers' high byte
    if color == 3:
        if plte is None:
            raise ValueError(f"{path}: palette PNG without a PLTE chunk")
        pal = np.frombuffer(plte, np.uint8)[: len(plte) // 3 * 3].reshape(-1, 3)
        alpha = np.full((len(pal), 1), 255, np.uint8)
        if trns is not None:
            a = np.frombuffer(trns, np.uint8)[: len(pal)]
            alpha[: len(a), 0] = a
        return PngImage(s[..., 0], "P", np.concatenate([pal, alpha], axis=1))
    if color == 0:
        key = struct.unpack(">H", trns[:2])[0] if trns is not None and len(trns) >= 2 else None
        g = s[..., 0]
        if depth == 1:
            return PngImage(g.astype(bool), "1", transparency=key)
        if depth == 16:
            return PngImage(g.astype(np.uint16), "I;16", transparency=key)
        scale = {2: 0x55, 4: 0x11, 8: 1}[depth]  # L;2 / L;4 spread the samples over 0-255
        return PngImage((g * scale).astype(np.uint8), "L", transparency=key)
    if color == 2:
        key = struct.unpack(">HHH", trns[:6]) if trns is not None and len(trns) >= 6 else None
        return PngImage(hi, "RGB", transparency=key)
    if color == 4:
        if depth == 16:  # LA;16B unpacks to RGBA
            return PngImage(np.concatenate([hi[..., :1]] * 3 + [hi[..., 1:]], axis=-1), "RGBA")
        return PngImage(hi, "LA")
    return PngImage(hi, "RGBA")


def read_png(path: str) -> np.ndarray:
    """np.asarray(Image.open(path)) with a channel axis: (H, W, C), C = 1
    for "1" (bool), "L", "I;16" (uint16) and "P" (palette indices), 2 for
    "LA", 3 for "RGB", 4 for "RGBA"; uint8 unless noted."""
    px = open_png(path).pixels
    return px[..., None] if px.ndim == 2 else px


def resize(img: PngImage, size: tuple[int, int], method: str) -> PngImage:
    """Image.resize(size, method) in the image's own mode: "1" and "P" take
    NEAREST whatever `method` says, "LA" and "RGBA" are resized
    premultiplied, "I;16" in 16-bit samples (utils/resample.py)."""
    from perfbench.reference.plain.utils import resample

    if img.mode in ("1", "P"):
        method = resample.NEAREST
    if img.mode == "I;16" and method != resample.NEAREST:
        px = resample.resize_16bpc(img.pixels, size, method)
    else:
        px = resample.resize(img.pixels, size, method)
    return img._replace(pixels=px)


def to_rgba(img: PngImage) -> np.ndarray:
    """Image.convert("RGBA") -> (H, W, 4) uint8: gray is spread over RGB
    ("I;16" clipped to 255, not scaled), "1" maps to 0/255, a palette image
    looks its indices up, and a tRNS colour key makes the pixels that equal
    it (compared in the mode's values, after any resize) transparent."""
    px, mode = img.pixels, img.mode
    if mode == "P":
        # Indices past the file's palette read opaque black.
        pal = np.zeros((256, 4), np.uint8)
        pal[:, 3] = 255
        pal[: len(img.palette)] = img.palette[:256]
        return pal[px]
    if mode in ("1", "L", "I;16"):
        vals = px.astype(np.int64) * (255 if mode == "1" else 1)
        g = np.clip(vals, 0, 255).astype(np.uint8)
        out = np.stack([g, g, g, np.full_like(g, 255)], axis=-1)
        if img.transparency is not None:
            out[..., 3] = np.where(vals == img.transparency, 0, 255)
        return out
    if mode == "LA":
        return np.concatenate([px[..., :1]] * 3 + [px[..., 1:]], axis=-1)
    if mode == "RGB":
        out = np.concatenate([px, np.full(px.shape[:2] + (1,), 255, np.uint8)], axis=-1)
        if img.transparency is not None:
            hit = np.all(px.astype(np.int64) == np.asarray(img.transparency), axis=-1)
            out[..., 3] = np.where(hit, 0, 255)
        return out
    return px


def _chunk(ctype: bytes, body: bytes) -> bytes:
    crc = zlib.crc32(ctype + body) & 0xFFFFFFFF
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", crc)


def write_png(path: str, img: np.ndarray, level: int = 6):
    """Encode uint8 (H, W, 3) or (H, W, 4) as an RGB or RGBA PNG (zlib
    compression `level`, 0-9)."""
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
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), level)))
        f.write(_chunk(b"IEND", b""))
