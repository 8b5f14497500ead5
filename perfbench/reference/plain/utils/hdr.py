"""Radiance RGBE (.hdr) codec on numpy alone.

Reads what `--relight` takes: a `#?RADIANCE` / `#?RGBE` header with
FORMAT=32-bit_rle_rgbe (or none), the standard `-Y H +X W` orientation, and
scanlines that are flat (4 bytes a pixel) or new-style run-length encoded
(2, 2, width, then each channel's runs), decided per scanline as Radiance's
own reader does. Any other orientation or format is refused. Values decode
as the FreeImage / OpenCV / Walter reader does, without Radiance's +0.5:
v = byte * 2^(e - 136), 0 where e = 0. It stands in for imageio, which the
serving machines lack.

No entry point writes .hdr files: the encoder below (float_to_rgbe,
write_hdr_rgbe) exists only to build test and smoke-run fixtures with both
scanline kinds, which the reader must then return byte for byte.
"""
from __future__ import annotations

import numpy as np

_MIN_RLE, _MAX_RLE = 8, 0x7FFF  # scanline widths that may be run-length encoded


def _header(data: bytes) -> tuple[int, int, int]:
    """(height, width, offset of the first scanline)."""
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError("not a Radiance RGBE file (no #?RADIANCE or #?RGBE signature)")
    pos = 0
    while True:
        end = data.index(b"\n", pos)
        line = data[pos:end].strip()
        pos = end + 1
        if not line:
            break
        if line.startswith(b"FORMAT=") and line != b"FORMAT=32-bit_rle_rgbe":
            raise ValueError(f"unsupported Radiance format {line.decode(errors='replace')!r}; only 32-bit_rle_rgbe")
    end = data.index(b"\n", pos)
    res = data[pos:end].split()
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"unsupported Radiance orientation {data[pos:end].decode(errors='replace')!r}; "
                         "only '-Y H +X W'")
    return int(res[1]), int(res[3]), end + 1


def read_hdr_rgbe(path: str) -> np.ndarray:
    """The raw (H, W, 4) uint8 RGBE pixels of a Radiance file."""
    with open(path, "rb") as f:
        data = f.read()
    H, W, pos = _header(data)
    out = np.empty((H, W, 4), np.uint8)
    buf = memoryview(data)
    for y in range(H):
        if _MIN_RLE <= W <= _MAX_RLE and data[pos] == 2 and data[pos + 1] == 2 and not data[pos + 2] & 0x80:
            if (data[pos + 2] << 8) | data[pos + 3] != W:
                raise ValueError(f"scanline {y}: run-length width {(data[pos + 2] << 8) | data[pos + 3]} != {W}")
            pos += 4
            for c in range(4):
                row = out[y, :, c]
                x = 0
                while x < W:
                    n = data[pos]
                    if n > 128:
                        n -= 128
                        if x + n > W:
                            raise ValueError(f"scanline {y}: a run overruns the width")
                        row[x : x + n] = data[pos + 1]
                        pos += 2
                    else:
                        if n == 0 or x + n > W:
                            raise ValueError(f"scanline {y}: bad literal count {n}")
                        row[x : x + n] = np.frombuffer(buf[pos + 1 : pos + 1 + n], np.uint8)
                        pos += 1 + n
                    x += n
        else:
            out[y] = np.frombuffer(buf[pos : pos + 4 * W], np.uint8).reshape(W, 4)
            pos += 4 * W
    return out


def rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    """(..., 4) uint8 RGBE -> (..., 3) float32 radiance, byte * 2^(e - 136)."""
    e = rgbe[..., 3:4].astype(np.int32)
    f = np.where(e > 0, np.ldexp(np.float32(1.0), e - 136), np.float32(0.0)).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * f


def read_hdr(path: str) -> np.ndarray:
    """(H, W, 3) float32 linear radiance of a Radiance .hdr file."""
    return rgbe_to_float(read_hdr_rgbe(path))


# ---- fixture encoder (tests and chip_smoke.py only) ----


def float_to_rgbe(rgb: np.ndarray) -> np.ndarray:
    """(..., 3) float radiance -> (..., 4) uint8 RGBE (Radiance's
    float2rgbe: the largest channel's frexp gives the shared exponent)."""
    rgb = np.asarray(rgb, np.float64)
    v = rgb.max(-1)
    m, e = np.frexp(v)
    scale = np.where(v > 1e-32, m * 256.0 / np.where(v > 1e-32, v, 1.0), 0.0)
    out = np.zeros(rgb.shape[:-1] + (4,), np.uint8)
    out[..., :3] = np.clip(rgb * scale[..., None], 0, 255).astype(np.uint8)
    out[..., 3] = np.where(v > 1e-32, e + 128, 0).astype(np.uint8)
    return out


def _rle_channel(ch: np.ndarray) -> bytes:
    """New-style run-length encoding of one channel of one scanline: runs
    of 4 or more equal bytes (at most 127), literals of at most 128."""
    out = bytearray()
    n, x = len(ch), 0
    while x < n:
        run = 1
        while x + run < n and run < 127 and ch[x + run] == ch[x]:
            run += 1
        if run >= 4:
            out += bytes((128 + run, int(ch[x])))
            x += run
            continue
        start = x
        while x < n and x - start < 128:
            r = 1
            while x + r < n and r < 4 and ch[x + r] == ch[x]:
                r += 1
            if r >= 4:
                break
            x += 1
        out.append(x - start)
        out += bytes(ch[start:x])
    return bytes(out)


def write_hdr_rgbe(path: str, rgbe: np.ndarray, rle=True) -> None:
    """Write (H, W, 4) uint8 RGBE pixels; `rle` is one bool for every
    scanline or an (H,) bool array choosing each (widths outside 8..32767
    are always flat)."""
    rgbe = np.ascontiguousarray(rgbe, np.uint8)
    H, W, _ = rgbe.shape
    rle = np.broadcast_to(np.asarray(rle, bool), (H,))
    parts = [b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n", f"-Y {H} +X {W}\n".encode()]
    for y in range(H):
        if rle[y] and _MIN_RLE <= W <= _MAX_RLE:
            parts.append(bytes((2, 2, W >> 8, W & 0xFF)))
            parts.extend(_rle_channel(rgbe[y, :, c]) for c in range(4))
        else:
            parts.append(rgbe[y].tobytes())
    with open(path, "wb") as f:
        f.write(b"".join(parts))
