"""JPEG decoder: equal, bit for bit, to Pillow's decode (libjpeg-turbo).

The JAX package reads photos with Pillow; the machines with the card have no
Pillow, so the port decodes JPEG itself, in two parts:

- the host: this module parses the markers (SOI, APPn, COM, DQT, DHT, SOF0,
  SOF1, SOF2, DRI, SOS, EOI) and `csrc/jpeg_entropy.cpp`, host C++ built with
  the host compiler at first use, decodes each scan's Huffman-coded data into
  int16 coefficient blocks (baseline, extended and progressive; interleaved
  and non-interleaved scans; restart intervals);
- the card: `idct_color`, the wrapper of the CUDA kernel in
  `csrc/jpeg_idct.cu`, dequantises, runs libjpeg-turbo's integer inverse DCT
  (jidctint.c, ISLOW; its output saturated to 0..255), upsamples chroma
  as libjpeg-turbo's fancy upsampling does (jdsample.c) and converts
  YCbCr to RGB with jdcolor.c's integer tables. Everything is integer
  arithmetic, so the kernel, its plain torch version (`idct_color_plain`, for
  CPU tensors) and Pillow agree exactly.

Refused with NotImplementedError naming ROADMAP.md A13: arithmetic coding,
lossless and hierarchical frames, 12-bit samples, frames of 2 or 4
components (CMYK, YCCK), non-integral sampling ratios, and progressive files
whose scans leave low AC coefficients unrefined (libjpeg's block smoothing).
As Pillow does, the decoder does not apply an EXIF orientation.
"""
from __future__ import annotations

import ctypes
import functools
import struct
from dataclasses import dataclass

import numpy as np
import torch

from materialrefgs_torch import resolve_device
from materialrefgs_torch.ops import nvcc

SOURCE = nvcc.CSRC / "jpeg_idct.cu"
ENTROPY_SOURCE = nvcc.CSRC / "jpeg_entropy.cpp"
ROADMAP_ITEM = "ROADMAP.md A13"

SOI = b"\xff\xd8"
# Zigzag index -> natural (row-major) position in an 8x8 block.
NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
])

# Colour of the decoded samples: one plane, YCbCr, or RGB as stored.
GRAY, YCC, RGB = 0, 1, 2
# How a component reaches full size: as it is; libjpeg-turbo's fancy
# (triangle) h2v1, h1v2 and h2v2 filters; box replication.
FULL, H2V1, H1V2, H2V2, BOX = 0, 1, 2, 3, 4

_UNSUPPORTED = {
    0xC3: "lossless (SOF3)", 0xC5: "hierarchical (SOF5)", 0xC6: "hierarchical (SOF6)",
    0xC7: "hierarchical lossless (SOF7)", 0xC9: "arithmetic coding (SOF9)", 0xCA: "arithmetic coding (SOF10)",
    0xCB: "arithmetic coding (SOF11)", 0xCC: "arithmetic coding (DAC)", 0xCD: "arithmetic coding (SOF13)",
    0xCE: "arithmetic coding (SOF14)", 0xCF: "arithmetic coding (SOF15)", 0xDC: "a DNL marker",
    0xDE: "hierarchical (DHP)", 0xDF: "hierarchical (EXP)",
}


def unsupported(path, what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{path}: {what} is not supported: the port's JPEG decoder reads baseline and progressive "
        f"Huffman JPEG with 8-bit samples and 1 or 3 components ({ROADMAP_ITEM})"
    )


@dataclass(frozen=True)
class Component:
    """One component's plane: blocks [offset, offset + bw * bh) of the
    coefficient array, row-major; dw x dh real samples; upsampled by
    (rh, rv) to full size with `mode`."""

    offset: int
    bw: int
    bh: int
    dw: int
    dh: int
    rh: int
    rv: int
    mode: int


@dataclass
class Coefficients:
    """A decoded file before the inverse DCT: coef int16 (n_blocks, 64) and
    quant int32 (n_components, 64), both in natural order."""

    coef: np.ndarray
    quant: np.ndarray
    comps: tuple
    height: int
    width: int
    color: int


@functools.lru_cache(maxsize=1)
def _entropy() -> ctypes.CDLL:
    lib = nvcc.load(ENTROPY_SOURCE)
    fn = lib.jpeg_decode_scan
    fn.argtypes = [
        ctypes.c_void_p,  # data
        ctypes.c_longlong,  # size
        ctypes.c_longlong,  # pos
        ctypes.c_void_p,  # coef
        ctypes.c_int,  # components in the scan
        ctypes.c_void_p,  # comp (ns, 8) int32
        ctypes.c_void_p,  # tables (8, 272) uint8
        ctypes.c_void_p,  # present (8,) int32
        ctypes.c_int, ctypes.c_int,  # mcus_x, mcus_y
        ctypes.c_int,  # restart interval
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # Ss, Se, Ah, Al
        ctypes.c_int,  # progressive
    ]
    fn.restype = ctypes.c_longlong
    lib.jpeg_last_error.restype = ctypes.c_char_p
    return lib


def _markers(data: bytes, path):
    """Yield (marker, segment start, segment end) after SOI; SOS's end is
    that of its header (the caller moves `pos` past the entropy data by
    sending the new offset into the generator)."""
    pos = 2
    while True:
        if pos >= len(data) or data[pos] != 0xFF:
            raise ValueError(f"{path}: JPEG marker expected at byte {pos} (truncated or corrupt file)")
        while pos < len(data) and data[pos] == 0xFF:  # fill bytes
            pos += 1
        if pos >= len(data):
            raise ValueError(f"{path}: truncated JPEG file")
        m = data[pos]
        pos += 1
        if m == 0xD9:
            yield m, pos, pos
            return
        if 0xD0 <= m <= 0xD7 or m in (0x01, 0xD8):
            raise ValueError(f"{path}: unexpected marker 0x{m:02X} at byte {pos - 2}")
        if pos + 2 > len(data):
            raise ValueError(f"{path}: truncated JPEG segment")
        (length,) = struct.unpack(">H", data[pos : pos + 2])
        if length < 2 or pos + length > len(data):
            raise ValueError(f"{path}: truncated JPEG segment 0x{m:02X}")
        new = yield m, pos + 2, pos + length
        pos = pos + length if new is None else new


def _frame(seg: bytes, path):
    precision, height, width, nc = struct.unpack(">BHHB", seg[:6])
    if precision != 8:
        raise unsupported(path, f"{precision}-bit precision")
    if height == 0:
        raise unsupported(path, "a height set by a DNL marker")
    if nc not in (1, 3):
        raise unsupported(path, f"a frame of {nc} components (CMYK/YCCK)" if nc == 4 else f"a frame of {nc} components")
    comps = [(seg[6 + 3 * i], seg[7 + 3 * i] >> 4, seg[7 + 3 * i] & 15, seg[8 + 3 * i]) for i in range(nc)]
    if width == 0 or any(not (1 <= h <= 4 and 1 <= v <= 4) or tq > 3 for _, h, v, tq in comps):
        raise ValueError(f"{path}: bad frame header")
    return height, width, comps


def _layout(height, width, comps, path):
    """Component planes, MCU grid and upsampling (libjpeg-turbo's
    jdinput.c/jdsample.c choices)."""
    max_h = max(h for _, h, _, _ in comps)
    max_v = max(v for _, _, v, _ in comps)
    mcus_x = -(-width // (8 * max_h))
    mcus_y = -(-height // (8 * max_v))
    out, offset = [], 0
    for _, h, v, _ in comps:
        if max_h % h or max_v % v:
            raise unsupported(path, f"a non-integral sampling ratio ({max_h}x{max_v} over {h}x{v})")
        rh, rv = max_h // h, max_v // v
        dw, dh = -(-width * h // max_h), -(-height * v // max_v)
        if len(comps) == 1:
            bw, bh = -(-dw // 8), -(-dh // 8)
        else:
            bw, bh = mcus_x * h, mcus_y * v
        # Fancy upsampling where libjpeg-turbo uses it (jinit_upsampler:
        # h2v1 and h2v2 only on planes wider than 2 samples), box otherwise.
        mode = {(1, 1): FULL, (2, 1): H2V1 if dw > 2 else BOX, (1, 2): H1V2,
                (2, 2): H2V2 if dw > 2 else BOX}.get((rh, rv), BOX)
        out.append(Component(offset, bw, bh, dw, dh, rh, rv, mode))
        offset += bw * bh
    return tuple(out), mcus_x, mcus_y, offset


def read_jpeg_size(path) -> tuple[int, int]:
    """(width, height) from the frame header, without decoding."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != SOI:
        raise ValueError(f"{path}: not a JPEG file")
    for m, lo, hi in _markers(data, path):
        if 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):  # SOFn
            height, width = struct.unpack(">HH", data[lo + 1 : lo + 5])
            return width, height
        if m in (0xDA, 0xD9):
            break
    raise ValueError(f"{path}: JPEG without a frame header")


def read_coefficients(path) -> Coefficients:
    """The host half of the decode: markers parsed here, each scan's entropy
    decode in csrc/jpeg_entropy.cpp."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != SOI:
        raise ValueError(f"{path}: not a JPEG file")
    buf = np.frombuffer(data, np.uint8)
    qtables: dict[int, np.ndarray] = {}
    tables = np.zeros((8, 272), np.uint8)
    present = np.zeros(8, np.int32)
    restart = 0
    jfif, adobe = False, None
    frame = None
    quant = coef = coef_bits = None
    gen = _markers(data, path)
    new_pos = None
    while True:
        m, lo, hi = gen.send(new_pos)
        new_pos = None
        seg = data[lo:hi]
        if m == 0xD9:
            break
        if m in _UNSUPPORTED:
            raise unsupported(path, _UNSUPPORTED[m])
        if m == 0xDB:  # DQT
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                n = 128 if pq else 64
                if tq > 3 or i + 1 + n > len(seg):
                    raise ValueError(f"{path}: bad DQT segment")
                vals = np.frombuffer(seg[i + 1 : i + 1 + n], ">u2" if pq else np.uint8).astype(np.int32)
                qtables[tq] = np.empty(64, np.int32)
                qtables[tq][NATURAL] = vals
                i += 1 + n
        elif m == 0xC4:  # DHT
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                counts = np.frombuffer(seg[i + 1 : i + 17], np.uint8)
                n = int(counts.sum())
                if tc > 1 or th > 3 or len(counts) != 16 or n > 256 or i + 17 + n > len(seg):
                    raise ValueError(f"{path}: bad DHT segment")
                slot = 4 * tc + th
                tables[slot] = 0
                tables[slot, :16] = counts
                tables[slot, 16 : 16 + n] = np.frombuffer(seg[i + 17 : i + 17 + n], np.uint8)
                present[slot] = 1
                i += 17 + n
        elif m in (0xC0, 0xC1, 0xC2):  # SOF0, SOF1, SOF2
            if frame is not None:
                raise ValueError(f"{path}: more than one frame header")
            height, width, fcomps = _frame(seg, path)
            comps, mcus_x, mcus_y, n_blocks = _layout(height, width, fcomps, path)
            frame = (height, width, fcomps, comps, mcus_x, mcus_y, m == 0xC2)
            coef = np.zeros((n_blocks, 64), np.int16)
            quant = [None] * len(fcomps)
            coef_bits = np.full((len(fcomps), 64), -1, np.int32)
        elif m == 0xDD:  # DRI
            (restart,) = struct.unpack(">H", seg[:2])
        elif m == 0xE0:
            jfif = jfif or seg[:5] == b"JFIF\x00"
        elif m == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe = seg[11]
        elif m == 0xDA:  # SOS
            if frame is None:
                raise ValueError(f"{path}: scan before the frame header")
            height, width, fcomps, comps, mcus_x, mcus_y, progressive = frame
            ns = seg[0]
            ids = [c[0] for c in fcomps]
            sel = []
            for k in range(ns):
                cid, tdta = seg[1 + 2 * k], seg[2 + 2 * k]
                if cid not in ids:
                    raise ValueError(f"{path}: scan names an unknown component {cid}")
                if tdta >> 4 > 3 or tdta & 15 > 3:
                    raise ValueError(f"{path}: bad scan header (Huffman table selector past 3)")
                sel.append((ids.index(cid), tdta >> 4, tdta & 15))
            ss, se, ahal = seg[1 + 2 * ns : 4 + 2 * ns]
            ah, al = ahal >> 4, ahal & 15
            if not progressive:
                if (ss, se, ah, al) != (0, 63, 0, 0):
                    raise ValueError(f"{path}: bad sequential scan parameters")
            elif (ss == 0 and se != 0) or (ss > 0 and (ns != 1 or se < ss or se > 63)) or al > 13:
                raise ValueError(f"{path}: bad progressive scan parameters")
            comp_arr = np.zeros((ns, 8), np.int32)
            for k, (ci, td, ta) in enumerate(sel):
                c, (_, h, v, tq) = comps[ci], fcomps[ci]
                if quant[ci] is None:  # latched at the component's first scan (jdinput.c)
                    if tq not in qtables:
                        raise ValueError(f"{path}: component uses an undefined quantization table")
                    quant[ci] = qtables[tq].copy()
                comp_arr[k] = (c.offset, c.bw, -(-c.dw // 8), -(-c.dh // 8), h, v, td, ta)
                if progressive:
                    coef_bits[ci, ss : se + 1] = al
            lib = _entropy()
            end = lib.jpeg_decode_scan(
                buf.ctypes.data, len(data), hi, coef.ctypes.data, ns, comp_arr.ctypes.data,
                tables.ctypes.data, present.ctypes.data, mcus_x, mcus_y, restart, ss, se, ah, al,
                int(progressive),
            )
            if end < 0:
                raise ValueError(f"{path}: {lib.jpeg_last_error().decode()}")
            new_pos = int(end)
    if frame is None or any(q is None for q in quant):
        raise ValueError(f"{path}: JPEG without a frame or with a component in no scan")
    height, width, fcomps, comps, _, _, progressive = frame
    if progressive and np.any(coef_bits[:, 1:10] != 0):
        # libjpeg-turbo smooths the blocks of such a file (jdcoefct.c
        # decompress_smooth_data); the port does not.
        raise unsupported(path, "a progressive file whose scans leave low AC coefficients unrefined")
    if len(fcomps) == 1:
        color = GRAY
    elif jfif:
        color = YCC
    elif adobe is not None:
        color = RGB if adobe == 0 else YCC
    else:  # jdapimin.c: guess from the component ids
        color = RGB if [c[0] for c in fcomps] == [82, 71, 66] else YCC
    return Coefficients(coef, np.stack(quant), comps, height, width, color)


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = nvcc.load(SOURCE)
    fn = lib.jpeg_idct_color
    fn.argtypes = [
        ctypes.c_void_p,  # coef (n_blocks, 64) int16
        ctypes.c_void_p,  # quant (n_comp, 64) int32
        ctypes.c_void_p,  # samples scratch (n_blocks * 64) uint8
        ctypes.c_void_p,  # out (H, W, C) uint8
        ctypes.c_void_p,  # component params, host (n_comp, 8) int32
        ctypes.c_int,  # n_comp
        ctypes.c_longlong,  # n_blocks
        ctypes.c_int,  # height
        ctypes.c_int,  # width
        ctypes.c_int,  # color
        ctypes.c_void_p,  # stream
    ]
    fn.restype = ctypes.c_int
    return lib


def _check_inputs(coef, quant, comps, color):
    if coef.dtype != torch.int16 or coef.dim() != 2 or coef.shape[1] != 64:
        raise ValueError(f"coef must be int16 (n_blocks, 64), got {coef.dtype} {tuple(coef.shape)}")
    if quant.dtype != torch.int32 or tuple(quant.shape) != (len(comps), 64):
        raise ValueError(f"quant must be int32 ({len(comps)}, 64), got {quant.dtype} {tuple(quant.shape)}")
    if coef.device != quant.device:
        raise ValueError("coef and quant must be on one device")
    if len(comps) not in (1, 3) or (len(comps) == 1) != (color == GRAY):
        raise ValueError(f"{len(comps)} components with colour {color}")
    end = comps[-1].offset + comps[-1].bw * comps[-1].bh
    if end != coef.shape[0]:
        raise ValueError(f"the components cover {end} blocks, coef holds {coef.shape[0]}")


def idct_color(coef: torch.Tensor, quant: torch.Tensor, comps, height: int, width: int,
               color: int) -> torch.Tensor:
    """Coefficients to pixels: uint8 (height, width, 3), or (height, width)
    for GRAY. Launches the CUDA kernel for CUDA tensors and counts the launch
    in `idct_color.launches`; runs the plain version for CPU tensors."""
    _check_inputs(coef, quant, comps, color)
    if coef.device.type == "cpu":
        return idct_color_plain(coef, quant, comps, height, width, color)
    if coef.device.type != "cuda":
        raise ValueError(f"unsupported device {coef.device}")
    coef, quant = coef.contiguous(), quant.contiguous()
    if coef.data_ptr() % 16:  # the kernel loads a block's coefficients 16 bytes at a time
        coef = coef.clone()
    samples = torch.empty(coef.shape[0] * 64, dtype=torch.uint8, device=coef.device)
    out = torch.empty((height, width, 3) if color != GRAY else (height, width), dtype=torch.uint8,
                      device=coef.device)
    params = np.array([[c.offset, c.bw, c.bh, c.dw, c.dh, c.rh, c.rv, c.mode] for c in comps], np.int32)
    stream = torch.cuda.current_stream(coef.device).cuda_stream
    err = _library().jpeg_idct_color(
        coef.data_ptr(), quant.data_ptr(), samples.data_ptr(), out.data_ptr(), params.ctypes.data,
        len(comps), coef.shape[0], height, width, color, stream,
    )
    if err != 0:
        raise RuntimeError(f"jpeg_idct_color kernel launch failed with CUDA error {err}")
    idct_color.launches += 1
    return out


idct_color.launches = 0

# jidctint.c's constants: CONST_BITS 13, PASS1_BITS 2, FIX(x) = x * 2^13 rounded.
_CONST_BITS, _PASS1_BITS = 13, 2
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172


def _idct_1d(d, shift):
    """One pass of jpeg_idct_islow on the 8 inputs d[0..7] (tensors of one
    shape), each output descaled by `shift` bits with rounding."""
    z2, z3 = d[2], d[6]
    z1 = (z2 + z3) * _F0541
    tmp2 = z1 + z3 * -_F1847
    tmp3 = z1 + z2 * _F0765
    tmp0 = (d[0] + d[4]) * (1 << _CONST_BITS)
    tmp1 = (d[0] - d[4]) * (1 << _CONST_BITS)
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    tmp0, tmp1, tmp2, tmp3 = d[7], d[5], d[3], d[1]
    z1, z2, z3, z4 = tmp0 + tmp3, tmp1 + tmp2, tmp0 + tmp2, tmp1 + tmp3
    z5 = (z3 + z4) * _F1175
    tmp0, tmp1, tmp2, tmp3 = tmp0 * _F0298, tmp1 * _F2053, tmp2 * _F3072, tmp3 * _F1501
    z1, z2, z3, z4 = z1 * -_F0899, z2 * -_F2562, z3 * -_F1961, z4 * -_F0390
    z3 = z3 + z5
    z4 = z4 + z5
    tmp0 = tmp0 + z1 + z3
    tmp1 = tmp1 + z2 + z4
    tmp2 = tmp2 + z2 + z3
    tmp3 = tmp3 + z1 + z4
    half = 1 << (shift - 1)
    outs = (tmp10 + tmp3, tmp11 + tmp2, tmp12 + tmp1, tmp13 + tmp0,
            tmp13 - tmp0, tmp12 - tmp1, tmp11 - tmp2, tmp10 - tmp3)
    return [(o + half) >> shift for o in outs]


def idct_descaled(blocks: torch.Tensor) -> torch.Tensor:
    """Dequantised int32 blocks (N, 8, 8), [row (vertical frequency), col],
    through both passes of jpeg_idct_islow (columns first), before the
    range limit: (N, 8, 8) around 0."""
    ws = torch.stack(_idct_1d([blocks[:, k, :] for k in range(8)], _CONST_BITS - _PASS1_BITS), dim=1)
    return torch.stack(_idct_1d([ws[:, :, k] for k in range(8)], _CONST_BITS + _PASS1_BITS + 3), dim=2)


def range_limit(v: torch.Tensor) -> torch.Tensor:
    """The IDCT's output range limit: v + CENTERJSAMPLE clamped to 0..255,
    as libjpeg-turbo's x86-64 SIMD IDCT (which Pillow runs) saturates. Its C
    IDCT's table wraps v mod 1024 first (`& RANGE_MASK`); the two differ
    only where |v| >= 512, which no encoder of 8-bit samples writes."""
    return torch.clamp(v + 128, 0, 255)


def _upsample(plane: torch.Tensor, c: Component, height: int, width: int) -> torch.Tensor:
    """A component's samples (bh*8, bw*8) int32 to (height, width)."""
    dev = plane.device
    y = torch.arange(height, device=dev)
    x = torch.arange(width, device=dev)
    if c.mode == FULL:
        return plane[:height, :width]
    if c.mode == BOX:
        return plane[(y // c.rv)[:, None], (x // c.rh)[None, :]]
    if c.mode == H1V2:
        i = y // 2
        odd = (y % 2).bool()
        far = torch.where(odd, torch.clamp(i + 1, max=c.dh - 1), torch.clamp(i - 1, min=0))
        bias = torch.where(odd, 2, 1)[:, None]
        return (3 * plane[i, :width] + plane[far, :width] + bias) >> 2
    j = x // 2
    oddx = (x % 2).bool()
    jfar = torch.where(oddx, torch.clamp(j + 1, max=c.dw - 1), torch.clamp(j - 1, min=0))
    if c.mode == H2V1:
        rows = plane[:height]
        bias = torch.where(oddx, 2, 1)[None, :]
        return (3 * rows[:, j] + rows[:, jfar] + bias) >> 2
    # H2V2: column sums of the nearer and the farther row, then the columns.
    i = y // 2
    oddy = (y % 2).bool()
    ifar = torch.where(oddy, torch.clamp(i + 1, max=c.dh - 1), torch.clamp(i - 1, min=0))
    colsum = 3 * plane[i] + plane[ifar]
    bias = torch.where(oddx, 7, 8)[None, :]
    return (3 * colsum[:, j] + colsum[:, jfar] + bias) >> 4


def _fix16(x: float) -> int:
    return int(x * 65536 + 0.5)


def idct_color_plain(coef: torch.Tensor, quant: torch.Tensor, comps, height: int, width: int,
                     color: int) -> torch.Tensor:
    """The kernel's computation in plain torch on any device, with the
    kernel's (and libjpeg-turbo's) integer arithmetic."""
    _check_inputs(coef, quant, comps, color)
    planes = []
    for ci, c in enumerate(comps):
        blk = coef[c.offset : c.offset + c.bw * c.bh].to(torch.int32) * quant[ci]
        samples = range_limit(idct_descaled(blk.view(-1, 8, 8)))
        plane = samples.view(c.bh, c.bw, 8, 8).permute(0, 2, 1, 3).reshape(c.bh * 8, c.bw * 8)
        planes.append(_upsample(plane, c, height, width))
    if color == GRAY:
        return planes[0].to(torch.uint8)
    if color == RGB:
        return torch.stack(planes, dim=-1).to(torch.uint8)
    # jdcolor.c ycc_rgb_convert: SCALEBITS 16, the tables' rounding.
    yy, cb, cr = planes[0], planes[1] - 128, planes[2] - 128
    half = 1 << 15
    r = yy + ((_fix16(1.40200) * cr + half) >> 16)
    g = yy + ((-_fix16(0.34414) * cb + half - _fix16(0.71414) * cr) >> 16)
    b = yy + ((_fix16(1.77200) * cb + half) >> 16)
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0, 255).to(torch.uint8)


def decode_jpeg(path, device=None) -> torch.Tensor:
    """Decode a JPEG file to uint8 (H, W, 3), or (H, W) for grayscale, as
    np.asarray(PIL.Image.open(path)) gives it. The entropy decode runs on the
    host; the coefficients are copied to `device` (default: the card) and
    turned into pixels there."""
    dev = resolve_device(device)
    co = read_coefficients(path)
    coef = torch.from_numpy(co.coef).to(dev)
    quant = torch.from_numpy(co.quant).to(dev)
    return idct_color(coef, quant, co.comps, co.height, co.width, co.color)
