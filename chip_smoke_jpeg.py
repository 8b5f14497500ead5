"""A baseline JPEG writer in numpy: test tooling for chip_smoke.py and the
tests (the machine with the card has no Pillow, nor anything else that writes
JPEG). Not part of the port.

    write_jpeg(path, img, quality=90, sampling=(2, 2), restart_interval=0, rgb=False)

img is uint8 (H, W, 3) RGB or (H, W) grayscale. It writes a JFIF baseline
file as libjpeg does by default: the Annex K quantization tables scaled by
libjpeg's quality rule, the Annex K Huffman tables, YCbCr (JFIF) with the
luma sampling factors `sampling` = (h, v) over chroma 1x1 ((1, 1) 4:4:4,
(2, 1) 4:2:2, (2, 2) 4:2:0, (1, 2) 4:4:0; chroma box-averaged), one
interleaved scan, and an optional restart interval (in MCUs). With
rgb=True it stores R, G and B untransformed instead, as libjpeg's JCS_RGB
does (an Adobe marker with transform 0 in place of JFIF, component ids 'R',
'G', 'B'); G and B are then sampled as chroma would be. The DCT is
float32 and rounds to the nearest quantum. Huffman packing and byte stuffing
are vectorised, so a 16-megapixel photo takes seconds.
"""
from __future__ import annotations

import struct

import numpy as np

# Zigzag index -> natural position (T.81 Figure A.6).
NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
])
# Annex K.1 quantization tables, natural order.
LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
])
CHROMA_Q = np.full(64, 99)
CHROMA_Q[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]
# Annex K.3 Huffman tables: code counts per length 1..16, symbols.
DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))


AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07,
    0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0,
    0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49,
    0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69,
    0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7,
    0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5,
    0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
    0xF9, 0xFA,
])
AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71,
    0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0,
    0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48,
    0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68,
    0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
    0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3,
    0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
    0xF9, 0xFA,
])


def quality_table(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg's jpeg_quality_scaling and force_baseline clamp."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255).astype(np.int64)


def _codes(table):
    """(code, length) per symbol 0..255 of a DHT table (T.81 Annex C)."""
    counts, symbols = table
    code = np.zeros(256, np.int64)
    length = np.zeros(256, np.int64)
    c, k = 0, 0
    for n_bits, n in enumerate(counts, start=1):
        for _ in range(n):
            code[symbols[k]], length[symbols[k]] = c, n_bits
            c, k = c + 1, k + 1
        c <<= 1
    return code, length


def _dct_matrix():
    u = np.arange(8)[:, None]
    x = np.arange(8)[None, :]
    m = np.cos((2 * x + 1) * u * np.pi / 16) / 2
    m[0] /= np.sqrt(2)
    return m


def _magnitude(v):
    """JPEG magnitude category (bit length of |v|) and the extra bits."""
    cat = np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)
    extra = np.where(v >= 0, v, v + (np.int64(1) << cat) - 1)
    return cat, extra


def _blocks(plane, q):
    """Quantised DCT blocks (bh * bw, 64) in zigzag order, row-major."""
    bh, bw = plane.shape[0] // 8, plane.shape[1] // 8
    blk = plane.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3).reshape(-1, 64) - np.float32(128.0)
    m = _dct_matrix()
    # m @ B @ m.T on each block, as one product with kron(m, m).
    coef = blk @ np.kron(m, m).T.astype(np.float32)
    return np.rint(coef / q.astype(np.float32)).astype(np.int32)[:, NATURAL]


def _pack(values, lengths):
    """Concatenate each value's low `length` bits, MSB first, into bytes
    (the total length must be a whole number of bytes): each token lands in
    one 64-bit word or spills into the next, and the words' parts are
    OR-reduced over the tokens that share a word."""
    lengths = lengths.astype(np.uint64)
    values = values.astype(np.uint64)
    end = np.cumsum(lengths)
    start = end - lengths
    total = int(end[-1]) if len(end) else 0
    word = start >> np.uint64(6)
    off = start & np.uint64(63)
    fits = off + lengths <= 64
    sh = np.where(fits, 64 - off - lengths, off + lengths - 64).astype(np.uint64)
    high = np.where(fits, values << sh, values >> sh)
    spill = ~fits
    low = values[spill] << (np.uint64(128) - off[spill] - lengths[spill])
    words = np.zeros(total // 64 + 2, np.uint64)
    for w, part in ((word, high), (word[spill] + np.uint64(1), low)):
        if len(w):
            first = np.r_[True, w[1:] != w[:-1]]
            words[w[first]] |= np.bitwise_or.reduceat(part, np.flatnonzero(first))
    return words.byteswap().view(np.uint8)[: total // 8]


def _segment(marker, body):
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def encode_jpeg(img: np.ndarray, quality: int = 90, sampling=(2, 2), restart_interval: int = 0,
                rgb: bool = False) -> bytes:
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"expected uint8 (H, W) or (H, W, 3), got {img.dtype} {img.shape}")
    H, W = img.shape[:2]
    gray = img.ndim == 2
    hmax, vmax = (1, 1) if gray else sampling
    mcus_x, mcus_y = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    lq, cq = quality_table(LUMA_Q, quality), quality_table(CHROMA_Q, quality)
    pad = ((0, mcus_y * 8 * vmax - H), (0, mcus_x * 8 * hmax - W))
    if gray:
        planes = [np.pad(img.astype(np.float32), pad, mode="edge")]
        factors = [(1, 1)]
    else:
        px = np.pad(img, pad + ((0, 0),), mode="edge").astype(np.float32)
        if not rgb:
            px = px @ np.array([[0.299, 0.587, 0.114], [-0.168735892, -0.331264108, 0.5],
                                [0.5, -0.418687589, -0.081312411]], np.float32).T
            px[..., 1:] += np.float32(128)
        y, cb, cr = px[..., 0], px[..., 1], px[..., 2]
        ch, cw = mcus_y * 8, mcus_x * 8

        def down(p):
            return p.reshape(ch, vmax, cw, hmax).mean(axis=(1, 3))

        planes = [y, down(cb), down(cr)]
        factors = [(hmax, vmax), (1, 1), (1, 1)]
    blocks = [_blocks(p, lq if i == 0 else cq) for i, p in enumerate(planes)]

    # Scan order: MCU by MCU, each component's h x v blocks row-major.
    n_mcu = mcus_x * mcus_y
    mcu = np.arange(n_mcu)
    my, mx = mcu // mcus_x, mcu % mcus_x
    order, comp_of = [], []
    base = 0
    for ci, ((h, v), blk) in enumerate(zip(factors, blocks)):
        bw = mcus_x * h
        for yy in range(v):
            for xx in range(h):
                order.append(base + (my * v + yy) * bw + mx * h + xx)
                comp_of.append(ci)
        base += len(blk)
    order = np.stack(order, axis=1).ravel()
    comp = np.tile(np.array(comp_of), n_mcu)
    mcu_of = np.repeat(mcu, len(comp_of))
    zz = np.concatenate(blocks)[order]
    interval = mcu_of // restart_interval if restart_interval else np.zeros_like(mcu_of)

    # DC differences per component, the predictor reset at each interval.
    dc = zz[:, 0]
    diff = np.empty_like(dc)
    for ci in range(len(planes)):
        idx = np.flatnonzero(comp == ci)
        vals = dc[idx]
        prev = np.concatenate([[0], vals[:-1]])
        iv = interval[idx]
        prev[np.concatenate([[True], iv[1:] != iv[:-1]])] = 0
        diff[idx] = vals - prev
    tables = [(_codes(DC_LUMA), _codes(AC_LUMA)), (_codes(DC_CHROMA), _codes(AC_CHROMA))]
    chroma = comp > 0

    def lookup(which, sym, is_chroma):
        """(code, length) of each symbol in the DC (0) or AC (1) table of
        its component."""
        (lc, ll), (cc, cl) = tables[0][which], tables[1][which]
        return np.where(is_chroma, cc[sym], lc[sym]), np.where(is_chroma, cl[sym], ll[sym])

    # Tokens (value, length): DC, then per nonzero AC coefficient its ZRLs
    # and its (run, size) code with the extra bits, then EOB where needed.
    n = len(zz)
    rows, cols = np.nonzero(zz[:, 1:])
    k = cols + 1
    first_entry = np.r_[True, rows[1:] != rows[:-1]][: len(rows)]
    last_entry = np.r_[rows[1:] != rows[:-1], True][: len(rows)]
    prev_k = np.r_[0, k[:-1]][: len(k)]
    prev_k[first_entry] = 0
    run = k - prev_k - 1
    zrl = run // 16
    last = np.zeros(n, np.int64)
    last[rows[last_entry]] = k[last_entry]
    eob = last < 63
    span = zrl + 1
    count = 1 + np.bincount(rows, weights=span, minlength=n).astype(np.int64) + eob
    block_start = np.cumsum(count) - count
    cs = np.cumsum(span) - span
    first_cs = np.zeros(n, np.int64)
    first_cs[rows[first_entry]] = cs[first_entry]
    entry_pos = block_start[rows] + 1 + cs - first_cs[rows]
    T = int(count.sum())
    val = np.zeros(T, np.int64)
    ln = np.zeros(T, np.int64)

    cat, extra = _magnitude(diff)
    code, length = lookup(0, cat, chroma)
    val[block_start] = (code << cat) | extra
    ln[block_start] = length + cat
    cat, extra = _magnitude(zz[rows, k])
    code, length = lookup(1, (run % 16) * 16 + cat, chroma[rows])
    val[entry_pos + zrl] = (code << cat) | extra
    ln[entry_pos + zrl] = length + cat
    if len(zrl) and zrl.max() > 0:
        zpos = np.repeat(entry_pos, zrl) + np.arange(int(zrl.sum())) - np.repeat(np.cumsum(zrl) - zrl, zrl)
        code, length = lookup(1, np.full(len(zpos), 0xF0), np.repeat(chroma[rows], zrl))
        val[zpos], ln[zpos] = code, length
    eb = np.flatnonzero(eob)
    code, length = lookup(1, np.zeros(len(eb), np.int64), chroma[eb])
    val[block_start[eb] + count[eb] - 1] = code
    ln[block_start[eb] + count[eb] - 1] = length

    # Pad each restart interval to a byte with 1 bits, pack, stuff, insert
    # the RSTn markers.
    tok_interval = np.repeat(interval, count)
    n_iv = int(interval[-1]) + 1
    iv_bits = np.bincount(tok_interval, weights=ln, minlength=n_iv).astype(np.int64)
    iv_pad = -iv_bits % 8
    iv_end = np.searchsorted(tok_interval, np.arange(n_iv), side="right")
    val = np.insert(val, iv_end, (1 << iv_pad) - 1)
    ln = np.insert(ln, iv_end, iv_pad)
    data = _pack(val, ln)
    ff = np.flatnonzero(data == 0xFF)
    bounds = np.cumsum((iv_bits + iv_pad) // 8)[:-1]
    bounds = bounds + np.searchsorted(ff, bounds)  # past the stuffed zeros before them
    data = np.insert(data, ff + 1, 0)
    rst = 0xD0 + np.arange(len(bounds)) % 8
    data = np.insert(data, np.repeat(bounds, 2), np.stack([np.full(len(bounds), 0xFF), rst], axis=1).ravel())

    out = [b"\xff\xd8"]
    if rgb and not gray:  # jcmarker.c write_marker_header's Adobe APP14, transform 0
        out.append(_segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, 0)))
    else:
        out.append(_segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"))
    out.append(_segment(0xDB, bytes([0]) + bytes(lq[NATURAL].astype(np.uint8))
                        + (b"" if gray else bytes([1]) + bytes(cq[NATURAL].astype(np.uint8)))))
    sof = struct.pack(">BHHB", 8, H, W, len(planes))
    ids = b"RGB" if rgb and not gray else bytes([1, 2, 3])
    for ci, (h, v) in enumerate(factors):
        sof += bytes([ids[ci], h * 16 + v, min(ci, 1)])
    out.append(_segment(0xC0, sof))
    for tc_th, (counts, symbols) in ((0x00, DC_LUMA), (0x10, AC_LUMA), (0x01, DC_CHROMA), (0x11, AC_CHROMA)):
        if gray and tc_th & 1:
            continue
        out.append(_segment(0xC4, bytes([tc_th]) + bytes(counts) + bytes(symbols)))
    if restart_interval:
        out.append(_segment(0xDD, struct.pack(">H", restart_interval)))
    sos = bytes([len(planes)])
    for ci in range(len(planes)):
        sos += bytes([ids[ci], 0x00 if ci == 0 else 0x11])
    out.append(_segment(0xDA, sos + bytes([0, 63, 0])))
    out.append(data.tobytes())
    out.append(b"\xff\xd9")
    return b"".join(out)


def write_jpeg(path, img, quality: int = 90, sampling=(2, 2), restart_interval: int = 0, rgb: bool = False) -> int:
    """Write `img` as a baseline JPEG file; returns its size in bytes."""
    data = encode_jpeg(img, quality, sampling, restart_interval, rgb)
    with open(path, "wb") as f:
        f.write(data)
    return len(data)
