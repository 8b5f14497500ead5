"""The port's PNG reader against Pillow, for every standard colour type and
bit depth, interlaced or not: the raw array (np.asarray(Image.open(p))),
the RGBA conversion, the LANCZOS resize at -r 4 in the file's own mode, and
the data loader (data/readers.load_image) against the JAX package's. The
files come from a small numpy + zlib writer below (Pillow writes neither
Adam7 files nor 2/4-bit gray nor 16-bit colour), each scanline with another
of the five filter types; Pillow-written files are checked too."""
import struct
import zlib

import numpy as np
import pytest

pytest.importorskip("torch")
Image = pytest.importorskip("PIL.Image")

from materialrefgs_torch.utils import png, resample  # noqa: E402

W, H = 37, 29  # odd sizes: every Adam7 pass is partial


def _chunk(ctype, body):
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF)


def _filter_rows(rows, bpp, first_filter):
    """Filter (h, stride) bytes, row y with type (first_filter + y) % 5."""
    out = []
    prev = np.zeros(rows.shape[1], np.int64)
    for y, cur in enumerate(rows.astype(np.int64)):
        f = (first_filter + y) % 5
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if f == 0:
            pred = np.zeros_like(cur)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        out.append(np.concatenate([[f], (cur - pred) & 0xFF]).astype(np.uint8))
        prev = cur
    return np.stack(out) if out else np.zeros((0, rows.shape[1] + 1), np.uint8)


def _pack(block, depth):
    h, w, c = block.shape
    flat = block.reshape(h, w * c).astype(np.uint32)
    if depth == 16:
        return np.stack([flat >> 8, flat & 255], axis=-1).reshape(h, -1).astype(np.uint8)
    if depth == 8:
        return flat.astype(np.uint8)
    bits = ((flat[..., None] >> np.arange(depth - 1, -1, -1)) & 1).reshape(h, -1).astype(np.uint8)
    return np.packbits(bits, axis=1)


def write_png(path, samples, depth, color, interlace=0, plte=None, trns=None):
    """Raw samples (H, W, C) -> a PNG of that colour type, depth and
    interlace method."""
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    if interlace:
        passes = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
        blocks = [samples[y0::dy, x0::dx] for x0, y0, dx, dy in passes]
    else:
        blocks = [samples]
    raw = b"".join(
        _filter_rows(_pack(b, depth), bpp, i).tobytes() for i, b in enumerate(blocks) if b.size)
    data = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace))
    if plte is not None:
        data += _chunk(b"PLTE", plte.astype(np.uint8).tobytes())
    if trns is not None:
        data += _chunk(b"tRNS", trns)
    data += _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(data)


# (name, color type, depth, channels, kind of tRNS chunk)
CASES = [
    ("gray1", 0, 1, 1, None),
    ("gray2", 0, 2, 1, None),
    ("gray4", 0, 4, 1, None),
    ("gray8", 0, 8, 1, None),
    ("gray8_key", 0, 8, 1, "key"),
    ("gray16", 0, 16, 1, None),
    ("rgb8", 2, 8, 3, None),
    ("rgb8_key", 2, 8, 3, "key"),
    ("rgb16", 2, 16, 3, None),
    ("pal1", 3, 1, 1, "alpha"),
    ("pal2", 3, 2, 1, "alpha"),
    ("pal4", 3, 4, 1, "alpha"),
    ("pal8", 3, 8, 1, None),
    ("pal8_alpha", 3, 8, 1, "alpha"),
    ("pal8_short", 3, 8, 1, "short"),
    ("la8", 4, 8, 2, None),
    ("la16", 4, 16, 2, None),
    ("rgba8", 6, 8, 4, None),
    ("rgba16", 6, 16, 4, None),
]


def _make(tmp_path, name, color, depth, channels, trns_kind, interlace, seed):
    rng = np.random.default_rng(seed)
    top = (1 << depth) - 1
    samples = rng.integers(0, top + 1, size=(H, W, channels))
    if channels in (2, 4) and depth == 8:
        # Alpha at its extremes too: unpremultiply keeps 0 and 255 as they are.
        samples[::5, :, -1] = 0
        samples[1::7, :, -1] = 255
    plte = trns = None
    if color == 3:
        n = 1 << depth if trns_kind != "short" else 5  # short: indices past the palette
        plte = rng.integers(0, 256, size=(n, 3))
        if trns_kind in ("alpha", "short"):
            trns = bytes(rng.integers(0, 256, size=max(1, n - 1)).astype(np.uint8))
    elif trns_kind == "key":
        key = samples[3, 4]  # a value that occurs
        trns = b"".join(struct.pack(">H", int(v)) for v in key)
    path = str(tmp_path / f"{name}_{interlace}.png")
    write_png(path, samples, depth, color, interlace, plte, trns)
    return path


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_png_matches_pillow(tmp_path, case, interlace):
    """Raw array, RGBA conversion and the -r 4 LANCZOS resize (in the file's
    mode, then RGBA), each equal to Pillow's bit for bit."""
    name, color, depth, channels, trns = case
    path = _make(tmp_path, name, color, depth, channels, trns, interlace, seed=len(name) * 7 + interlace)
    pil = Image.open(path)
    img = png.open_png(path)
    assert img.mode == pil.mode, name
    want = np.asarray(pil)
    assert img.pixels.dtype == want.dtype and np.array_equal(img.pixels, want), name
    raw = png.read_png(path)
    assert np.array_equal(raw, want[..., None] if want.ndim == 2 else want)
    assert np.array_equal(png.to_rgba(img), np.asarray(pil.convert("RGBA"))), name
    size = (W // 4, H // 4)
    small = Image.open(path).resize(size, Image.LANCZOS)
    ours = png.resize(img, size, resample.LANCZOS)
    assert np.array_equal(ours.pixels, np.asarray(small)), name
    assert np.array_equal(png.to_rgba(ours), np.asarray(small.convert("RGBA"))), name


def test_png_empty_adam7_passes(tmp_path):
    """A 3x2 Adam7 image: passes with no pixels carry no scanlines."""
    rng = np.random.default_rng(5)
    samples = rng.integers(0, 256, size=(2, 3, 3))
    path = str(tmp_path / "tiny.png")
    write_png(path, samples, 8, 2, interlace=1)
    assert np.array_equal(png.read_png(path), np.asarray(Image.open(path)))


def test_png_16bit_resize_clips_like_pillow(tmp_path):
    """16-bit gray opens as I;16, resizes with LANCZOS in 16 bits (its
    overshoot past 65535 and under 0 as Pillow's byte clipping gives) and
    clips to 255 in the RGBA conversion."""
    samples = np.zeros((H, W, 1), np.int64)
    samples[:, ::2] = 65535  # a square wave: LANCZOS rings past both ends
    samples[::3, :, 0] = np.arange(W) * 9
    path = str(tmp_path / "wave16.png")
    write_png(path, samples, 16, 0)
    for size in ((W // 4, H // 4), (W // 2, H)):
        small = Image.open(path).resize(size, Image.LANCZOS)
        ours = png.resize(png.open_png(path), size, resample.LANCZOS)
        assert np.array_equal(ours.pixels, np.asarray(small))
        assert np.array_equal(png.to_rgba(ours), np.asarray(small.convert("RGBA")))


@pytest.mark.parametrize("mode", ["P", "LA", "1", "I;16", "L"])
def test_png_pillow_written(tmp_path, mode):
    """Files Pillow writes itself (its adaptive filters, 'bits' packing)."""
    rng = np.random.default_rng(11)
    if mode == "P":
        im = Image.fromarray(rng.integers(0, 16, size=(H, W)).astype(np.uint8), "P")
        im.putpalette(list(rng.integers(0, 256, size=48)))
        kw = {"bits": 4, "transparency": bytes(range(0, 240, 16))}
    elif mode == "LA":
        im = Image.fromarray(rng.integers(0, 256, size=(H, W, 2)).astype(np.uint8), "LA")
        kw = {}
    elif mode == "1":
        im = Image.fromarray(rng.integers(0, 2, size=(H, W)).astype(bool))
        kw = {}
    elif mode == "I;16":
        im = Image.fromarray(rng.integers(0, 65536, size=(H, W)).astype(np.uint16))
        kw = {}
    else:
        im = Image.fromarray(rng.integers(0, 256, size=(H, W)).astype(np.uint8), "L")
        kw = {"transparency": 7}
    path = str(tmp_path / "pil.png")
    im.save(path, **kw)
    pil = Image.open(path)
    img = png.open_png(path)
    assert img.mode == pil.mode
    assert np.array_equal(img.pixels, np.asarray(pil))
    assert np.array_equal(png.to_rgba(img), np.asarray(pil.convert("RGBA")))


@pytest.mark.parametrize("name", ["pal4", "la8", "gray16", "rgba16", "gray2"])
def test_load_image_matches_jax_reader(tmp_path, name):
    """data/readers.load_image equals the JAX package's (Pillow) loader, at
    full size and at -r 4, over black and white backgrounds."""
    from materialrefgs_torch.data import readers as trd
    from materialrefgs_tpu.data import readers as jrd

    case = next(c for c in CASES if c[0] == name)
    path = _make(tmp_path, *case, interlace=1, seed=3)
    for white in (False, True):
        tinfo = trd.CameraInfo(0, np.eye(3), np.zeros(3), None, 0.5, 0.5, path, "x", W, H, white)
        jinfo = jrd.CameraInfo(0, np.eye(3), np.zeros(3), None, 0.5, 0.5, path, "x", W, H, white)
        for r in (1, 4):
            ours = trd.load_image(tinfo, r, device="cpu")
            ref = jrd.load_image(jinfo, r)
            assert ours.dtype == np.float32 and np.array_equal(ours, ref), (name, white, r)


def test_mask_reader_matches_jax_cli(tmp_path):
    """scripts/train_torch.load_masks thresholds what Pillow's np.asarray
    gives, after a NEAREST resize in the file's mode, as scripts/train.py
    does (for a palette file: its indices)."""
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "train_torch", os.path.join(os.path.dirname(__file__), "..", "scripts", "train_torch.py"))
    tt = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tt)

    class Info:
        image_name = "v0"

    for name in ("pal8_alpha", "gray1", "gray16", "la8", "rgba8"):
        case = next(c for c in CASES if c[0] == name)
        mdir = tmp_path / name
        mdir.mkdir()
        src = _make(tmp_path, *case, interlace=0, seed=9)
        os.replace(src, mdir / "v0.png")
        for hw in ((H, W), (H // 2, W // 3)):
            ours = tt.load_masks(str(mdir), [Info()], hw, "cpu")[0]
            img = Image.open(mdir / "v0.png")  # scripts/train.py:188-198
            if img.size != (hw[1], hw[0]):
                img = img.resize((hw[1], hw[0]), Image.NEAREST)
            arr = np.asarray(img)
            if arr.ndim == 2:
                arr = arr[..., None]
            assert np.array_equal(ours, (arr[..., -1] > 128).astype(np.float32)), (name, hw)
