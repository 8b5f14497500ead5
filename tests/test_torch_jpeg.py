"""The port's JPEG decoder (utils/jpeg.py: markers here, the entropy decode
in csrc/jpeg_entropy.cpp built with the host compiler, the inverse DCT,
upsampling and colour conversion in the kernel's plain version on the CPU)
against Pillow's decode, which the JAX package reads photos with: every
uint8 equal. Files come from Pillow (baseline, progressive, optimised
Huffman tables, restart intervals, EXIF) and from chip_smoke_jpeg.py, the
numpy writer the card run uses. Then the JPEG COLMAP photo loaded at -r 4
against the JAX package's load_image, and the refusals. The kernel itself
is held to the plain version on the card (tests/test_torch_kernels_gpu.py,
chip_smoke.py phase 18)."""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from PIL import Image  # noqa: E402

from materialrefgs_tpu.data import readers as jrd  # noqa: E402

from materialrefgs_torch.data import readers as trd  # noqa: E402
from materialrefgs_torch.ops import nvcc  # noqa: E402
from materialrefgs_torch.utils import jpeg  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke_jpeg  # noqa: E402


@pytest.fixture
def cxx():
    if nvcc.host_compiler() is None:
        pytest.skip("needs a C++ compiler: the entropy decoder is host C++ built at first use")


def _photo(rng, H, W, gray=False):
    """Smooth colour gradients, an edge and noise: every frequency band."""
    yy, xx = np.mgrid[0:H, 0:W] / max(H, W)
    base = 128 + 90 * np.sin(9 * xx + 4 * yy)[..., None] * np.array([1.0, -0.6, 0.4])
    base = base + np.where(xx > 0.5, 40.0, -40.0)[..., None] + rng.normal(size=(H, W, 3)) * 25
    img = np.clip(base, 0, 255).astype(np.uint8)
    return img[..., 0] if gray else img


def _pillow(tmp_path, img, **kw):
    path = str(tmp_path / "photo.jpg")
    Image.fromarray(img).save(path, format="JPEG", **kw)
    return path


def _exif() -> bytes:
    exif = Image.Exif()
    exif[0x0112] = 6  # orientation: rotate 90 (neither Pillow nor the port applies it)
    exif[0x010F] = "materialrefgs"
    return exif.tobytes()


CASES = {
    "q50-420-130x74": ((74, 130), dict(quality=50)),
    "q90-420-37x23": ((23, 37), dict(quality=90)),
    "q100-420-17x9": ((9, 17), dict(quality=100)),
    "q90-444-37x23": ((23, 37), dict(quality=90, subsampling=0)),
    "q100-444-130x74": ((74, 130), dict(quality=100, subsampling=0)),
    "q50-422-17x9": ((9, 17), dict(quality=50, subsampling=1)),
    "q90-422-130x74": ((74, 130), dict(quality=90, subsampling=1)),
    "q90-420-1x1": ((1, 1), dict(quality=90)),
    "q100-444-1x1": ((1, 1), dict(quality=100, subsampling=0)),
    "q90-422-3x2": ((2, 3), dict(quality=90, subsampling=1)),
    "gray-q90-37x23": ((23, 37), dict(quality=90), True),
    "gray-q100-1x1": ((1, 1), dict(quality=100), True),
    "gray-progressive-130x74": ((74, 130), dict(quality=75, progressive=True), True),
    "progressive-420-130x74": ((74, 130), dict(quality=90, progressive=True)),
    "progressive-444-37x23": ((23, 37), dict(quality=100, subsampling=0, progressive=True)),
    "progressive-422-17x9": ((9, 17), dict(quality=50, subsampling=1, progressive=True)),
    "optimize-420-130x74": ((74, 130), dict(quality=90, optimize=True)),
    "optimize-progressive-444-37x23": ((23, 37), dict(quality=95, optimize=True, progressive=True, subsampling=0)),
    "restart-blocks-420-130x74": ((74, 130), dict(quality=90, restart_marker_blocks=1)),
    "restart-rows-422-37x23": ((23, 37), dict(quality=90, subsampling=1, restart_marker_rows=1)),
    "restart-progressive-420-130x74": ((74, 130), dict(quality=80, progressive=True, restart_marker_blocks=2)),
    "exif-420-37x23": ((23, 37), dict(quality=90, exif=_exif())),
    "rgb-444-37x23": ((23, 37), dict(quality=90, subsampling=0, keep_rgb=True)),
}


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_decode_matches_pillow(tmp_path, cxx, case):
    """decode_jpeg on the CPU equals np.asarray(Image.open(p)) exactly."""
    (H, W), kw, *gray = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    path = _pillow(tmp_path, _photo(rng, H, W, bool(gray)), **kw)
    want = np.asarray(Image.open(path))
    got = jpeg.decode_jpeg(path, device="cpu")
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert jpeg.read_jpeg_size(path) == (W, H) == trd.image_size(path)


WRITER = {
    "444": ((1, 1), 0), "422": ((2, 1), 0), "420": ((2, 2), 0), "440": ((1, 2), 0),
    "420-dri3": ((2, 2), 3), "422-dri1": ((2, 1), 1), "gray": (None, 0), "gray-dri2": (None, 2),
    "rgb-444": ((1, 1), 0, True), "rgb-420-dri2": ((2, 2), 2, True),
}


@pytest.mark.parametrize("mode", list(WRITER), ids=list(WRITER))
def test_writer_files_decode_as_in_pillow(tmp_path, cxx, mode):
    """chip_smoke_jpeg.write_jpeg's files (the card run's photos) at odd
    sizes: Pillow reads them close to the input, and the port's decode
    equals Pillow's."""
    sampling, restart, *rgb = WRITER[mode]
    rng = np.random.default_rng(len(mode))
    for H, W in ((37, 53), (9, 17), (1, 1)):
        img = _photo(rng, H, W, sampling is None)
        path = str(tmp_path / f"w{H}.jpg")
        chip_smoke_jpeg.write_jpeg(path, img, quality=95, sampling=sampling or (1, 1), restart_interval=restart,
                                   rgb=bool(rgb))
        want = np.asarray(Image.open(path))
        assert want.shape == img.shape
        assert not rgb or Image.open(path).info["adobe_transform"] == 0
        if sampling in (None, (1, 1)):
            assert np.abs(want.astype(int) - img).mean() < 6.0
        np.testing.assert_array_equal(jpeg.decode_jpeg(path, device="cpu").numpy(), want)


def test_range_limit_saturates_as_pillow_does(tmp_path, cxx):
    """Blocks whose inverse DCT overshoots the sample range by far (a
    quality-100 file of flat bands with its DC quantum raised to 6
    afterwards, |v| up to ~750): Pillow's libjpeg-turbo (x86-64 SIMD IDCT)
    saturates them, where the C IDCT's `& RANGE_MASK` table would wrap them
    mod 1024; the port saturates, and the wrap would have differed here."""
    H, W = 24, 40
    xx = np.mgrid[0:H, 0:W][1]
    img = np.choose((xx // 8) % 3, [250, 5, 128]).astype(np.uint8)
    data = bytearray(chip_smoke_jpeg.encode_jpeg(img, quality=100, sampling=(1, 1)))
    data[data.index(b"\xff\xdb") + 5] = 6  # table 0's DC quantum
    path = str(tmp_path / "overshoot.jpg")
    with open(path, "wb") as f:
        f.write(bytes(data))
    co = jpeg.read_coefficients(path)
    blocks = torch.from_numpy(co.coef).to(torch.int32) * torch.from_numpy(co.quant[0])
    v = jpeg.idct_descaled(blocks.view(-1, 8, 8))
    assert int(((v < -512) | (v > 511)).sum()) >= 256
    want = np.asarray(Image.open(path))
    np.testing.assert_array_equal(jpeg.decode_jpeg(path, device="cpu").numpy(), want)
    c = co.comps[0]
    wrapped = torch.clamp((((v & 1023) ^ 512) - 512) + 128, 0, 255)
    wrapped = wrapped.view(c.bh, c.bw, 8, 8).permute(0, 2, 1, 3).reshape(c.bh * 8, c.bw * 8)[:H, :W]
    assert int((wrapped.numpy() != want).sum()) >= 256


def test_cpu_tensors_take_the_plain_version(tmp_path, cxx, monkeypatch):
    """idct_color on CPU tensors runs idct_color_plain and counts no kernel
    launch; on a device other than the CPU or CUDA it raises."""
    path = _pillow(tmp_path, _photo(np.random.default_rng(1), 23, 37), quality=90)
    co = jpeg.read_coefficients(path)
    calls = []
    real = jpeg.idct_color_plain
    monkeypatch.setattr(jpeg, "idct_color_plain", lambda *a, **k: calls.append(1) or real(*a, **k))
    before = jpeg.idct_color.launches
    out = jpeg.idct_color(torch.from_numpy(co.coef), torch.from_numpy(co.quant), co.comps, co.height, co.width,
                          co.color)
    assert calls == [1] and jpeg.idct_color.launches == before
    np.testing.assert_array_equal(out.numpy(), np.asarray(Image.open(path)))
    with pytest.raises(ValueError, match="unsupported device"):
        jpeg.idct_color(torch.from_numpy(co.coef).to("meta"), torch.from_numpy(co.quant).to("meta"), co.comps,
                        co.height, co.width, co.color)


@pytest.mark.parametrize("kw", [dict(quality=90), dict(quality=90, subsampling=1),
                                dict(quality=85, progressive=True)], ids=["420", "422", "progressive"])
def test_load_image_of_a_jpeg_colmap_photo_matches_jax(tmp_path, cxx, kw):
    """load_image at -r 4 (LANCZOS) on an odd-sized JPEG photo: float32 arrays
    equal to the JAX package's load_image (Pillow decode and resize)."""
    rng = np.random.default_rng(len(kw))
    H, W = 83, 130
    path = _pillow(tmp_path, _photo(rng, H, W), **kw)
    info = dict(uid=0, R=np.eye(3), T=np.zeros(3), K=None, FovY=0.5, FovX=0.7, image_path=path,
                image_name="photo", width=W, height=H)
    a = jrd.load_image(jrd.CameraInfo(**info), 4)
    b = trd.load_image(trd.CameraInfo(**info), 4, device="cpu")
    assert b.shape == a.shape == (H // 4, W // 4, 3) and b.dtype == np.float32
    np.testing.assert_array_equal(b, a)


def test_unsupported_files_are_refused(tmp_path, cxx):
    """CMYK JPEG, a file that is no image, arithmetic coding and 12-bit
    precision raise NotImplementedError naming ROADMAP.md A13; a truncated
    file, an over-subscribed Huffman table (more codes of a length than fit
    in it) and a scan's table selector past 3 raise ValueError."""
    cmyk = str(tmp_path / "cmyk.jpg")
    Image.fromarray(np.full((16, 16, 4), 60, np.uint8), "CMYK").save(cmyk, format="JPEG")
    other = str(tmp_path / "other.bin")
    with open(other, "wb") as f:
        f.write(b"BM" + bytes(100))
    for path in (cmyk, other):
        with pytest.raises(NotImplementedError, match="ROADMAP.md A13"):
            trd.read_image(path, device="cpu")
    good = _pillow(tmp_path, _photo(np.random.default_rng(2), 16, 16), quality=90)
    data = open(good, "rb").read()
    sof = data.index(b"\xff\xc0")
    for marker, precision, what in ((0xC9, 8, "arithmetic"), (0xC0, 12, "12-bit")):
        patched = bytearray(data)
        patched[sof + 1], patched[sof + 4] = marker, precision
        p = str(tmp_path / f"{what}.jpg")
        with open(p, "wb") as f:
            f.write(bytes(patched))
        with pytest.raises(NotImplementedError, match=f"{what}.*ROADMAP.md A13"):
            jpeg.decode_jpeg(p, device="cpu")
    cut = str(tmp_path / "cut.jpg")
    with open(cut, "wb") as f:
        f.write(data[: len(data) * 2 // 3])
    with pytest.raises(ValueError):
        jpeg.decode_jpeg(cut, device="cpu")
    dht, sos = data.index(b"\xff\xc4"), data.index(b"\xff\xda")
    assert data[dht + 4] == 0x00  # the luma DC table; its 16 counts follow
    n = sum(data[dht + 5 : dht + 21])
    for what, at, patch, msg in (
        ("oversubscribed", dht + 5, bytes([n]) + bytes(15), "malformed Huffman table"),
        ("oversubscribed-3", dht + 5, bytes([3]) + bytes(14) + bytes([n - 3]), "malformed Huffman table"),
        ("selector", sos + 6, bytes([0x50]), "bad scan header"),
    ):
        patched = bytearray(data)
        patched[at : at + len(patch)] = patch
        p = str(tmp_path / f"{what}.jpg")
        with open(p, "wb") as f:
            f.write(bytes(patched))
        with pytest.raises(ValueError, match=msg):
            jpeg.decode_jpeg(p, device="cpu")
