"""The port's COLMAP data path against the JAX package: the sparse-model
reader (binary and text, SIMPLE_PINHOLE and PINHOLE, an off-centre principal
point, W != H, the refusal of distorted models), the cameras built from it at
-r 2, the image loader's Pillow resizes (LANCZOS for photos, NEAREST for
masks, BILINEAR for GT normal maps) and the refusal of images the port
cannot decode. The scenes are written here; the JAX side reads them with
Pillow."""
import importlib.util
import os
import shutil
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from PIL import Image  # noqa: E402

from materialrefgs_tpu.data import readers as jrd  # noqa: E402
from materialrefgs_tpu.models import scene as jscene  # noqa: E402

from materialrefgs_torch.data import readers as trd  # noqa: E402
from materialrefgs_torch.models import scene as tscene  # noqa: E402
from materialrefgs_torch.utils import png, resample  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = {"SIMPLE_PINHOLE": (0, 3), "PINHOLE": (1, 4), "OPENCV": (4, 8)}


def look_at_qt(eye):
    """COLMAP (qvec w, x, y, z; tvec) of a camera at `eye` looking at the
    origin, +y down in the image."""
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, [0.0, -1.0, 0.0])
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd])  # world -> camera rows
    t = -R @ eye
    w = np.sqrt(max(1.0 + np.trace(R), 1e-12)) / 2
    q = np.array([w, (R[2, 1] - R[1, 2]) / (4 * w), (R[0, 2] - R[2, 0]) / (4 * w), (R[1, 0] - R[0, 1]) / (4 * w)])
    return q / np.linalg.norm(q), t


def write_colmap(root, eyes, size, model="PINHOLE", params=None, binary=True, points=None, seed=0):
    """A COLMAP sparse model under root/sparse/0 for cameras at `eyes` (one
    shared camera of `size` = (W, H)), images named view_{i:03d}.png in
    shuffled order, and a coloured point cloud; returns the params."""
    rng = np.random.default_rng(seed)
    W, H = size
    mid, n_par = MODELS[model]
    if params is None:
        f = 0.9 * W
        params = {"SIMPLE_PINHOLE": [f, W / 2 + 2.3, H / 2 - 1.7],
                  "PINHOLE": [f, 1.013 * f, W / 2 + 2.3, H / 2 - 1.7]}.get(model, [f, f, W / 2, H / 2, 0.01, 0, 0, 0])
    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(sparse, exist_ok=True)
    order = rng.permutation(len(eyes))
    pts = points if points is not None else rng.normal(size=(50, 3)) * 0.5
    rgb = rng.integers(0, 256, size=(len(pts), 3))
    if binary:
        with open(os.path.join(sparse, "cameras.bin"), "wb") as fh:
            fh.write(struct.pack("<Q", 1) + struct.pack("<iiQQ", 1, mid, W, H) + struct.pack(f"<{n_par}d", *params))
        with open(os.path.join(sparse, "images.bin"), "wb") as fh:
            fh.write(struct.pack("<Q", len(eyes)))
            for k, i in enumerate(order):
                q, t = look_at_qt(np.asarray(eyes[i], np.float64))
                fh.write(struct.pack("<idddddddi", k + 1, *q, *t, 1) + f"view_{i:03d}.png".encode() + b"\x00")
                fh.write(struct.pack("<Q", 2) + struct.pack("<ddqddq", 1.5, 2.5, 3, 4.0, 5.0, -1))
        with open(os.path.join(sparse, "points3D.bin"), "wb") as fh:
            fh.write(struct.pack("<Q", len(pts)))
            for j, (p, c) in enumerate(zip(pts, rgb)):
                fh.write(struct.pack("<QdddBBBd", j + 1, *p, *map(int, c), 0.5) + struct.pack("<Q", 2))
                fh.write(struct.pack("<iiii", 1, 0, 2, 1))
    else:
        with open(os.path.join(sparse, "cameras.txt"), "w") as fh:
            fh.write("# Camera list\n1 " + model + f" {W} {H} " + " ".join(repr(float(v)) for v in params) + "\n")
        with open(os.path.join(sparse, "images.txt"), "w") as fh:
            fh.write("# Image list\n")
            for k, i in enumerate(order):
                q, t = look_at_qt(np.asarray(eyes[i], np.float64))
                fh.write(f"{k + 1} " + " ".join(repr(float(v)) for v in (*q, *t)) + f" 1 view_{i:03d}.png\n")
                fh.write("1.5 2.5 3 4.0 5.0 -1\n" if k % 2 else "\n")
        with open(os.path.join(sparse, "points3D.txt"), "w") as fh:
            fh.write("# 3D point list\n")
            for j, (p, c) in enumerate(zip(pts, rgb)):
                fh.write(f"{j + 1} " + " ".join(repr(float(v)) for v in p) + " " + " ".join(map(str, c))
                         + " 0.5 1 0 2 1\n")
    return params


def ring_eyes(n, radius=3.2):
    return [np.array([radius * np.sin(a), 0.3 * (-1) ** i, -radius * np.cos(a)])
            for i, a in enumerate(np.deg2rad(15.0 * np.arange(n)))]


def _load_both(root, eval_split):
    """Each package reads its own copy (the first read caches points3D.ply)."""
    out = []
    for side, mod in (("jax", jrd), ("torch", trd)):
        d = f"{root}_{side}"
        shutil.copytree(root, d)
        out.append(mod.load_scene_info(d, eval_split=eval_split))
        out.append(mod.load_scene_info(d, eval_split=eval_split))  # from the cached PLY
    return out


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "text"])
@pytest.mark.parametrize("model", ["SIMPLE_PINHOLE", "PINHOLE"])
def test_colmap_reader_matches_jax(tmp_path, model, binary):
    """R, T, K and the fields of view (float64, exact), names, sizes, the
    llffhold split (names sorted) and the point cloud (float32, exact), on
    the first read and from the cached points3D.ply; the cameras built at
    -r 2 (non-square, off-centre K) are the JAX package's."""
    root = str(tmp_path / "scene")
    write_colmap(root, ring_eyes(10), (61, 43), model=model, binary=binary, seed=len(model) + binary)
    for i in range(10):  # the reader never opens them; load_image would
        png.write_png(os.path.join(root, "images", f"view_{i:03d}.png"), np.zeros((43, 61, 3), np.uint8))
    j1, j2, t1, t2 = _load_both(root, eval_split=True)
    assert [c.image_name for c in t1.test_cameras] == ["view_000", "view_008"]
    for j, t in ((j1, t1), (j2, t2)):
        assert len(t.train_cameras) == 8
        for js, ts in ((j.train_cameras, t.train_cameras), (j.test_cameras, t.test_cameras)):
            assert [c.image_name for c in ts] == [c.image_name for c in js]
            for a, b in zip(js, ts):
                for k in ("R", "T", "K"):
                    np.testing.assert_array_equal(getattr(b, k), getattr(a, k), err_msg=k)
                assert (b.FovX, b.FovY, b.width, b.height, b.uid) == (a.FovX, a.FovY, a.width, a.height, a.uid)
                assert os.path.basename(b.image_path) == os.path.basename(a.image_path)
        for k in range(3):
            np.testing.assert_array_equal(t.point_cloud[k], j.point_cloud[k])
            assert t.point_cloud[k].dtype == np.float32
        np.testing.assert_array_equal(t.nerf_normalization["translate"], j.nerf_normalization["translate"])
        assert t.nerf_normalization["radius"] == j.nerf_normalization["radius"]
    for a, b in zip(j1.train_cameras, t1.train_cameras):
        jc, tc = jscene.build_camera(a, 2), tscene.build_camera(b, 2, "cpu")
        assert (tc.width, tc.height) == (jc.width, jc.height) == (30, 21)
        assert (tc.fx, tc.fy, tc.cx, tc.cy) == (float(jc.fx), float(jc.fy), float(jc.cx), float(jc.cy))
        assert tc.fx != tc.fy or model == "SIMPLE_PINHOLE"
        for k in ("world_view", "full_proj", "camera_center"):
            np.testing.assert_array_equal(getattr(tc, k).numpy(), np.asarray(getattr(jc, k)), err_msg=k)
    if binary and model == "PINHOLE":
        no_split = trd.load_scene_info(f"{root}_torch", eval_split=False)
        assert len(no_split.train_cameras) == 10 and no_split.test_cameras == []


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "text"])
def test_distorted_camera_models_are_refused(tmp_path, binary):
    root = str(tmp_path / "scene")
    write_colmap(root, ring_eyes(3), (40, 30), model="OPENCV", binary=binary)
    for mod in (jrd, trd):
        with pytest.raises(ValueError, match="Unsupported COLMAP camera model OPENCV"):
            mod.load_scene_info(root, eval_split=True)


def _photo(rng, H, W, C):
    yy, xx = np.mgrid[0:H, 0:W]
    base = 127 + 100 * np.sin(0.3 * xx[..., None] + 0.2 * yy[..., None] + np.arange(C))
    img = np.clip(base + rng.normal(size=(H, W, C)) * 30, 0, 255).astype(np.uint8)
    if C == 4:
        img[..., 3] = np.where(rng.uniform(size=(H, W)) < 0.3, rng.integers(0, 256, size=(H, W)),
                               np.where((xx - W / 2) ** 2 + (yy - H / 2) ** 2 < (H / 3) ** 2, 255, 0))
    return img


@pytest.mark.parametrize("channels", [3, 4], ids=["rgb", "rgba"])
@pytest.mark.parametrize("scale", [2, 4])
def test_load_image_resizes_as_pillow_does(tmp_path, channels, scale):
    """load_image at resolution_scale 2 and 4 on an odd-sized PNG (RGBA
    resized premultiplied, then composited over the background): equal to
    the JAX package's Pillow LANCZOS, bit for bit."""
    rng = np.random.default_rng(channels * 10 + scale)
    H, W = 83, 117
    path = str(tmp_path / "photo.png")
    png.write_png(path, _photo(rng, H, W, channels))
    for white in (False, True):
        kw = dict(uid=0, R=np.eye(3), T=np.zeros(3), K=None, FovY=0.5, FovX=0.7, image_path=path,
                  image_name="photo", width=W, height=H, white_background=white)
        a = jrd.load_image(jrd.CameraInfo(**kw), scale)
        b = trd.load_image(trd.CameraInfo(**kw), scale)
        assert b.shape == a.shape == (H // scale, W // scale, 3) and b.dtype == np.float32
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("method", ["lanczos", "bilinear", "nearest"])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_resize_matches_pillow(method, channels):
    """utils/resample.resize against Pillow on odd sizes, down by 2, 3 and 4
    and up by 1.4: every uint8 value equal."""
    rng = np.random.default_rng(channels)
    pil = {"lanczos": Image.LANCZOS, "bilinear": Image.BILINEAR, "nearest": Image.NEAREST}[method]
    for (H, W), (w, h) in (((37, 53), (26, 18)), ((41, 29), (9, 13)), ((67, 99), (24, 16)), ((20, 30), (42, 28))):
        img = _photo(rng, H, W, channels)
        img = img[..., 0] if channels == 1 else img
        want = np.asarray(Image.fromarray(img).resize((w, h), pil))
        got = resample.resize(img, (w, h), method)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def _script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_masks_and_gt_normals_of_another_size(tmp_path):
    """Masks of another size take Pillow's NEAREST (scripts/train.py), GT
    normal maps Pillow's BILINEAR (scripts/eval.py, whose load_gt_normals
    the port's is held to)."""
    rng = np.random.default_rng(5)
    H, W, h, w = 50, 70, 23, 31
    mask_dir, norm_dir = tmp_path / "mask", tmp_path / "normal"
    names = ["a", "b"]
    for n in names:
        png.write_png(str(mask_dir / f"{n}.png"), _photo(rng, H, W, 4))
        png.write_png(str(norm_dir / f"{n}.png"), _photo(rng, H, W, 4))
    infos = [trd.CameraInfo(0, np.eye(3), np.zeros(3), None, 0.5, 0.5, "", n, w, h) for n in names]
    masks = _script("train_torch").load_masks(str(mask_dir), infos, (h, w))
    for n, m in zip(names, masks):
        want = np.asarray(Image.open(str(mask_dir / f"{n}.png")).resize((w, h), Image.NEAREST))[..., -1] > 128
        np.testing.assert_array_equal(m, want.astype(np.float32))
    tn, tm = _script("eval_torch").load_gt_normals(str(tmp_path), names, (h, w))
    jn, jm = _script("eval").load_gt_normals(str(tmp_path), names, (h, w))
    for a, b in zip(jn + jm, tn + tm):
        np.testing.assert_array_equal(b, a)


def test_images_that_are_not_png_are_refused(tmp_path):
    """Photos the port cannot decode raise NotImplementedError naming the
    ROADMAP item of the decoder when the loader reads them: a CMYK JPEG
    (four components) and a file that is neither PNG nor JPEG. A JPEG photo
    itself loads (tests/test_torch_jpeg.py holds it to Pillow)."""
    root = str(tmp_path / "scene")
    write_colmap(root, ring_eyes(2), (40, 30))
    os.makedirs(os.path.join(root, "images"))
    Image.fromarray(np.zeros((30, 40, 4), np.uint8), "CMYK").save(os.path.join(root, "images", "view_000.png"),
                                                                   format="JPEG")
    with open(os.path.join(root, "images", "view_001.png"), "wb") as f:
        f.write(b"GIF89a" + bytes(64))
    info = trd.load_scene_info(root)
    for cam in info.train_cameras:
        with pytest.raises(NotImplementedError, match="ROADMAP.md A13"):
            trd.load_image(cam, 2, device="cpu")
