"""The port's native COLMAP parse (data/native_io.py over csrc/colmap_io.cpp,
built with the host compiler) against the JAX package's native loader
(materialrefgs_tpu/data/native_io.py over native/fastio.cpp) and the pure
parser (data/colmap_loader.py) on sparse models written here: images with
2D points, points with tracks, names of several lengths, an empty model;
and the refusal of a truncated file."""
import os
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from materialrefgs_tpu.data import native_io as jnative  # noqa: E402

from materialrefgs_torch.data import colmap_loader as cl  # noqa: E402
from materialrefgs_torch.data import native_io  # noqa: E402
from materialrefgs_torch.data import readers as trd  # noqa: E402
from materialrefgs_torch.ops import nvcc  # noqa: E402


@pytest.fixture
def cxx():
    if nvcc.host_compiler() is None:
        pytest.skip("needs a C++ compiler: the parser is host C++ built at first use")


def write_model(sparse, n_images, n_points, seed):
    """images.bin and points3D.bin with random poses, 2D points, colours,
    errors and tracks (ids not in file order)."""
    rng = np.random.default_rng(seed)
    os.makedirs(sparse, exist_ok=True)
    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", n_images))
        for i in range(n_images):
            q = rng.normal(size=4)
            q /= np.linalg.norm(q)
            name = f"img_{i:04d}" + "x" * int(rng.integers(0, 9)) + ".jpg"
            f.write(struct.pack("<idddddddi", 3 * i + 7, *q, *rng.normal(size=3), int(rng.integers(1, 4))))
            f.write(name.encode() + b"\x00")
            n2 = int(rng.integers(0, 40))
            f.write(struct.pack("<Q", n2))
            for _ in range(n2):
                f.write(struct.pack("<ddq", *rng.uniform(0, 100, 2), int(rng.integers(-1, 1000))))
    rec = np.zeros(n_points, np.dtype([("id", "<u8"), ("xyz", "<f8", 3), ("rgb", "u1", 3), ("err", "<f8"),
                                       ("tl", "<u8")]))
    rec["id"] = rng.permutation(n_points) + 1
    rec["xyz"] = rng.normal(size=(n_points, 3))
    rec["rgb"] = rng.integers(0, 256, size=(n_points, 3))
    rec["err"] = rng.uniform(size=n_points)
    rec["tl"] = rng.integers(0, 5, size=n_points)
    with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", n_points))
        for r in rec:
            f.write(r.tobytes())
            f.write(rng.integers(0, 100, size=2 * int(r["tl"])).astype("<i4").tobytes())


@pytest.mark.parametrize("n_images,n_points", [(11, 500), (1, 1), (0, 0)], ids=["model", "one", "empty"])
def test_native_parse_matches_jax_and_pure(tmp_path, cxx, n_images, n_points):
    sparse = str(tmp_path / "sparse")
    write_model(sparse, n_images, n_points, seed=n_images + n_points)
    img_bin, pts_bin = os.path.join(sparse, "images.bin"), os.path.join(sparse, "points3D.bin")

    ids, qvec, tvec, camid, names = native_io.read_images(img_bin)
    pure = cl.read_extrinsics_binary(img_bin)
    assert list(ids) == list(pure.keys())
    for k, i in enumerate(ids):
        ref = pure[int(i)]
        np.testing.assert_array_equal(qvec[k], ref.qvec)
        np.testing.assert_array_equal(tvec[k], ref.tvec)
        assert (int(camid[k]), names[k]) == (ref.camera_id, ref.name)
    j = jnative.read_images(img_bin)
    if n_images:  # the JAX loader's empty model has no buffers to return
        for a, b in zip((qvec, tvec, camid, names), j):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    xyz, rgb, err = native_io.read_points3d(pts_bin)
    assert xyz.shape == (n_points, 3) and rgb.dtype == np.uint8
    for a, b in zip((xyz, rgb, err), cl.read_points3D_binary(pts_bin)):
        np.testing.assert_array_equal(a, b)
    if n_points:
        for a, b in zip((xyz, rgb, err), jnative.read_points3d(pts_bin)):
            np.testing.assert_array_equal(a, b)


def test_read_colmap_scene_parses_natively(tmp_path, cxx, monkeypatch):
    """read_colmap_scene takes images.bin and points3D.bin through
    native_io, never through the pure parser's binary readers."""
    from test_torch_colmap import ring_eyes, write_colmap

    root = str(tmp_path / "scene")
    write_colmap(root, ring_eyes(4), (40, 30))
    for name in ("read_extrinsics_binary", "read_points3D_binary"):
        monkeypatch.setattr(cl, name, lambda *a, _n=name: pytest.fail(f"{_n} was called"))
    info = trd.load_scene_info(root)
    assert len(info.train_cameras) == 4 and len(info.point_cloud.points) > 0


def test_truncated_files_raise(tmp_path, cxx):
    sparse = str(tmp_path / "sparse")
    write_model(sparse, 5, 50, seed=3)
    for name, read in (("images.bin", native_io.read_images), ("points3D.bin", native_io.read_points3d)):
        path = os.path.join(sparse, name)
        data = open(path, "rb").read()
        with open(path, "wb") as f:
            f.write(data[: len(data) - 30])
        with pytest.raises(ValueError, match="truncated"):
            read(path)
    with pytest.raises(ValueError, match="cannot open"):
        native_io.read_points3d(str(tmp_path / "missing.bin"))
