"""The port's training tooling against the JAX package's: the fly-through
camera paths (utils/video.py), the remote-viewer wire format
(utils/network_gui.py, cameras.make_minicam), TrainLogger's psnr.json
across a resume, the Trainer's visualisation grid, and
scripts/render_video_torch.py on a trained run."""
import json
import os
import socket
import struct
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from materialrefgs_tpu.cameras import look_at_camera as jax_camera  # noqa: E402
from materialrefgs_tpu.utils import network_gui as jgui  # noqa: E402
from materialrefgs_tpu.utils import video as jvideo  # noqa: E402

from materialrefgs_torch.cameras import look_at_camera as torch_camera  # noqa: E402
from materialrefgs_torch.utils import network_gui as tgui  # noqa: E402
from materialrefgs_torch.utils import video as tvideo  # noqa: E402
from materialrefgs_torch.utils.logging_utils import TrainLogger  # noqa: E402


def _rings(n, r=3.0, size=32):
    kws = []
    for i in range(n):
        a = 2 * np.pi * i / n
        kws.append(dict(eye=np.array([r * np.sin(a), 0.4 + 0.1 * np.cos(3 * a), -r * np.cos(a)]), target=np.zeros(3),
                        up=np.array([0.0, 1.0, 0.0]), fovx=0.9, fovy=0.8, width=size, height=size))
    return [jax_camera(**k) for k in kws], [torch_camera(**k, device="cpu") for k in kws]


def _same_cams(tcams, jcams):
    assert len(tcams) == len(jcams)
    for t, j in zip(tcams, jcams):
        for name in ("world_view", "full_proj", "camera_center"):
            np.testing.assert_allclose(getattr(t, name).numpy(), np.asarray(getattr(j, name)), atol=2e-6, rtol=1e-6,
                                       err_msg=name)
        assert (t.width, t.height, t.fovx, t.fovy) == (j.width, j.height, j.fovx, j.fovy)


def test_camera_paths_match_jax():
    """interpolate_cameras and generate_ellipse_path give JAX's poses."""
    jc, tc = _rings(4)
    _same_cams(tvideo.interpolate_cameras(tc, num=4), jvideo.interpolate_cameras(jc, num=4))
    jc, tc = _rings(12)
    _same_cams(tvideo.generate_ellipse_path(tc, n_frames=24), jvideo.generate_ellipse_path(jc, n_frames=24))
    _same_cams(tvideo.generate_ellipse_path(tc, n_frames=8, z_variation=0.5),
               jvideo.generate_ellipse_path(jc, n_frames=8, z_variation=0.5))


def _client(port, msg, results):
    s = socket.create_connection(("127.0.0.1", port), timeout=5)

    def recv(n):
        buf = b""
        while len(buf) < n:
            buf += s.recv(n - len(buf))
        return buf

    results["items"] = json.loads(recv(struct.unpack("I", recv(4))[0]).decode())
    raw = json.dumps(msg).encode()
    s.sendall(len(raw).to_bytes(4, "little") + raw)
    results["image"] = recv(msg["resolution_x"] * msg["resolution_y"] * 3)
    results["verify"] = recv(int.from_bytes(recv(4), "little")).decode()
    results["metrics"] = json.loads(recv(struct.unpack("I", recv(4))[0]).decode())
    s.close()


def _serve(gui, msg, image):
    port = gui.listener.getsockname()[1]
    results = {}
    t = threading.Thread(target=_client, args=(port, msg, results))
    t.start()
    deadline = time.monotonic() + 30.0  # the non-blocking accept, polled as a trainer polls it
    while not gui.try_connect(["RGB", "Depth"]):
        assert time.monotonic() < deadline, "the client never connected"
        time.sleep(0.001)
    received = gui.receive()
    gui.send(image, "ok", {"psnr": 30.0})
    t.join(timeout=5)
    gui.close()
    gui.listener.close()
    return received, results


def test_network_gui_wire_format_matches_jax():
    """The same viewer message gives the same camera in both packages, and
    both send the same bytes back."""
    rng = np.random.default_rng(0)
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    wv = np.eye(4)
    wv[:3, :3], wv[3, :3] = R, rng.normal(size=3)
    fp = wv @ np.diag([1.3, 1.1, 1.0, 1.0])
    msg = {"resolution_x": 12, "resolution_y": 8, "train": 1, "fov_y": 0.7, "fov_x": 0.9, "z_near": 0.01,
           "z_far": 100.0, "keep_alive": 1, "scaling_modifier": 0.75, "view_matrix": wv.flatten().tolist(),
           "view_projection_matrix": fp.flatten().tolist(), "render_mode": "Depth"}
    image = rng.uniform(size=(8, 12, 3)).astype(np.float32)
    (tcam, *trest), tres = _serve(tgui.NetworkGUI(port=0, device="cpu"), msg, torch.from_numpy(image))
    (jcam, *jrest), jres = _serve(jgui.NetworkGUI(port=0), msg, image)
    assert trest == jrest == [True, True, 0.75, "Depth"]
    _same_cams([tcam], [jcam])
    assert (tcam.fx, tcam.fy, tcam.cx, tcam.cy) == (float(jcam.fx), float(jcam.fy), float(jcam.cx), float(jcam.cy))
    assert tres == jres and tres["items"] == ["RGB", "Depth"] and tres["metrics"] == {"psnr": 30.0}


def test_train_logger_continues_psnr_across_resume(tmp_path):
    log = TrainLogger(str(tmp_path))
    log.test_psnr(100, 20.5)
    log.test_psnr(200, 22.25)
    log.scalars(200, {"loss": 0.5, "stage": "surfel"})
    log.close()
    resumed = TrainLogger(str(tmp_path))
    resumed.test_psnr(300, 23.0)
    resumed.close()
    with open(tmp_path / "psnr.json") as f:
        assert json.load(f) == [{"iteration": 100, "psnr": 20.5}, {"iteration": 200, "psnr": 22.25},
                                {"iteration": 300, "psnr": 23.0}]


def test_vis_grid_and_render_video(tmp_path):
    """The Trainer writes {vis_dir}/{iteration:06d}.png every vis_every
    iterations past `initial` (a 2 x 3 grid of the view's maps), and
    scripts/render_video_torch.py renders an ellipse of frames from a run's
    PLY."""
    import dataclasses

    from materialrefgs_torch import config as tcfg
    from materialrefgs_torch.models import gaussian_io
    from materialrefgs_torch.models import gaussian_model as tgm
    from materialrefgs_torch.ops.rasterize.api import RasterizeConfig
    from materialrefgs_torch.train.trainer import Trainer
    from materialrefgs_torch.utils import png
    from test_torch_train import _load_script, _synthetic_scene, _write_blender_scene

    cams, images, gt_means, rng = _synthetic_scene(n_cams=3, size=32, P=48)
    model = tgm.create_from_points(gt_means.astype(np.float32), rng.uniform(size=(48, 3)).astype(np.float32),
                                   capacity=128, device="cpu")
    opt = dataclasses.replace(tcfg.OptimizationParams(), use_perceptual_loss=False, initial=1, init_until_iter=2,
                              volume_render_until_iter=0)
    trainer = Trainer(model, cams, images, opt, tcfg.PipelineParams(), raster_cfg=RasterizeConfig(1 << 13),
                      envmap_res=16, vis_dir=str(tmp_path / "vis"), vis_every=2)
    trainer.train(4)
    assert sorted(os.listdir(tmp_path / "vis")) == ["000004.png"]  # iteration 2 was `initial`
    grid = png.read_png(str(tmp_path / "vis" / "000004.png"))
    assert grid.shape == (64, 96, 3) and grid.std() > 0

    scene, run = str(tmp_path / "scene"), str(tmp_path / "run")
    _write_blender_scene(scene, n_views=3)
    st = trainer.state
    gaussian_io.save_ply(st.model, os.path.join(run, "point_cloud", "iteration_4", "point_cloud.ply"),
                         env1=st.env1, env2=st.env2)
    out = _load_script("render_video_torch").main(["-m", run, "-s", scene, "--n_frames", "3", "--device", "cpu",
                                                   "--pair_capacity", "16384"])
    frames = sorted(os.listdir(out))
    assert frames == [f"frame_{i:05d}.png" for i in range(3)]
    assert png.read_png(os.path.join(out, frames[0])).shape == (32, 32, 3)
