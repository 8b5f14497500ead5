"""The port's multi-process data parallelism (parallel/multihost.py): two
worker processes join one gloo group over a tcp:// rendezvous and take one
make_dp_train_step step with the gradients averaged across them; both end
with the same parameters, and the step matches JAX make_dp_train_step on 2
virtual devices for the same scene (tests/test_multihost.py's worker)."""
import os
import re
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import Mesh  # noqa: E402

from materialrefgs_tpu.cameras import look_at_camera  # noqa: E402
from materialrefgs_tpu.config import OptimizationParams, PipelineParams  # noqa: E402
from materialrefgs_tpu.models import gaussian_model as gm  # noqa: E402
from materialrefgs_tpu.ops.rasterize.api import RasterizeConfig  # noqa: E402
from materialrefgs_tpu.parallel.data_parallel import make_dp_train_step, stack_cameras  # noqa: E402
from materialrefgs_tpu.train.trainer import init_train_state  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_step(n=2):
    """The JAX worker's scene and step (multihost.py:69-138) on one process
    with n devices: camera k of n on the ring, GT from rng(100 + k)."""
    mesh = Mesh(np.array(jax.devices()[:n]), ("dp",))
    rng = np.random.default_rng(0)
    W = H = 32
    pts = rng.normal(size=(64, 3)).astype(np.float32)
    cols = rng.uniform(size=(64, 3)).astype(np.float32)
    state = init_train_state(gm.create_from_points(pts, cols, capacity=128), OptimizationParams(), envmap_res=32)
    cams = []
    for k in range(n):
        ang = 2 * np.pi * k / n
        eye = np.array([3.0 * np.sin(ang), 0.4, -3.0 * np.cos(ang)])
        cams.append(look_at_camera(eye, np.zeros(3), np.array([0.0, 1.0, 0.0]), 0.9, 0.9, W, H))
    gt = np.stack([np.random.default_rng(100 + k).uniform(size=(1, H, W, 3)).astype(np.float32)[0]
                   for k in range(n)])
    step = make_dp_train_step(mesh, OptimizationParams(), PipelineParams(), spatial_lr_scale=3.0,
                              raster_cfg=RasterizeConfig(pair_capacity=1 << 10, interpret=True),
                              envmap_n_samples=4)
    state, metrics = step(state, stack_cameras(cams), jnp.asarray(gt), jnp.float32(1.0))
    return float(metrics["loss"]), float(jnp.sum(jnp.abs(state.model.params.xyz)))


def test_two_process_dp_step_matches_jax():
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "materialrefgs_torch.parallel.multihost", "--coordinator", f"localhost:{port}",
         "--num_processes", "2", "--process_id", str(k), "--device", "cpu"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for k in range(2)]
    try:
        loss_ref, digest_ref = _jax_step()  # while the workers run
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    lines = []
    for k, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {k}:\n{out[-3000:]}"
        m = re.search(rf"MULTIHOST OK p{k}/2 loss=(\S+) digest=(\S+)", out)
        assert m, f"worker {k} printed no OK line:\n{out[-3000:]}"
        lines.append((float(m.group(1)), m.group(2)))
    # The averaged gradient leaves both processes with the same parameters.
    assert lines[0] == lines[1]
    np.testing.assert_allclose(lines[0][0], loss_ref, rtol=1e-5)
    # One Adam step from zero moments moves each coordinate by lr * g / |g|,
    # so a gradient within rounding of zero with the other sign would move
    # the digest by 2 lr (9.6e-4); at most the 6-decimal print differs.
    assert abs(float(lines[0][1]) - digest_ref) <= 2e-6 * digest_ref, (lines[0][1], digest_ref)
