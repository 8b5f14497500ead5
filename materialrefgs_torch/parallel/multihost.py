"""Process-group set-up across hosts for camera-batch data parallelism (the
JAX package's parallel/multihost.py).

Every process holds the full replicated gaussian and env parameters and
renders its own camera; the gradient all_reduce inside the step spans every
process of the default group, within a host over NVLink and across hosts
over the network, since torch.distributed joins them all into one group.
Nothing in the step changes; the group just gets wider.

In JAX one process drives all of its host's local devices, so a run of P
processes x D local devices has one mesh of P * D devices. Here a process
drives one device, so the same run is P * D ranks: rank r takes the local
card r % D (`cuda:<LOCAL_RANK>` under torchrun).

`python -m materialrefgs_torch.parallel.multihost --num_processes N
--process_id k [--coordinator host:port] [--device cpu]` runs one worker:
a tiny scene, one make_dp_train_step step over the group, and a line
`MULTIHOST OK p{k}/{N} loss=... digest=...` (tests/test_torch_multihost.py
starts N of them).
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None,
               device: str | torch.device = "cuda") -> None:
    """Join the default process group. Under torchrun (RANK and WORLD_SIZE
    set in the environment) its MASTER_ADDR / MASTER_PORT rendezvous is
    used; otherwise `coordinator` ("host:port", the rank-0 host) with a
    tcp:// init method, `num_processes` ranks and this one's `process_id`.
    The backend is NCCL for CUDA tensors and gloo for the CPU unless named."""
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
        return
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("outside torchrun, give the coordinator address, num_processes and process_id")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}", world_size=num_processes,
                            rank=process_id)


def global_dp_group():
    """The group over every rank of every host, in rank order."""
    return dist.group.WORLD


def free_port() -> int:
    """A free TCP port on localhost for a single-host rendezvous."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(script: str, fn: str, argv: list, world: int) -> None:
    """Start `world` ranks on this host with torch.multiprocessing (start
    method spawn): rank r calls `fn(argv, r, world, "localhost:<port>")` of
    the Python file `script`, which joins the group with initialize(). A rank
    that fails fails the call."""
    import torch.multiprocessing as mp

    mp.start_processes(_spawned, args=(script, fn, argv, world, f"localhost:{free_port()}"), nprocs=world,
                       join=True, start_method="spawn")


def _spawned(rank: int, script: str, fn: str, argv: list, world: int, coordinator: str) -> None:
    import importlib.util

    spec = importlib.util.spec_from_file_location("_dp_rank_entry", script)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    getattr(mod, fn)(argv, rank, world, coordinator)


def _worker(coordinator: str, num_processes: int, process_id: int, device: str) -> None:
    """One process: the tiny scene of the JAX worker (multihost.py:69), its
    camera k of N on a ring, one data-parallel step with the gradients
    averaged across the processes, and the OK line."""
    from materialrefgs_torch import resolve_device
    from materialrefgs_torch.cameras import look_at_camera
    from materialrefgs_torch.config import OptimizationParams, PipelineParams
    from materialrefgs_torch.models import gaussian_model as gm
    from materialrefgs_torch.ops.rasterize.api import RasterizeConfig
    from materialrefgs_torch.parallel.data_parallel import make_dp_train_step
    from materialrefgs_torch.train.trainer import init_train_state

    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", process_id % torch.cuda.device_count())))
        torch.cuda.set_device(dev)
    initialize(coordinator, num_processes, process_id, device=dev)
    rng = np.random.default_rng(0)  # the same scene on every process
    W = H = 32
    pts = rng.normal(size=(64, 3)).astype(np.float32)
    cols = rng.uniform(size=(64, 3)).astype(np.float32)
    model = gm.create_from_points(pts, cols, capacity=128, device=dev)
    opt = OptimizationParams()
    state = init_train_state(model, envmap_res=32)
    ang = 2 * np.pi * process_id / num_processes
    eye = np.array([3.0 * np.sin(ang), 0.4, -3.0 * np.cos(ang)])
    cam = look_at_camera(eye, np.zeros(3), np.array([0.0, 1.0, 0.0]), 0.9, 0.9, W, H, device=dev)
    gt = np.random.default_rng(100 + process_id).uniform(size=(1, H, W, 3)).astype(np.float32)[0]
    step = make_dp_train_step(global_dp_group(), opt, PipelineParams(), spatial_lr_scale=3.0,
                              raster_cfg=RasterizeConfig(pair_capacity=1 << 10), envmap_n_samples=4)
    metrics = step(state, cam, torch.as_tensor(gt, device=dev), 1.0)
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise FloatingPointError("non-finite loss across processes")
    # The averaged gradients leave every process with the same parameters;
    # the test compares this digest across them.
    digest = float(torch.sum(torch.abs(state.model.xyz)))
    print(f"MULTIHOST OK p{process_id}/{num_processes} loss={loss:.6f} digest={digest:.6f}", flush=True)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--coordinator", default="localhost:12421")
    ap.add_argument("--num_processes", type=int, required=True)
    ap.add_argument("--process_id", type=int, required=True)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    a = ap.parse_args()
    _worker(a.coordinator, a.num_processes, a.process_id, a.device)
