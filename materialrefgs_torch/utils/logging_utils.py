"""Observability: TensorBoard scalars and images, the psnr.json history,
timers and a profiler trace (the JAX package's utils/logging_utils.py;
reference train_refnerf.py prepare_output_and_logger:1644,
training_report:1676, save_psnr:1759, utils/system_utils.py Timing).
"""
from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager


class TrainLogger:
    """Writes under `log_dir`: psnr.json (the test PSNR history, continued
    across resumes) and, when torch.utils.tensorboard imports (it needs the
    tensorboard package), TensorBoard scalars and images."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        try:
            import importlib.util
            import sys
            import types

            # TensorBoard's event writer needs no TensorFlow: the tensorboard
            # package's "notf" marker makes it use its own stub instead of
            # importing TensorFlow where one is installed (seconds per run).
            if importlib.util.find_spec("tensorboard") and "tensorboard.compat.notf" not in sys.modules:
                sys.modules["tensorboard.compat.notf"] = types.ModuleType("tensorboard.compat.notf")
            from torch.utils.tensorboard import SummaryWriter

            self.tb = SummaryWriter(log_dir)
        except Exception:  # noqa: BLE001 - any import or set-up failure means no TensorBoard
            self.tb = None
        # A resumed run continues the history (reference save_psnr re-reads
        # psnr.json, train_refnerf.py:1759-1770).
        self.psnr_history: list[dict] = []
        p = os.path.join(log_dir, "psnr.json")
        if os.path.exists(p):
            try:
                with open(p) as f:
                    old = json.load(f)
                if isinstance(old, list):
                    self.psnr_history = old
            except (OSError, ValueError):
                pass

    def scalars(self, iteration: int, metrics: dict, prefix: str = "train"):
        if self.tb is None:
            return
        for k, v in metrics.items():
            try:
                self.tb.add_scalar(f"{prefix}/{k}", float(v), iteration)
            except (TypeError, ValueError):
                pass

    def image(self, iteration: int, name: str, img):
        if self.tb is None:
            return
        import numpy as np

        arr = np.clip(np.asarray(img), 0, 1)
        self.tb.add_image(name, arr.transpose(2, 0, 1), iteration)

    def test_psnr(self, iteration: int, psnr: float):
        """Append to psnr.json (train_refnerf.py:1759-1770)."""
        self.psnr_history.append({"iteration": iteration, "psnr": psnr})
        with open(os.path.join(self.log_dir, "psnr.json"), "w") as f:
            json.dump(self.psnr_history, f)
        if self.tb is not None:
            self.tb.add_scalar("test/psnr", psnr, iteration)

    def close(self):
        if self.tb is not None:
            self.tb.close()


@contextmanager
def timing(name: str, sync_fn=None, quiet: bool = False):
    """utils/system_utils.py Timing: prints the block's wall time in ms,
    after sync_fn (e.g. torch.cuda.synchronize) when given."""
    t0 = time.perf_counter()
    yield
    if sync_fn is not None:
        sync_fn()
    if not quiet:
        print(f"[timing] {name}: {(time.perf_counter() - t0) * 1000:.2f} ms")


@contextmanager
def profile_trace(log_dir: str, enabled: bool = True):
    """A torch.profiler trace of the block (CPU and, on the card, CUDA
    activity) written to {log_dir}/trace.json: the counterpart of the JAX
    package's jax_profile_trace."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
