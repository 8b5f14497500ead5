"""perfbench.reference.plain — PyTorch/CUDA port of the reflective 2D Gaussian
Splatting framework, targeting NVIDIA Hopper (sm_90a).

The package mirrors `materialrefgs_tpu`'s module names so each module's
counterpart is easy to find. Each of the JAX package's four Pallas kernels
has a hand-written CUDA C++ counterpart under `csrc/`, built with nvcc at
first use and bound with ctypes: the tile rasterizer's forward and backward
(`ops/rasterize/tiles_fwd.py`, `tiles_bwd.py`) and the bundle tracer's
forward and backward (`ops/tracer/trace_fwd.py`, `trace_bwd.py`). Beside
each runs a plain torch version of the same function, which CPU tensors
take; everything around the kernels is plain torch.

Entry points run on the card unless the caller asks for the CPU explicitly
(`resolve_device("cpu")`, `--device cpu`).
"""
from __future__ import annotations

import torch

__version__ = "0.1.0"

# Graphics math here (projection chains, the SSIM moment convolutions, the
# cubemap diffuse-convolution matmul) cancels badly at TF32's ~3 decimal
# digits. Keep float32 everywhere: matmuls already default to full f32, but
# cuDNN convolutions default to TF32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device a port entry point runs on: the card unless the caller asks
    for the CPU. Raises when the card is asked for (or defaulted to) and none
    is present — there is no silent CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "perfbench.reference.plain runs on a CUDA card by default and none is "
                "available; pass device='cpu' (or --device cpu) to run on the CPU"
            )
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
