"""What the rasterizer's autograd Function keeps from its forward to its
backward (materialrefgs_torch/ops/rasterize/api.py `_RenderPairs`): the
per-gaussian table and the binning, not the pair payload gathered from the
table, whose B columns span the whole pair budget (2 GiB at a 16M-pair
budget, mostly unused). The backward gathers the payload again; its
gradients equal the ones of a render whose backward is given the
forward's payload. CPU, no JAX."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from materialrefgs_torch.cameras import look_at_camera  # noqa: E402
from materialrefgs_torch.ops.rasterize import api  # noqa: E402
from materialrefgs_torch.ops.rasterize.layout import payload_channels_padded  # noqa: E402

CAPACITY = 1 << 14
W, H = 48, 32


def _scene(seed, P=300, S=3):
    rng = np.random.default_rng(seed)
    arrays = (
        rng.normal(size=(P, 3)) * 0.6,
        np.exp(rng.normal(size=(P, 2)) * 0.5 - 1.6),
        rng.normal(size=(P, 4)),
        rng.uniform(0.2, 0.95, size=(P,)),
        rng.uniform(size=(P, 3)),
        rng.uniform(size=(P, S)),
    )
    return [torch.tensor(a, dtype=torch.float32, requires_grad=True) for a in arrays]


def _camera():
    return look_at_camera(np.array([0.0, 0.0, -4.0]), np.zeros(3), np.array([0.0, 1.0, 0.0]), 0.9, 0.7, W, H,
                          device="cpu")


def _loss(out):
    return sum(torch.sum(torch.sin(out[k])) for k in ("render", "feature", "depth", "alpha", "distortion"))


@pytest.mark.parametrize("S", [1, 3])
def test_render_keeps_no_pair_payload(S):
    """No tensor saved for the backward is as large as the (C_PAD, B) pair
    payload."""
    leaves = _scene(1, S=S)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t.numel()) or t, lambda t: t):
        out = api.rasterize(*leaves, _camera(), torch.zeros(3), config=api.RasterizeConfig(pair_capacity=CAPACITY))
    assert int(out["overflow"]) == 0
    assert saved and max(saved) < payload_channels_padded(S) * CAPACITY
    grads = torch.autograd.grad(_loss(out), leaves, allow_unused=True)
    assert all(g is not None and torch.isfinite(g).all() for g in grads[:4])


def test_regathered_payload_gives_the_same_gradients(monkeypatch):
    """The backward's gather reproduces the forward's payload: gradients
    equal, bit for bit, those of a backward that is handed the forward's
    own payload."""
    leaves = _scene(2)
    cfg = api.RasterizeConfig(pair_capacity=CAPACITY)
    out = api.rasterize(*leaves, _camera(), torch.zeros(3), config=cfg)
    grads = torch.autograd.grad(_loss(out), leaves, allow_unused=True)

    gathered = []
    real = api._gather_pairs

    def remember(payload_g, g_sorted):
        if not gathered:
            gathered.append(real(payload_g, g_sorted))
            return gathered[0]
        return gathered[0]  # the backward: the forward's payload itself

    monkeypatch.setattr(api, "_gather_pairs", remember)
    out2 = api.rasterize(*leaves, _camera(), torch.zeros(3), config=cfg)
    grads2 = torch.autograd.grad(_loss(out2), leaves, allow_unused=True)
    assert len(gathered) == 1
    for a, b in zip(grads, grads2):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)
