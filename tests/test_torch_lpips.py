"""The port's LPIPS (train/lpips.py) against the JAX package's, with random
weights in the documented .npz format (no pretrained VGG16 exists offline):
the distance and its gradient with respect to the rendered image at an odd
size, where the floor pooling shows, the weight file's checks, the
Trainer's loud degradation without weights, and the eval metric."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from materialrefgs_tpu.train import lpips as jlp  # noqa: E402

from materialrefgs_torch import config as tcfg  # noqa: E402
from materialrefgs_torch.models import gaussian_model as tgm  # noqa: E402
from materialrefgs_torch.train import lpips as tlp  # noqa: E402
from materialrefgs_torch.train import trainer as ttr  # noqa: E402
from test_lpips import make_fake_weights  # noqa: E402

H, W = 37, 53


def _images(seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=(H, W, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(size=a.shape).astype(np.float32) * 0.2, 0, 1).astype(np.float32)
    return a, b


@pytest.fixture
def weights(tmp_path):
    return make_fake_weights(str(tmp_path / "w.npz"), np.random.default_rng(11))


def test_lpips_and_its_gradient_match_jax(weights):
    """The distance within rtol 1e-5; d distance / d rendered image within
    the step-parity gradient tolerance (2e-3 x its scale + 1e-4 x its scale,
    tests/test_torch_train_surfel2.py), per pixel."""
    a, b = _images(0)
    jw = jlp.load_weights(weights)
    jval, jgrad = jax.value_and_grad(lambda x: jlp.lpips(x, jnp.asarray(b), jw))(jnp.asarray(a))
    net = tlp.LPIPS(weights, device="cpu")
    x = torch.from_numpy(a).requires_grad_(True)
    val = net(x, torch.from_numpy(b))
    (grad,) = torch.autograd.grad(val, x)
    np.testing.assert_allclose(float(val), float(jval), rtol=1e-5)
    gj = np.asarray(jgrad)
    scale = float(np.abs(gj).max())
    assert scale > 0
    np.testing.assert_allclose(grad.numpy(), gj, atol=2e-3 * scale + 1e-4 * scale)
    assert abs(float(net(x, x))) < 1e-6


def test_weight_file_checks(tmp_path, weights):
    with pytest.raises(tlp.LpipsWeightsMissing):
        tlp.load_weights(str(tmp_path / "nope.npz"))
    raw = dict(np.load(weights))
    raw["conv3_w"] = raw["conv3_w"][..., :7]
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, **raw)
    for load in (jlp.load_weights, tlp.load_weights):
        with pytest.raises(ValueError, match="conv3"):
            load(bad)
    w = tlp.load_weights(weights)
    assert w["conv0_w"].shape == (64, 3, 3, 3) and w["lin4"].shape == (512,)  # OIHW


def test_trainer_degrades_loudly_without_weights(monkeypatch, tmp_path, capsys, weights):
    """As tests/test_lpips.py::test_trainer_degrades_loudly_without_weights
    holds the JAX Trainer: with use_perceptual_loss and no weight file the
    run starts, the banner says the loss is off, use_perceptual_loss turns
    False and lpips_disabled records it; with weights they reach the
    deferred stages' steps."""
    rng = np.random.default_rng(3407)
    model = tgm.create_from_points(rng.normal(size=(64, 3)).astype(np.float32),
                                   rng.uniform(size=(64, 3)).astype(np.float32), capacity=128, device="cpu")
    from materialrefgs_torch.cameras import look_at_camera

    cams = [look_at_camera(np.array([0.0, 0.5, -3.5]), np.zeros(3), np.array([0.0, 1.0, 0.0]), 0.9, 0.9, 32, 32,
                           device="cpu")]
    images = [np.zeros((32, 32, 3), np.float32)]
    opt = dataclasses.replace(tcfg.OptimizationParams(), use_perceptual_loss=True)
    monkeypatch.setenv(tlp.DEFAULT_WEIGHTS_ENV, str(tmp_path / "absent.npz"))
    tr = ttr.Trainer(model, cams, images, opt, tcfg.PipelineParams(), cameras_extent=3.0, envmap_res=16)
    out = capsys.readouterr().out
    assert "PERCEPTUAL (LPIPS) LOSS DISABLED" in out and "absent.npz" in out
    assert tr.lpips_weights is None and tr.lpips_disabled
    assert tr.opt.use_perceptual_loss is False
    monkeypatch.setenv(tlp.DEFAULT_WEIGHTS_ENV, weights)
    tr = ttr.Trainer(model, cams, images, opt, tcfg.PipelineParams(), cameras_extent=3.0, envmap_res=16)
    assert not tr.lpips_disabled and tr.opt.use_perceptual_loss
    assert tr._step_fn("surfel").lpips_weights is tr.lpips_weights
    assert tr._step_fn("initial").lpips_weights is None


def test_perceptual_term_in_calculate_loss_matches_jax(weights):
    """losses.calculate_loss adds lambda_perceptual_loss x LPIPS past
    perceptual_loss_start_iter, as the JAX package's does; before the gate
    the port skips the term (JAX multiplies it by 0)."""
    from materialrefgs_tpu.config import OptimizationParams as JOpt
    from materialrefgs_tpu.train import losses as jloss

    from materialrefgs_torch.train import losses as tloss

    a, b = _images(1)
    rng = np.random.default_rng(2)
    maps = {"render": a, "rend_normal": rng.normal(size=(H, W, 3)).astype(np.float32),
            "surf_normal": rng.normal(size=(H, W, 3)).astype(np.float32),
            "rend_dist": rng.uniform(size=(H, W, 1)).astype(np.float32),
            "surf_depth": rng.uniform(1, 2, size=(H, W)).astype(np.float32)}
    opt = dataclasses.replace(JOpt(), use_perceptual_loss=True, lambda_dist=1000.0)
    topt = tcfg.OptimizationParams(**dataclasses.asdict(opt))
    jw, tw = jlp.load_weights(weights), tlp.load_weights(weights)
    for it, on in ((opt.perceptual_loss_start_iter + 1, True), (opt.perceptual_loss_start_iter, False)):
        jl, jtb = jloss.calculate_loss(jnp.asarray(b), {k: jnp.asarray(v) for k, v in maps.items()}, opt,
                                       jnp.float32(it), lpips_weights=jw)
        tl, ttb = tloss.calculate_loss(torch.from_numpy(b), {k: torch.from_numpy(v) for k, v in maps.items()},
                                       topt, it, lpips_weights=tw)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        assert ("perceptual_loss" in ttb) == on
        if on:
            np.testing.assert_allclose(float(ttb["perceptual_loss"]), float(jtb["perceptual_loss"]), rtol=1e-5)
