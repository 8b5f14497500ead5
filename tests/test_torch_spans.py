"""The port's spans and counters (utils/logging_utils.py): without a profiler
they record nothing and hook no autograd node; under torch.profiler (CPU)
one `surfel` Trainer step with the warp names every phase of the step,
forward and backward, nested as the code nests them, and computes bit for
bit what an unprofiled step computes; the nearest render's forced overflow
records one `trainer.redo`; a served view over tight tracer budgets records
its `tracer.refit` beside the serve loop's spans. Port only, at 32x32 and
64x64 on the CPU."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from materialrefgs_torch import config as tcfg  # noqa: E402
from materialrefgs_torch import evaluate  # noqa: E402
from materialrefgs_torch.cameras import look_at_camera  # noqa: E402
from materialrefgs_torch.models import convert  # noqa: E402
from materialrefgs_torch.models import gaussian_model as tgm  # noqa: E402
from materialrefgs_torch.models.env_light import EnvLightMips  # noqa: E402
from materialrefgs_torch.ops import mesh_tracer as tmt  # noqa: E402
from materialrefgs_torch.ops.rasterize import api as tapi  # noqa: E402
from materialrefgs_torch.ops.rasterize.api import RasterizeConfig  # noqa: E402
from materialrefgs_torch.ops.tracer.api import TracerConfig  # noqa: E402
from materialrefgs_torch.render.renderers import RenderOptions  # noqa: E402
from materialrefgs_torch.train import trainer as ttr  # noqa: E402
from materialrefgs_torch.utils import logging_utils  # noqa: E402

UP = np.array([0.0, 1.0, 0.0])
# The forward spans of a `surfel` step with the warp, each with the span it
# sits in.
STEP_SPANS = {
    "trainer.upkeep": "Trainer.train",
    "trainer.pick": "Trainer.train",
    "TrainStep.render": "Trainer.train",
    "envlight.mips": "TrainStep.render",
    "rasterize": "TrainStep.render",
    "rasterize.preprocess": "rasterize",
    "rasterize.sort": "rasterize",
    "rasterize.tiles": "rasterize",
    "shading": "TrainStep.render",
    "warp.nearest_render": "TrainStep.render",
    "TrainStep.update": "Trainer.train",
    "losses": "TrainStep.update",
    "warp.calc_warp_loss": "TrainStep.update",
    "update.backward": "TrainStep.update",
    "update.adam": "TrainStep.update",
    "trainer.log": "Trainer.train",
}


def _camera(eye, size):
    return look_at_camera(np.asarray(eye, np.float64), np.zeros(3), UP, 0.9, 0.9, size, size, device="cpu")


def _scene(n_cams=2, size=32, P=64, seed=0):
    """Cameras on a ring and the renders of random gaussians from them."""
    rng = np.random.default_rng(seed)
    args = [rng.normal(size=(P, 3)) * 0.5, np.exp(rng.normal(size=(P, 2)) * 0.3 - 1.3), rng.normal(size=(P, 4)),
            rng.uniform(0.5, 0.95, size=(P,)), rng.uniform(size=(P, 3)), np.zeros((P, 1))]
    args = [torch.tensor(a, dtype=torch.float32) for a in args]
    cams, images = [], []
    for i in range(n_cams):
        ang = 0.3 * i
        cam = _camera([3.5 * np.sin(ang), 0.5, -3.5 * np.cos(ang)], size)
        with torch.no_grad():
            images.append(tapi.rasterize(*args, cam, torch.zeros(3), config=RasterizeConfig(1 << 13))["render"].numpy())
        cams.append(cam)
    return cams, images, args[0].numpy(), rng


def _surfel_opt():
    return dataclasses.replace(
        tcfg.OptimizationParams(), use_perceptual_loss=False, initial=1, init_until_iter=0,
        volume_render_until_iter=0, indirect_from_iter=100, multi_view_weight_from_iter=0,
        densify_from_iter=10**9, feature_rest_from_iter=100_000)


def _trainer(pair_capacity=1 << 13, cams=None, size=32):
    """A `surfel` Trainer past the warp gate: every step warps onto the
    other view."""
    scene_cams, images, gt_means, rng = _scene(size=size)
    cams = cams or scene_cams
    model = tgm.create_from_points(gt_means.astype(np.float32), rng.uniform(size=(64, 3)).astype(np.float32),
                                   capacity=128, device="cpu")
    tr = ttr.Trainer(model, cams, images, _surfel_opt(), tcfg.PipelineParams(),
                     raster_cfg=RasterizeConfig(pair_capacity=pair_capacity), envmap_res=16,
                     nearest_ids=[[1], [0]], with_warp=True)
    tr._pick_view = lambda: 0
    return tr


def _events(prof) -> list:
    """(name, start ns, end ns, thread) of every host event of the trace."""
    cpu = torch.autograd.DeviceType.CPU
    return [(e.name(), e.start_ns(), e.end_ns(), e.start_thread_id())
            for e in prof.profiler.kineto_results.events() if e.device_type() == cpu]


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _events(prof)


def _inside(events, inner: str, outer: str) -> bool:
    """Every `inner` interval lies inside an `outer` interval of its thread."""
    outs = [e for e in events if e[0] == outer]
    ins = [e for e in events if e[0] == inner]
    return bool(ins) and all(any(o[3] == i[3] and o[1] <= i[1] and i[2] <= o[2] for o in outs) for i in ins)


def test_no_profiler_records_nothing_and_hooks_nothing(monkeypatch):
    """Without a profiler no span, counter or backward twin records an event
    and no autograd node is hooked, though the step goes through every
    span, the backward's hand-over and a redo."""
    def no_event(name, *args):
        raise AssertionError(f"event {name!r} recorded without a profiler")

    hooked = []
    monkeypatch.setattr(logging_utils, "record_function", no_event)
    monkeypatch.setattr(logging_utils, "_hook_node", lambda node, hooks: hooked.append(node))
    assert not torch.autograd._profiler_enabled()
    ranges = list(logging_utils._THREAD.ranges)
    tr = _trainer()
    tr.train(1, log_every=1)
    logging_utils.count("trainer.redo")
    with logging_utils.span("outer"):
        x = torch.ones(3, requires_grad=True)
        y = (x * 2).sum()
    logging_utils.backward_spans(y)
    y.backward()
    assert hooked == [] and logging_utils._THREAD.ranges == ranges
    assert np.isfinite(tr.metrics_log[0]["loss"]) and tr.metrics_log[0]["warp_on"] == 1


def test_profiled_surfel_warp_step_names_every_phase():
    """Under torch.profiler one `surfel` step with the warp shows every span
    of the step, nested as listed, and the backward twins: the warp's, the
    rasterizer's (with its tile kernels' inside) and the losses' sit inside
    the backward, each inside the twins of the spans that created its
    nodes."""
    tr = _trainer()
    _, ev = _profiled(lambda: tr.train(1, log_every=1))
    names = {e[0] for e in ev}
    for inner, outer in STEP_SPANS.items():
        assert _inside(ev, inner, outer), (inner, outer)
    assert sum(e[0] == "rasterize" for e in ev) == 2
    assert any(r[1] >= w[1] and r[2] <= w[2] for r in ev if r[0] == "rasterize"
               for w in ev if w[0] == "warp.nearest_render")
    assert _inside(ev, "Trainer.train", "Trainer.train") and sum(e[0] == "Trainer.train" for e in ev) == 1
    for twin in ("warp.nearest_render.bwd", "warp.calc_warp_loss.bwd", "rasterize.bwd", "losses.bwd",
                 "shading.bwd", "envlight.mips.bwd", "rasterize.tiles.bwd"):
        assert twin in names, twin
        assert _inside(ev, twin, "update.backward"), twin
    assert _inside(ev, "rasterize.tiles.bwd", "rasterize.bwd")
    assert _inside(ev, "rasterize.bwd", "TrainStep.render.bwd")
    assert _inside(ev, "TrainStep.render.bwd", "Trainer.train.bwd")
    assert _inside(ev, "losses.bwd", "TrainStep.update.bwd")
    assert _inside(ev, "warp.calc_warp_loss.bwd", "TrainStep.update.bwd")
    # The nearest view's rasterizer backward counts under both twins.
    assert any(r[1] >= w[1] and r[2] <= w[2] for r in ev if r[0] == "rasterize.bwd"
               for w in ev if w[0] == "warp.nearest_render.bwd")
    # No autograd node of the forward outside every span: no twin without a
    # forward span of its name.
    assert {n[:-4] for n in names if n.endswith(".bwd")} <= names
    assert "trainer.redo" not in names and tr.metrics_log[0]["renders_redone"] == 0


def test_profiled_step_is_bit_identical():
    """The same step from the same state, profiled and not: the loss, every
    gradient, the parameters, both Adam moments and the densification
    statistics are bit for bit equal."""
    real_grad = torch.autograd.grad

    def run(profiled):
        tr = _trainer()
        grads = []

        def grad(*args, **kwargs):
            out = real_grad(*args, **kwargs)
            grads.append([None if g is None else g.clone() for g in out])
            return out

        torch.autograd.grad = grad
        try:
            if profiled:
                _profiled(lambda: tr.train(2, log_every=1))
            else:
                tr.train(2, log_every=1)
        finally:
            torch.autograd.grad = real_grad
        st = tr.state
        return tr.metrics_log, grads, st

    log_a, grads_a, a = run(False)
    log_b, grads_b, b = run(True)
    assert [m["loss"] for m in log_a] == [m["loss"] for m in log_b]
    assert len(grads_a) == len(grads_b) == 2
    for ga, gb in zip(grads_a, grads_b):
        for x, y in zip(ga, gb):
            assert (x is None) == (y is None) and (x is None or torch.equal(x, y))
    for k in a.params():
        assert torch.equal(a.params()[k], b.params()[k]), k
        assert torch.equal(a.adam.mu[k], b.adam.mu[k]) and torch.equal(a.adam.nu[k], b.adam.nu[k]), k
    assert a.adam.count == b.adam.count == 2
    for k in ("xyz_gradient_accum", "denom", "max_radii2d"):
        assert torch.equal(getattr(a.model, k), getattr(b.model, k)), k


def test_forced_overflow_records_one_redo():
    """The nearest render's overflow of tests/test_torch_train_warp.py (the
    view fits the pair capacity, its nearest view does not): the step is
    redone once, and the trace holds exactly one `trainer.redo`, inside the
    step, between the two renders."""
    cams, _, _, _ = _scene(size=64)
    cams = [_camera([0.0, 0.5, -9.0], 64), cams[1]]  # far: fewer pairs than its nearest view
    tr = _trainer(cams=cams, size=64)
    model = tr.state.model
    needs = []
    for cam in cams:
        out = tapi.rasterize(model.xyz, model.get_scaling, model.get_rotation, model.get_opacity[:, 0],
                             model.get_colors(cam.camera_center), torch.zeros((model.capacity, 9)), cam,
                             torch.zeros(3), config=RasterizeConfig(pair_capacity=1 << 7))
        needs.append((1 << 7) + int(out["overflow"]))
    cap = -(-needs[0] // 128) * 128
    assert needs[1] > cap, needs
    tr.raster_cfg = RasterizeConfig(pair_capacity=cap)
    _, ev = _profiled(lambda: tr.train(1, log_every=1))
    redos = [e for e in ev if e[0] == "trainer.redo"]
    assert len(redos) == 1 and tr.metrics_log[0]["renders_redone"] == 1
    renders = sorted(e[1] for e in ev if e[0] == "TrainStep.render")
    assert len(renders) == 2 and renders[0] < redos[0][1] < renders[1]
    assert _inside(ev, "trainer.redo", "Trainer.train")


def _leaves(rng, P, spread, scale_mu):
    leaves = {name: np.zeros((P,) + shape(16), np.float32) for name, shape in tgm.PARAM_SHAPES.items()}
    leaves["xyz"][:] = rng.normal(size=(P, 3)) * spread
    leaves["scaling"][:] = rng.normal(size=(P, 2)) * 0.3 + scale_mu
    leaves["rotation"][:] = rng.normal(size=(P, 4))
    leaves["opacity"][:] = rng.normal(size=(P, 1)) + 1.0
    for name in ("refl_strength", "roughness", "ori_color", "metalness", "diffuse_color"):
        leaves[name][:] = rng.normal(size=leaves[name].shape)
    for name in ("features_dc", "indirect_dc"):
        leaves[name][:] = rng.normal(size=(P, 1, 3)) * 0.8
    for name in ("features_rest", "indirect_rest"):
        leaves[name][:] = rng.normal(size=(P, 15, 3)) * 0.2
    return leaves


def _sphere(n_lat=10, n_lon=20, radius=0.55):
    th, ph = np.meshgrid(np.linspace(0.0, np.pi, n_lat + 1), np.linspace(0.0, 2 * np.pi, n_lon, endpoint=False),
                         indexing="ij")
    v = np.stack([np.sin(th) * np.cos(ph), np.cos(th), np.sin(th) * np.sin(ph)], -1).reshape(-1, 3) * radius
    idx = np.arange((n_lat + 1) * n_lon).reshape(n_lat + 1, n_lon)
    a, b, c, d = idx[:-1], np.roll(idx[:-1], -1, axis=1), idx[1:], np.roll(idx[1:], -1, axis=1)
    faces = np.concatenate([np.stack([a, c, b], -1), np.stack([b, c, d], -1)]).reshape(-1, 3)
    return v.astype(np.float32), faces.astype(np.int32)


def test_tight_budget_served_view_records_its_refit(tmp_path):
    """evaluate.render_set over tracer budgets far below the view's demand:
    every redo's refit records one `tracer.refit`, and the serve loop's
    spans hold render_surfel2's rasterizer, shading, mesh tracer and tracer
    spans."""
    rng = np.random.default_rng(2)
    main, env = (convert.gaussian_model_from_numpy(_leaves(rng, 64, s, mu), np.ones(64, bool), 3, device="cpu")
                 for s, mu in ((0.45, -1.6), (1.8, -0.9)))
    mips = EnvLightMips.build(convert.env_light_from_numpy(rng.normal(size=(6, 16, 16, 3)).astype(np.float32),
                                                           device="cpu"), min_res=8, n_samples=4)
    cam = _camera([0.3, -0.4, -3.0], 32)
    gt = rng.uniform(size=(32, 32, 3)).astype(np.float32)
    mesh = tmt.build_mesh(*_sphere(), device="cpu")
    cfg = TracerConfig(pair_capacity=256, cluster_pair_capacity=1, exact_order=True, mesh_cull_cap=512)
    metrics, ev = _profiled(lambda: evaluate.render_set(
        str(tmp_path), "test", [cam], [gt], main, mips, env, opts=RenderOptions(raster=RasterizeConfig(1 << 12)),
        tracer_cfg=cfg, bg_color=(1.0, 1.0, 1.0), mesh=mesh))
    refits = [e for e in ev if e[0] == "tracer.refit"]
    assert metrics["tracer_redos"] >= 1 and len(refits) == metrics["tracer_redos"]
    assert _inside(ev, "tracer.refit", "serve.view")
    for inner, outer in (("rasterize", "serve.view"), ("shading", "serve.view"),
                         ("mesh_tracer.trace", "serve.view"), ("tracer.trace", "serve.view"),
                         ("tracer.cull", "tracer.trace"), ("tracer.segments", "tracer.trace"),
                         ("rasterize.tiles", "rasterize"), ("mesh_tracer.cull", "mesh_tracer.trace"),
                         ("mesh_tracer.select", "mesh_tracer.trace"), ("mesh_tracer.hit", "mesh_tracer.trace"),
                         ("mesh_tracer.nearest", "mesh_tracer.hit"), ("mesh_tracer.output", "mesh_tracer.trace")):
        assert _inside(ev, inner, outer), (inner, outer)
    for name in ("serve.metrics", "serve.png"):
        assert any(e[0] == name for e in ev), name
    assert not any(e[0].endswith(".bwd") for e in ev)
