"""One run of one cell: set-up, the measured window, the comparison with the
plain reference that decides `correct`, and (traced runs) the per-layer
metrics. `run_train` drives the Trainer, `run_serve` the per-view serve
loop; the traffic file's `kind` picks one."""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from perfbench import cost as costmod
from perfbench.core import compare, scene as scenemod, trace as tracemod
from perfbench.core.system import PROGRAM, REFERENCE, Side, to_uint8, with_tf32

GIB = float(1 << 30)


class Run:
    """The state of one run that the steps below share."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool, device, t_start: float,
                 overrides: dict | None = None):
        self.cell, self.seed, self.seconds, self.trace = cell, int(seed), float(seconds), bool(trace)
        self.device = torch.device(device)
        self.t_start = t_start
        self.cfg = _merge(cell.config, (overrides or {}).get("config", {}))
        self.traffic = _merge(cell.traffic, (overrides or {}).get("traffic", {}))
        self.metrics: dict = {}
        self.checks: list = []  # (name, value, limit)
        self.attempted = 0
        self.failed = 0
        self.breakdown = None
        self.busy_s = None
        self.window_s = None
        self.peak_bytes = 0
        self.phases: dict = {}  # seconds of each part of the run (printed on standard error)

    def mark(self, name: str, t0: float) -> float:
        now = time.perf_counter()
        self.phases[name] = now - t0
        return now

    def window_len(self) -> float:
        """The measured window: --seconds, or at most TRACE_WINDOW_S when traced."""
        return min(self.seconds, tracemod.TRACE_WINDOW_S) if self.trace else self.seconds

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def reset_peak(self):
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

    def read_peak(self) -> int:
        return int(torch.cuda.max_memory_allocated(self.device)) if self.device.type == "cuda" else 0

    def scene(self):
        return scenemod.make_scene(self.cfg, self.traffic, self.seed, self.device)

    def free(self):
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(out.get(k, {}), v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


# ---------------------------------------------------------------- train ----
def _leaves(tr) -> dict:
    st = tr.state
    out = dict(st.params())
    if st.env_gs is not None:
        out.update({f"env_gs.{k}": v for k, v in st.env_params().items()})
    return out


def _first_grad_norms(tr) -> dict:
    """Each leaf's gradient norm as Adam got it at its first step: its first
    moment after one step is (1 - b1) g."""
    st = tr.state
    out = {k: float(torch.linalg.vector_norm(m)) / (1 - st.adam.b1) for k, m in st.adam.mu.items()}
    if st.env_adam is not None:
        out.update({f"env_gs.{k}": float(torch.linalg.vector_norm(m)) / (1 - st.env_adam.b1)
                    for k, m in st.env_adam.mu.items()})
    return out


def drive_steps(tr, start: int, n: int) -> dict:
    """The first `n` steps through the window's own call (Trainer.train, one
    iteration a call), with each step's loss, the first gradient's norm per
    leaf and the norm of each leaf's change over the n steps."""
    p0 = {k: v.detach().clone() for k, v in _leaves(tr).items()}
    losses, views, grads = [], [], None
    for i in range(n):
        tr.train(1, start_iter=start + i)
        losses.append(float(tr.metrics_log[-1]["loss"]))
        views.append(int(tr._last_cam_id))
        if i == 0:
            grads = _first_grad_norms(tr)
    change = {k: float(torch.linalg.vector_norm(v.detach() - p0[k])) for k, v in _leaves(tr).items()}
    return {"loss": losses, "grad": grads, "change": change, "views": views}


def train_readings(run: Run, package: str, tf32: bool = False) -> dict:
    """The compared readings of `package`'s Trainer from the seed's inputs."""
    side = Side(package)
    with with_tf32(tf32):
        tr = side.trainer_for(run.cfg, run.traffic, run.scene(), run.seed, run.device)
        out = drive_steps(tr, int(run.traffic["start_iteration"]), int(run.traffic["compared_steps"]))
    del tr
    run.free()
    return out


def run_train(run: Run) -> None:
    prog = Side(PROGRAM)
    tr = prog.trainer_for(run.cfg, run.traffic, run.scene(), run.seed, run.device)
    start = int(run.traffic["start_iteration"])
    n_cmp = int(run.traffic["compared_steps"])
    mine = drive_steps(tr, start, n_cmp)
    run.sync()
    setup_s = time.perf_counter() - run.t_start
    run.phases["setup"] = setup_s
    it = start + n_cmp

    snap, views = None, []
    spans = tracemod.Spans()
    prof = None
    if run.trace:
        snap = {k: v.detach().cpu() for k, v in _leaves(tr).items()}
        snap["alive"] = tr.state.model.alive.cpu()
        spans.install(run.cell.spans())
        prof = _profiler(run)
        prof.__enter__()
    run.reset_peak()
    t0 = time.perf_counter()
    steps = 0
    with torch.profiler.record_function(tracemod.WINDOW):
        while True:
            tr.train(1, start_iter=it)
            views.append(int(tr._last_cam_id))
            it += 1
            steps += 1
            if time.perf_counter() - t0 >= run.window_len():
                break
        run.sync()
    window = time.perf_counter() - t0
    run.peak_bytes = run.read_peak()
    if prof is not None:
        prof.__exit__(None, None, None)
        spans.uninstall()
    run.attempted = steps
    iters_done = it
    t = run.mark("window", t0)
    del tr
    run.free()

    if not run.trace:
        run.metrics["train_step_s"] = (window / steps, "s/step")
        run.metrics["peak_mem_gib"] = (run.peak_bytes / GIB, "GiB")
        run.metrics["setup_s"] = (setup_s, "s")

    ref = train_readings(run, REFERENCE)
    run.checks = compare.train_checks(mine, ref, run.cell.limits)
    t = run.mark("reference", t)

    if run.trace:
        cost = train_cost(run, snap, views, iters_done)
        t = run.mark("cost", t)
        view = tracemod.TraceView(prof, steps, {"steps": steps}, cost)
        _read_layers(run, view)
        run.mark("trace", t)


def train_cost(run: Run, snap: dict, views: list, it: int) -> dict:
    """Work per step, counted by the reference's plain forward at the
    window's start state on `cost_views` of the window's views (drawn from
    the seed)."""
    side = Side(REFERENCE)
    scene = run.scene()
    tr = side.trainer_for(run.cfg, run.traffic, scene, run.seed, run.device)
    with torch.no_grad():
        for k, v in _leaves(tr).items():
            v.copy_(snap[k].to(run.device))
        tr.state.model.alive.copy_(snap["alive"].to(run.device))
    rng = np.random.default_rng(run.seed)
    ids = rng.choice(len(views), size=min(int(run.traffic["cost_views"]), len(views)), replace=False)
    stage = side.trainer.select_stage(it, tr.opt)
    per_unit = []
    for i in ids:
        cam_id = views[int(i)]
        extra, warp_on, _ = tr._view_extra(it, stage, cam_id)
        mesh = tr.mesh if stage == "surfel2" else None
        with _work(side) as work, torch.no_grad():
            pkg, _ = tr._step_fn(stage, warp_on).render(tr.state, tr.cameras[cam_id], extra, mesh)
        per_unit.append(_unit_cost(tr.state.model, tr.state.env_gs, scene.train[cam_id], work, backward=True,
                                   alpha=pkg["rend_alpha"], stage=stage))
        del pkg
    del tr
    run.free()
    return _mean_cost(per_unit)


class _work:
    """Turns on the reference's per-launch work records."""

    def __init__(self, side):
        import importlib

        self.mods = [importlib.import_module(f"{side.package}.ops.rasterize.tiles_fwd"),
                     importlib.import_module(f"{side.package}.ops.tracer.trace_fwd")]

    def __enter__(self):
        self.rec = {"raster": {}, "trace": {}}
        self.mods[0].WORK, self.mods[1].WORK = self.rec["raster"], self.rec["trace"]
        return self.rec

    def __exit__(self, *exc):
        for m in self.mods:
            m.WORK = None


def _unit_cost(model, env_model, spec, work: dict, backward: bool, alpha: torch.Tensor, stage: str) -> dict:
    """Operations and bounds of one step or view from its launch records;
    the gaussians a launch reads are those whose centre the view `spec`
    sees (a warp's nearest view sees about as many). The stage's shading is
    counted where it is done: per pixel in the deferred stages, per alive
    gaussian in `volume`, nowhere in `initial` (its colours are SH)."""
    c = {"raster_fwd_s": 0.0, "raster_bwd_s": 0.0, "trace_fwd_s": 0.0, "trace_bwd_s": 0.0, "flops": 0.0}
    fx, fy, cx, cy = costmod.intrinsics(spec)
    n_in_view = costmod.gaussians_in_view(model.xyz.detach(), model.alive, spec.center, spec.R.T, fx, fy, cx, cy,
                                          spec.width, spec.height)
    for rec in work["raster"].get("launches", []):
        lc = costmod.raster_launch(rec["S"], rec["hits3d"], rec["hits2d"], n_in_view, rec["H"], rec["W"])
        c["raster_fwd_s"] += costmod.bound_s(lc["fwd_flops"], lc["fwd_bytes"])
        c["flops"] += lc["fwd_flops"]
        if backward:
            c["raster_bwd_s"] += costmod.bound_s(lc["bwd_flops"], lc["bwd_bytes"])
            c["flops"] += lc["bwd_flops"]
    n_env = int(env_model.alive.sum()) if env_model is not None else 0
    for rec in work["trace"].get("launches", []):
        lc = costmod.trace_launch(rec["n_sh"], rec["contribs"], n_env, rec["NB"] * 256)
        c["trace_fwd_s"] += costmod.bound_s(lc["fwd_flops"], lc["fwd_bytes"])
        c["flops"] += lc["fwd_flops"]
        if backward:
            c["trace_bwd_s"] += costmod.bound_s(lc["bwd_flops"], lc["bwd_bytes"])
            c["flops"] += lc["bwd_flops"]
    pix = int(alpha.shape[0] * alpha.shape[1])
    shaded = {"initial": 0, "volume": int(model.alive.sum())}.get(stage, pix)
    flops = costmod.SHADE_FLOPS_PER_PIXEL * shaded
    if backward:
        flops = (flops + costmod.LOSS_FLOPS_PER_PIXEL * pix) * (1 + costmod.BACKWARD_FACTOR)
    c["flops"] += flops
    return c


def _mean_cost(units: list) -> dict:
    return {k: float(np.mean([u[k] for u in units])) for k in units[0]} if units else {}


# ---------------------------------------------------------------- serve ----
def run_serve(run: Run) -> None:
    prog = Side(PROGRAM)
    scene = run.scene()
    srv = prog.server_for(run.cfg, run.traffic, scene, run.device)
    n_views = len(srv["cameras"])
    for v in range(int(run.traffic["warmup_views"])):
        pkg, _ = prog.serve_view(srv, v)
        to_uint8(pkg["render"]).cpu()
        del pkg
    run.sync()
    setup_s = time.perf_counter() - run.t_start
    run.phases["setup"] = setup_s

    spans = tracemod.Spans()
    prof = None
    if run.trace:
        spans.install(run.cell.spans())
        prof = _profiler(run)
        prof.__enter__()
    served, lat = {}, []
    redos = failed = 0
    run.reset_peak()
    t0 = time.perf_counter()
    v = 0
    with torch.profiler.record_function(tracemod.WINDOW):
        while True:
            t_req = time.perf_counter()
            pkg, r = prog.serve_view(srv, v)
            img = to_uint8(pkg["render"]).cpu()
            lat.append(time.perf_counter() - t_req)
            redos += r
            if int(pkg["overflow"]) or int(pkg.get("tracer_overflow", 0)):
                failed += 1
            del pkg
            served.setdefault(v, img)
            v = (v + 1) % n_views
            if time.perf_counter() - t0 >= run.window_len():
                break
        run.sync()
    window = time.perf_counter() - t0
    run.peak_bytes = run.read_peak()
    if prof is not None:
        prof.__exit__(None, None, None)
        spans.uninstall()
    run.attempted, run.failed = len(lat), failed
    t = run.mark("window", t0)
    del srv
    run.free()

    if not run.trace:
        q = int(run.traffic["tail_percentile"])
        run.metrics["serve_views_per_s"] = (len(lat) / window, "views/s")
        run.metrics[f"serve_p{q}_ms"] = (1e3 * float(np.percentile(lat, q)), "ms")
        run.metrics["peak_mem_gib"] = (run.peak_bytes / GIB, "GiB")
        run.metrics["setup_s"] = (setup_s, "s")

    # The comparison: a sample of the served views drawn from the seed,
    # rendered by the reference (which also counts the work of each).
    rng = np.random.default_rng(run.seed)
    ids = sorted(int(i) for i in rng.choice(sorted(served), size=min(int(run.traffic["compared_views"]),
                                                                      len(served)), replace=False))
    mine = {i: served[i] for i in ids}
    served.clear()
    ref_side = Side(REFERENCE)
    ref_scene = run.scene()
    ref_srv = ref_side.server_for(run.cfg, run.traffic, ref_scene, run.device)
    theirs, per_unit = {}, []
    for i in ids:
        with _work(ref_side) as work, torch.no_grad():
            pkg, _ = ref_side.serve_view(ref_srv, i)
        theirs[i] = to_uint8(pkg["render"]).cpu()
        if len(per_unit) < int(run.traffic["cost_views"]):
            per_unit.append(_unit_cost(ref_srv["model"], ref_srv["env_model"], ref_scene.test[i], work,
                                       backward=False, alpha=pkg["rend_alpha"], stage=ref_srv["stage"]))
        del pkg
    del ref_srv
    run.free()
    run.checks = compare.serve_checks(mine, theirs, run.cell.limits)
    t = run.mark("reference", t)

    if run.trace:
        view = tracemod.TraceView(prof, len(lat), {"views": len(lat), "tracer_redos": redos},
                                  _mean_cost(per_unit))
        _read_layers(run, view)
        run.mark("trace", t)


# ---------------------------------------------------------------- common ---
def _profiler(run: Run):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if run.device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _read_layers(run: Run, view) -> None:
    run.busy_s = view.busy_s()
    run.window_s = view.window_s
    run.breakdown = {"device_ops": view.top_device_ops(10), "idle_gaps": view.idle_gaps(10)}
    for m in run.cell.per_layer:
        value = run.cell.readers[m["name"]].read(view)
        if value is not None:
            run.metrics[m["name"]] = (float(value), m["unit"])


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             overrides: dict | None = None) -> Run:
    run = Run(cell, seed, seconds, trace, device, t_start, overrides)
    kind = run.traffic["kind"]
    if kind == "train":
        run_train(run)
    elif kind == "serve":
        run_serve(run)
    else:
        raise ValueError(f"unknown traffic kind {kind!r}")
    return run

