"""The port's env-GS serving slice against the JAX package: render_surfel2 at
32x32 with 64-splat main and env clouds, with splat-traced and with
mesh-traced visibility, and eval end to end on an env-GS checkpoint
directory (point_cloud.ply + env_point_cloud.ply + meshes/) through
scripts/eval_torch.py vs scripts/eval.py.

The JAX side runs its Pallas kernels in interpret mode; each JAX render is
computed once per module. Maps are held to the rasterizer's tolerance
(tests/test_rasterize_pallas.py: atol 3e-4, rtol 1e-3) since everything
downstream of the rasterized normals and depth inherits it."""
import dataclasses
import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from materialrefgs_tpu import config as jcfg  # noqa: E402
from materialrefgs_tpu.cameras import look_at_camera as jax_camera  # noqa: E402
from materialrefgs_tpu.models import gaussian_io as jio  # noqa: E402
from materialrefgs_tpu.models import gaussian_model as jgm  # noqa: E402
from materialrefgs_tpu.models.env_light import EnvLightMips as JMips  # noqa: E402
from materialrefgs_tpu.models.env_light import EnvLightParams as JEnv  # noqa: E402
from materialrefgs_tpu.ops import cubemap as jcm  # noqa: E402
from materialrefgs_tpu.ops import mesh_tracer as jmt  # noqa: E402
from materialrefgs_tpu.ops.rasterize.api import RasterizeConfig as JRaster  # noqa: E402
from materialrefgs_tpu.ops.tracer.api import TracerConfig as JTracer  # noqa: E402
from materialrefgs_tpu.render import envgs as jenvgs  # noqa: E402
from materialrefgs_tpu.render.renderers import RenderOptions as JOpts  # noqa: E402

from materialrefgs_torch import evaluate  # noqa: E402
from materialrefgs_torch.cameras import look_at_camera as torch_camera  # noqa: E402
from materialrefgs_torch.models import convert  # noqa: E402
from materialrefgs_torch.models.env_light import EnvLightMips as TMips  # noqa: E402
from materialrefgs_torch.models.gaussian_model import PARAM_SHAPES  # noqa: E402
from materialrefgs_torch.ops import cubemap as tcm  # noqa: E402
from materialrefgs_torch.ops import mesh_tracer as tmt  # noqa: E402
from materialrefgs_torch.ops.rasterize.api import RasterizeConfig as TRaster  # noqa: E402
from materialrefgs_torch.ops.tracer.api import TracerConfig as TTracer  # noqa: E402
from materialrefgs_torch.render import envgs as tenvgs  # noqa: E402
from materialrefgs_torch.render.renderers import RenderOptions as TOpts  # noqa: E402
from materialrefgs_torch.train.mesh_extract import write_mesh_ply  # noqa: E402
from materialrefgs_torch.utils import png  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = H = 32
PAIRS = 1 << 12
CLUSTER_PAIRS = 1 << 9


def _jax_texel_grid(res, device=None):
    # JAX's texel-center directions (the grids differ by one float32 ulp,
    # which flips the face of samples on cube edges; test_torch_shading.py).
    return torch.tensor(np.asarray(jcm.face_dirs(res)), device=device)


def _leaves(rng, P, cap, spread, scale_mu):
    K = 16
    leaves = {name: np.zeros((cap,) + shape(K), np.float32) for name, shape in PARAM_SHAPES.items()}
    leaves["xyz"][:P] = rng.normal(size=(P, 3)) * spread
    leaves["scaling"][:] = -10.0
    leaves["scaling"][:P] = rng.normal(size=(P, 2)) * 0.3 + scale_mu
    leaves["rotation"][:, 0] = 1.0
    leaves["rotation"][:P] = rng.normal(size=(P, 4))
    leaves["opacity"][:] = -15.0
    leaves["opacity"][:P] = rng.normal(size=(P, 1)) + 1.0
    for name in ("refl_strength", "roughness", "ori_color", "metalness", "diffuse_color"):
        leaves[name][:P] = rng.normal(size=leaves[name][:P].shape)
    for name in ("features_dc", "indirect_dc"):
        leaves[name][:P] = rng.normal(size=(P, 1, 3)) * 0.8
    for name in ("features_rest", "indirect_rest"):
        leaves[name][:P] = rng.normal(size=(P, K - 1, 3)) * 0.2
    return leaves


def _models(seed=0, P=64):
    """(JAX model, port model) pairs for the main and the env cloud, and the
    cubemap logits: a 64-splat object at the origin and 64 env splats
    around it with degree-3 SH."""
    rng = np.random.default_rng(seed)
    out = []
    for spread, mu in ((0.45, -1.6), (1.8, -0.9)):
        leaves = _leaves(rng, P, P, spread, mu)
        jm = jgm.GaussianModel(
            params=jgm.GaussianParams(**{k: jnp.asarray(v) for k, v in leaves.items()}),
            alive=jnp.ones(P, bool), max_radii2d=jnp.zeros(P), xyz_gradient_accum=jnp.zeros(P),
            denom=jnp.zeros(P), active_sh_degree=jnp.int32(3), max_sh_degree=3, capacity=P,
        )
        tm = convert.gaussian_model_from_numpy(leaves, np.ones(P, bool), 3, device="cpu")
        out.append((jm, tm))
    return out[0], out[1], rng.normal(size=(6, 16, 16, 3)).astype(np.float32)


def _mesh(n_lat=14, n_lon=28, radius=0.55):
    """A lumpy UV sphere around the object: some reflected rays hit it."""
    th = np.linspace(0.0, np.pi, n_lat + 1)
    ph = np.linspace(0.0, 2 * np.pi, n_lon, endpoint=False)
    t, p = np.meshgrid(th, ph, indexing="ij")
    v = np.stack([np.sin(t) * np.cos(p), np.cos(t), np.sin(t) * np.sin(p)], -1).reshape(-1, 3)
    v = v * radius * (1.0 + 0.25 * np.sin(7.0 * v[:, :1]) * np.cos(5.0 * v[:, 1:2]))
    idx = np.arange((n_lat + 1) * n_lon).reshape(n_lat + 1, n_lon)
    a, b = idx[:-1], np.roll(idx[:-1], -1, axis=1)
    c, d = idx[1:], np.roll(idx[1:], -1, axis=1)
    faces = np.concatenate([np.stack([a, c, b], -1), np.stack([b, c, d], -1)]).reshape(-1, 3)
    return v.astype(np.float32), faces.astype(np.int32)


@pytest.fixture(scope="module")
def renders():
    mp = pytest.MonkeyPatch()
    mp.setattr(tcm, "face_dirs", _jax_texel_grid)
    (jm, tm), (jenv, tenv), env_base = _models()
    kw = dict(eye=np.array([0.3, -0.4, -3.0]), target=np.zeros(3), up=np.array([0.0, 1.0, 0.0]),
              fovx=0.8, fovy=0.8, width=W, height=H)
    jc, tc = jax_camera(**kw), torch_camera(**kw, device="cpu")
    jmips = JMips.build(JEnv(base=jnp.asarray(env_base)), min_res=8, n_samples=4)
    tmips = TMips.build(convert.env_light_from_numpy(env_base, device="cpu"), min_res=8, n_samples=4)
    bg = np.ones(3, np.float32)
    jopts = JOpts(raster=JRaster(pair_capacity=PAIRS, interpret=True))
    topts = TOpts(raster=TRaster(pair_capacity=PAIRS))
    jt = JTracer(pair_capacity=PAIRS, cluster_pair_capacity=CLUSTER_PAIRS, interpret=True, exact_order=True)
    tt = TTracer(pair_capacity=PAIRS, cluster_pair_capacity=CLUSTER_PAIRS, exact_order=True)
    verts, faces = _mesh()
    out = {}
    for name, jmesh, tmesh in (("splat", None, None),
                               ("mesh", jmt.build_mesh(verts, faces), tmt.build_mesh(verts, faces, device="cpu"))):
        ref = jax.jit(lambda c, m: jenvgs.render_surfel2(jm, jenv, c, jnp.asarray(bg), jmips, jopts, jt, mesh=m))(
            jc, jmesh)
        with torch.no_grad():
            got = tenvgs.render_surfel2(tm, tenv, tc, torch.from_numpy(bg), tmips, topts, tt, mesh=tmesh)
        out[name] = (ref, got)
    yield out
    mp.undo()


@pytest.mark.parametrize("vis", ["splat", "mesh"])
def test_render_surfel2_matches_jax(renders, vis):
    ref, out = renders[vis]
    assert out["tracer_overflow"] == int(ref["tracer_overflow"]) == 0
    assert out["tracer_pairs"] == int(ref["tracer_pairs"]) > 0
    assert out["mesh_cull_dropped"] == int(ref["mesh_cull_dropped"]) == 0
    assert int(out["overflow"]) == int(ref["overflow"]) == 0
    pairs = {
        "render": (out["render"], ref["render"]),
        "specular_map": (out["specular_map"], ref["specular_map"]),
        "visibility": (out["visibility"], ref["visibility"]),
        "indirect": (out["indirect_out"]["render"], ref["indirect_out"]["render"]),
        "blend_weight": (out["blend_weight"], ref["blend_weight"]),
    }
    for key, (a, b) in pairs.items():
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=3e-4, rtol=1e-3, err_msg=key)
    # The case exercises what it claims: traced env light on covered pixels,
    # visibility below 1 somewhere, and (mesh) hard {0, 1} visibility.
    alpha = out["rend_alpha"].numpy()[..., 0]
    assert (alpha > 0.5).mean() > 0.2
    assert float(out["indirect_out"]["render"].max()) > 0.05
    vmap = out["visibility"].numpy()
    assert vmap.min() < 0.5
    if vis == "mesh":
        assert set(np.unique(vmap)) <= {0.0, 1.0}


def test_render_set_redoes_an_overflowed_view():
    """evaluate.render_set with budgets far below a view's demand redoes the
    view with budgets that fit (at most twice) and keeps them for the next
    view: its metrics equal those of a render_set with roomy budgets."""
    (_, tm), (_, tenv), env_base = _models(seed=2)
    cam = torch_camera(eye=np.array([0.3, -0.4, -3.0]), target=np.zeros(3), up=np.array([0.0, 1.0, 0.0]),
                       fovx=0.8, fovy=0.8, width=W, height=H, device="cpu")
    mips = TMips.build(convert.env_light_from_numpy(env_base, device="cpu"), min_res=8, n_samples=4)
    gt = np.random.default_rng(3).uniform(size=(H, W, 3)).astype(np.float32)
    kw = dict(opts=TOpts(raster=TRaster(pair_capacity=PAIRS)), dump_maps=False, bg_color=(1.0, 1.0, 1.0))
    metrics = {}
    for name, cfg in (("roomy", TTracer(pair_capacity=PAIRS, cluster_pair_capacity=CLUSTER_PAIRS)),
                      ("tight", TTracer(pair_capacity=256, cluster_pair_capacity=1))):
        metrics[name] = evaluate.render_set("", "test", [cam, cam], [gt, gt], tm, mips, tenv,
                                            tracer_cfg=dataclasses.replace(cfg, exact_order=True), **kw)
    roomy, tight = metrics["roomy"], metrics["tight"]
    assert roomy["tracer_redos"] == 0 and 1 <= tight["tracer_redos"] <= 2
    assert roomy["tracer_overflow"] == tight["tracer_overflow"] == 0
    assert tight["per_view_psnr"] == roomy["per_view_psnr"] and tight["ssim"] == roomy["ssim"]
    c_pairs, slots = tight["tracer_budgets"]
    assert 1 < c_pairs <= CLUSTER_PAIRS and slots % 128 == 0


def _write_blender_scene(root, n_views=2):
    os.makedirs(os.path.join(root, "test"))
    frames = []
    for i in range(n_views):
        ang = 0.7 * i
        eye = np.array([3.0 * np.sin(ang), 0.4, -3.0 * np.cos(ang)])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, [0.0, 1.0, 0.0])
        right /= np.linalg.norm(right)
        up = np.cross(right, fwd)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, -fwd, eye  # OpenGL axes
        frames.append({"file_path": f"./test/r_{i}", "transform_matrix": c2w.tolist()})
        yy, xx = np.mgrid[0:24, 0:40] / np.array([24, 40])[:, None, None]
        rgb = 0.5 + 0.4 * np.sin(5 * xx + 3 * yy + i)[..., None] * np.array([1.0, 0.7, 0.4])
        png.write_png(os.path.join(root, "test", f"r_{i}.png"), (np.clip(rgb, 0, 1) * 255 + 0.5).astype(np.uint8))
    for split in ("train", "test"):
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.8, "frames": frames}, f)


def test_eval_env_gs_checkpoint_matches_jax(tmp_path, monkeypatch):
    """scripts/eval_torch.py on an env-GS checkpoint (iteration 30000 of the
    refnerf curriculum: surfel2) with a mesh, against scripts/eval.py, on a
    40x24 scene (not a multiple of 16)."""
    monkeypatch.setattr(tcm, "face_dirs", _jax_texel_grid)
    scene = str(tmp_path / "scene")
    _write_blender_scene(scene)
    (jm, _), (jenv, _), env_base = _models(seed=1)
    verts, faces = _mesh()
    runs = {}
    for side in ("jax", "torch"):
        root = tmp_path / side
        it_dir = root / "point_cloud" / "iteration_30000"
        jio.save_ply(jm, str(it_dir / "point_cloud.ply"), env1=JEnv(base=jnp.asarray(env_base)))
        jio.save_ply(jenv, str(it_dir / "env_point_cloud.ply"))
        write_mesh_ply(str(root / "meshes" / "test_030000.ply"), verts, faces)
        m, p, o = jcfg.preset_refnerf()
        jcfg.dump_config(str(root), m, p, o, extra={"pair_capacity": PAIRS})
        runs[side] = str(root)

    argv = ["-s", scene, "--skip_train", "--device", "cpu"]
    spec = importlib.util.spec_from_file_location("jax_eval", os.path.join(REPO, "scripts", "eval.py"))
    jax_eval = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_eval)
    monkeypatch.setattr(sys, "argv", ["eval.py", "-m", runs["jax"], *argv])
    jax_eval.main()
    with open(os.path.join(runs["jax"], "eval_30000", "metric.txt")) as f:
        ref = {k: v.strip() for k, v in (line.split(":", 1) for line in f)}

    spec = importlib.util.spec_from_file_location("eval_torch", os.path.join(REPO, "scripts", "eval_torch.py"))
    eval_torch = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(eval_torch)
    m = eval_torch.main(["-m", runs["torch"], *argv])["test"]

    assert abs(m["psnr"] - float(ref["psnr"])) < 0.01, (m["psnr"], ref["psnr"])
    assert abs(m["ssim"] - float(ref["ssim"])) < 1e-4, (m["ssim"], ref["ssim"])
    assert len(m["per_view_psnr"]) == 2 and m["overflow"] == 0
    for sub in ("renders", "visibility", "specular", "albedo"):
        assert os.path.exists(os.path.join(runs["torch"], "eval_30000", "test", sub, "00000.png")), sub
