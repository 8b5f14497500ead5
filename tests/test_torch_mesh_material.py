"""The port's material mesh (train/mesh_material.py, eval_torch
--export_material_mesh) against the JAX package: the PLY writer
byte-identical on the same attributes, the reader's round trip, the
vertex-albedo refinement step against optax.adam over 3 steps, and the
export from a checkpoint and an extracted mesh against the JAX package's
bake_vertex_attrs + writer (rtol 1e-5; vertices and faces exact)."""
import os

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from materialrefgs_tpu.models import gaussian_io as jio  # noqa: E402
from materialrefgs_tpu.models.env_light import EnvLightMips as JMips  # noqa: E402
from materialrefgs_tpu.models.env_light import EnvLightParams as JEnv  # noqa: E402
from materialrefgs_tpu.ops import mesh_tracer as jmt  # noqa: E402
from materialrefgs_tpu.train import mesh_material as jmm  # noqa: E402

from materialrefgs_torch import config as tcfg  # noqa: E402
from materialrefgs_torch.models import gaussian_io as tio  # noqa: E402
from materialrefgs_torch.models.env_light import EnvLightMips as TMips  # noqa: E402
from materialrefgs_torch.ops import mesh_tracer as tmt  # noqa: E402
from materialrefgs_torch.train import mesh_material as tmm  # noqa: E402
from materialrefgs_torch.train.mesh_extract import write_mesh_ply  # noqa: E402
from test_torch_envgs import _mesh, _models  # noqa: E402
from test_torch_train import _load_script, _write_blender_scene  # noqa: E402


def _attrs(rng, V):
    return {
        "diffuse": rng.uniform(size=(V, 3)).astype(np.float32),
        "albedo": rng.uniform(0.05, 0.95, size=(V, 3)).astype(np.float32),
        "metallic": rng.uniform(size=(V, 1)).astype(np.float32),
        "roughness": rng.uniform(0.05, 1.0, size=(V, 1)).astype(np.float32),
        "normal": rng.uniform(size=(V, 3)).astype(np.float32),
    }


def test_material_ply_is_byte_identical_and_round_trips(tmp_path):
    verts, faces = _mesh()
    attrs = _attrs(np.random.default_rng(0), len(verts))
    rgb = np.random.default_rng(1).uniform(size=(len(verts), 3)).astype(np.float32)
    for kw in ({}, {"rgb": rgb}):
        jp, tp = str(tmp_path / "jax.ply"), str(tmp_path / "sub" / "torch.ply")
        jmm.write_material_mesh_ply(jp, verts, faces, attrs, **kw)
        tmm.write_material_mesh_ply(tp, verts, faces, attrs, **kw)
        with open(jp, "rb") as f, open(tp, "rb") as g:
            assert f.read() == g.read()
        tv, tf, ta = tmm.read_material_mesh_ply(tp)
        jv, jf, ja = jmm.read_material_mesh_ply(jp)
        np.testing.assert_array_equal(tv, verts)
        np.testing.assert_array_equal(tf, faces)
        assert tf.dtype == np.int32 and set(ta) == set(ja) == set(attrs)
        for k in attrs:
            np.testing.assert_array_equal(ta[k], ja[k])
            np.testing.assert_allclose(ta[k], attrs[k], atol=1e-6, err_msg=k)  # normal: (2n - 1) / 2 + 1/2


def test_vertex_albedo_step_tracks_optax():
    """Three steps of make_vertex_albedo_step in both packages from the same
    mesh, mips, samples and target: the loss before each step and the
    albedo logits after it."""
    verts, faces = _mesh()
    attrs = _attrs(np.random.default_rng(2), len(verts))
    jmesh, tmesh = jmt.build_mesh(verts, faces, attrs), tmt.build_mesh(verts, faces, attrs, device="cpu")
    base = np.random.default_rng(3).normal(size=(6, 16, 16, 3)).astype(np.float32)
    jmips = JMips.build(JEnv(base=jnp.asarray(base)), n_samples=4)
    tmips = TMips(specular=tuple(torch.tensor(np.asarray(s)) for s in jmips.specular),
                  diffuse=torch.tensor(np.asarray(jmips.diffuse)))
    rng = np.random.default_rng(4)
    pos = (rng.normal(size=(512, 3)) * 0.2 + np.array([0.0, 0.0, -0.1])).astype(np.float32)
    n = rng.normal(size=(512, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    v = rng.normal(size=(512, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    target = rng.uniform(size=(512, 3)).astype(np.float32)
    jstate, jstep = jmm.make_vertex_albedo_step(jmesh, jmips, lr=0.05)
    tstate, tstep = tmm.make_vertex_albedo_step(tmesh, tmips, lr=0.05)
    np.testing.assert_allclose(tstate[0].numpy(), np.asarray(jstate[0]), rtol=1e-6, atol=1e-6)
    losses, bound = [], 1e-6
    for t in range(1, 4):
        mu0 = tstate[1].mu["albedo"].clone().numpy()
        jstate, jl = jstep(jstate, jnp.asarray(pos), jnp.asarray(n), jnp.asarray(v), jnp.asarray(target))
        tstate, tl = tstep(tstate, torch.from_numpy(pos), torch.from_numpy(n), torch.from_numpy(v),
                           torch.from_numpy(target))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        # The gradient, read from the new first moments, agrees to rounding
        # (1e-5 of its scale); the logits as far as that carries through
        # Adam, whose u = mu / (sqrt(nu) + eps) magnifies it where a
        # vertex's gradient is tiny (each step's bound added to the last's).
        jmu, jnu = np.asarray(jstate[1][0].mu), np.asarray(jstate[1][0].nu)
        gj = (jmu - 0.9 * mu0) / 0.1
        gt = (tstate[1].mu["albedo"].numpy() - 0.9 * mu0) / 0.1
        gtol = 1e-5 * float(np.abs(gj).max())
        np.testing.assert_allclose(gt, gj, atol=gtol, rtol=0)
        sq = np.sqrt(jnu / (1 - 0.999**t)) + 1e-8
        bound = bound + 2 * 0.05 * (0.1 * gtol / (1 - 0.9**t)) / sq
        assert np.all(np.abs(tstate[0].numpy() - np.asarray(jstate[0])) <= bound)
        losses.append(float(tl))
    assert tstate[1].count == 3 and tstate[1].eps == 1e-8
    assert losses[-1] < losses[0]
    moved = np.abs(tstate[0].numpy() - tmm.make_vertex_albedo_step(tmesh, tmips)[0][0].numpy())
    assert moved.max() > 0.1  # three steps of lr 0.05 on the vertices the samples hit


def test_eval_export_material_mesh_matches_jax(tmp_path):
    """scripts/eval_torch.py --export_material_mesh on a checkpoint without
    an env-GS cloud: it bakes the newest meshes/*.ply and writes
    fuse_post_material.ply, as the JAX package's bake_vertex_attrs and
    writer do from the same PLY and mesh."""
    scene, run = str(tmp_path / "scene"), str(tmp_path / "run")
    _write_blender_scene(scene)
    (_, tm), _, _ = _models(P=64)
    ply = os.path.join(run, "point_cloud", "iteration_30", "point_cloud.ply")
    tio.save_ply(tm, ply)
    m, p, o = tcfg.preset_refnerf()
    tcfg.dump_config(run, m, p, o, extra={"pair_capacity": 1 << 14})
    verts, faces = _mesh()
    write_mesh_ply(os.path.join(run, "meshes", "test_000010.ply"), verts * 0.5, faces)
    write_mesh_ply(os.path.join(run, "meshes", "test_000020.ply"), verts, faces)  # the newest
    res = _load_script("eval_torch").main(["-m", run, "-s", scene, "--skip_train", "--skip_test",
                                           "--export_material_mesh", "--device", "cpu"])
    out = os.path.join(run, "fuse_post_material.ply")
    assert res["material_mesh"] == out
    jm, _, _ = jio.load_ply(ply, max_sh_degree=3)
    jattrs = jmt.bake_vertex_attrs(jm, verts)
    jmm.write_material_mesh_ply(str(tmp_path / "jax.ply"), verts, faces, jattrs)
    tv, tf, ta = tmm.read_material_mesh_ply(out)
    jv, jf, ja = jmm.read_material_mesh_ply(str(tmp_path / "jax.ply"))
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    for k in ja:
        np.testing.assert_allclose(ta[k], ja[k], rtol=1e-5, atol=1e-6, err_msg=k)
    assert float(np.std(ta["albedo"])) > 0.01

    # Without an extracted mesh there is nothing to bake.
    os.rename(os.path.join(run, "meshes"), os.path.join(run, "meshes_moved"))
    with pytest.raises(FileNotFoundError, match="mesh"):
        _load_script("eval_torch").main(["-m", run, "-s", scene, "--skip_train", "--skip_test",
                                         "--export_material_mesh", "--device", "cpu"])
