"""The port's mesh shading against the JAX package (ops/mesh_tracer.py's
interpolate_attr, secondary_color, shade_one_bounce and bake_vertex_attrs;
render/renderers.py's mesh_indirect_maps and render_surfel(mesh=...) in the
raytracing_residual flavor), with the env light's gradient through both env
fetches.

On shared inputs (the same mesh, rays and mip textures) the shading
functions agree to rtol 1e-5 and the hit triangles exactly. Through the
rasterizer (JAX in Pallas interpret mode) the maps are held to
tests/test_rasterize_pallas.py's atol 3e-4 / rtol 1e-3 and the gradients to
tests/test_rasterize_grad.py:93's 2e-3 x scale."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from materialrefgs_tpu.cameras import look_at_camera as jax_camera  # noqa: E402
from materialrefgs_tpu.models.env_light import EnvLightMips as JMips  # noqa: E402
from materialrefgs_tpu.models.env_light import EnvLightParams as JEnv  # noqa: E402
from materialrefgs_tpu.ops import mesh_tracer as jmt  # noqa: E402
from materialrefgs_tpu.ops.rasterize.api import RasterizeConfig as JRaster  # noqa: E402
from materialrefgs_tpu.render import renderers as jren  # noqa: E402

from materialrefgs_torch.cameras import look_at_camera as torch_camera  # noqa: E402
from materialrefgs_torch.models import convert  # noqa: E402
from materialrefgs_torch.models.env_light import EnvLightMips as TMips  # noqa: E402
from materialrefgs_torch.models.env_light import EnvLightParams as TEnv  # noqa: E402
from materialrefgs_torch.ops import cubemap as tcm  # noqa: E402
from materialrefgs_torch.ops import mesh_tracer as tmt  # noqa: E402
from materialrefgs_torch.ops.rasterize.api import RasterizeConfig as TRaster  # noqa: E402
from materialrefgs_torch.render import renderers as tren  # noqa: E402
from test_torch_envgs import _jax_texel_grid, _mesh, _models  # noqa: E402

W = H = 32
RTOL = 1e-5


def _attrs(rng, V):
    return {
        "diffuse": rng.uniform(size=(V, 3)).astype(np.float32),
        "albedo": rng.uniform(0.05, 0.95, size=(V, 3)).astype(np.float32),
        "metallic": rng.uniform(size=(V, 1)).astype(np.float32),
        "roughness": rng.uniform(0.05, 1.0, size=(V, 1)).astype(np.float32),
        "normal": rng.uniform(size=(V, 3)).astype(np.float32),
    }


def _rays(rng, n=1000):
    """Origins inside and around the lumpy sphere, directions all around:
    roughly half the rays hit it."""
    o = (rng.normal(size=(n, 3)) * 0.3).astype(np.float32)
    o[: n // 2] += np.float32([0.0, 0.0, -1.2])
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


def _mips(seed=0, res=16):
    """JAX mips from random logits, and the port's on the same textures."""
    base = np.random.default_rng(seed).normal(size=(6, res, res, 3)).astype(np.float32)
    jm = JMips.build(JEnv(base=jnp.asarray(base)), n_samples=4)
    tm = TMips(specular=tuple(torch.tensor(np.asarray(s)) for s in jm.specular),
               diffuse=torch.tensor(np.asarray(jm.diffuse)), min_roughness=jm.min_roughness,
               max_roughness=jm.max_roughness)
    return base, jm, tm


def _close(t, j, rtol=RTOL, atol=1e-6, what=""):
    np.testing.assert_allclose(t.detach().numpy() if torch.is_tensor(t) else t, np.asarray(j),
                               rtol=rtol, atol=atol, err_msg=what)


@pytest.fixture
def meshes():
    verts, faces = _mesh()
    attrs = _attrs(np.random.default_rng(4), len(verts))
    jplain, tplain = jmt.build_mesh(verts, faces), tmt.build_mesh(verts, faces, device="cpu")
    jattr = jmt.build_mesh(verts, faces, attrs)
    tattr = tmt.build_mesh(verts, faces, attrs, device="cpu")
    return (jplain, tplain), (jattr, tattr)


def test_build_mesh_attrs_and_carry_across(meshes):
    """build_mesh keeps the attributes; a JAX MeshData carries across field
    for field, and one padded to the JAX Trainer's capacity traces as the
    port's unpadded mesh (padding rows never hit)."""
    verts, faces = _mesh()
    (_, _), (jattr, tattr) = meshes
    for k in jattr.attrs:
        _close(tattr.attrs[k], jattr.attrs[k], rtol=0, atol=0, what=k)
    fields = ("v0", "e1", "e2", "normal", "valid", "vertices", "triangles", "cluster_lo", "cluster_hi")
    carried = convert.mesh_from_numpy({k: np.asarray(getattr(jattr, k)) for k in fields},
                                      {k: np.asarray(v) for k, v in jattr.attrs.items()}, device="cpu")
    for k in fields:
        np.testing.assert_array_equal(getattr(carried, k).numpy(), getattr(tattr, k).numpy(), err_msg=k)
    for k in jattr.attrs:
        np.testing.assert_array_equal(carried.attrs[k].numpy(), tattr.attrs[k].numpy(), err_msg=k)
    jpad = jmt.build_mesh(verts, faces, pad_to=2048, pad_verts_to=1024)
    tpad = convert.mesh_from_numpy({k: np.asarray(getattr(jpad, k)) for k in fields}, device="cpu")
    assert tpad.n_tris == 2048 and tpad.vertices.shape[0] == 1024
    o, d = _rays(np.random.default_rng(1), 512)
    a = tmt.trace(tpad, torch.from_numpy(o), torch.from_numpy(d))
    b = tmt.trace(tattr, torch.from_numpy(o), torch.from_numpy(d))
    assert torch.equal(a["tri"], b["tri"]) and torch.equal(a["depth"], b["depth"])
    assert int((b["tri"] >= 0).sum()) > 100


def test_interpolate_and_secondary_color_match_jax(meshes):
    rng = np.random.default_rng(2)
    o, d = _rays(rng)
    _, jm, tm = _mips()
    for jmesh, tmesh in meshes:
        jhit = jmt.trace(jmesh, jnp.asarray(o), jnp.asarray(d))
        thit = tmt.trace(tmesh, torch.from_numpy(o), torch.from_numpy(d))
        np.testing.assert_array_equal(thit["tri"].numpy(), np.asarray(jhit["tri"]))
        n_hit = int((thit["tri"] >= 0).sum())
        assert 200 < n_hit < 900, n_hit
        for k in jmesh.attrs:
            _close(tmt.interpolate_attr(tmesh, k, thit["tri"], thit["bary"]),
                   jmt.interpolate_attr(jmesh, k, jhit["tri"], jhit["bary"]), what=k)
        _close(tmt.secondary_color(tmesh, tm, thit, torch.from_numpy(d)),
               jmt.secondary_color(jmesh, jm, jhit, jnp.asarray(d)), what="secondary_color")


def test_shade_one_bounce_matches_jax_with_env_gradient(meshes, monkeypatch):
    """Values (hit ids exact) and the gradients of a weighted sum of the
    indirect light with respect to the cubemap logits (through the mip
    build and both env fetches) and to the vertex albedo."""
    monkeypatch.setattr(tcm, "face_dirs", _jax_texel_grid)
    rng = np.random.default_rng(3)
    pos, _ = _rays(rng, 768)
    n = rng.normal(size=pos.shape).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    v = rng.normal(size=pos.shape).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    wgt = rng.uniform(size=(768, 3)).astype(np.float32)
    base = np.random.default_rng(0).normal(size=(6, 16, 16, 3)).astype(np.float32)
    (jplain, tplain), (jattr, tattr) = meshes

    for jmesh, tmesh in ((jplain, tplain), (jattr, tattr)):
        def jloss(b, albedo):
            attrs = dict(jmesh.attrs)
            if attrs:
                attrs["albedo"] = albedo
            mips = JMips.build(JEnv(base=b), n_samples=4)
            out = jmt.shade_one_bounce(jmesh.replace(attrs=attrs), mips, jnp.asarray(pos), jnp.asarray(n),
                                       jnp.asarray(v))
            return jnp.sum(out["indirect"] * wgt), out

        alb = np.asarray(jattr.attrs["albedo"])
        (jl, jout), (jgb, jga) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(base),
                                                                                          jnp.asarray(alb))
        tenv = TEnv(torch.tensor(base))  # an nn.Parameter: the gradient's leaf
        tb = tenv.base
        ta = torch.tensor(alb, requires_grad=True)
        attrs = dict(tmesh.attrs)
        if attrs:
            attrs["albedo"] = ta
        mips = TMips.build(tenv, n_samples=4)
        tout = tmt.shade_one_bounce(dataclasses.replace(tmesh, attrs=attrs), mips, torch.from_numpy(pos),
                                    torch.from_numpy(n), torch.from_numpy(v))
        tl = torch.sum(tout["indirect"] * torch.from_numpy(wgt))
        tgb, tga = torch.autograd.grad(tl, [tb, ta], allow_unused=True)
        np.testing.assert_array_equal(tout["visibility"].numpy(), np.asarray(jout["visibility"]))
        np.testing.assert_array_equal(tout["depth"].numpy() >= 10, np.asarray(jout["depth"]) >= 10)
        assert 0 < float(tout["visibility"].mean()) < 1
        assert tout["cull_dropped"] == int(jout["cull_dropped"]) == 0
        _close(tout["indirect"], jout["indirect"], atol=1e-5, what="indirect")
        _close(tl, jl, what="loss")
        scale = float(np.abs(np.asarray(jgb)).max())
        assert scale > 0
        np.testing.assert_allclose(tgb.numpy(), np.asarray(jgb), atol=2e-3 * scale, err_msg="d/d env logits")
        if tmesh.attrs:
            scale = float(np.abs(np.asarray(jga)).max())
            assert scale > 0
            np.testing.assert_allclose(tga.numpy(), np.asarray(jga), atol=2e-3 * scale, err_msg="d/d albedo")


def test_bake_vertex_attrs_matches_jax():
    """The same cKDTree query on the same float32 inputs, so the same
    neighbours and weights; a dead slot takes no part."""
    (jm, tm), _, _ = _models(P=64)
    jm = jm.replace(alive=jm.alive.at[5].set(False))
    with torch.no_grad():
        tm.alive[5] = False
    verts, _ = _mesh()
    ja = jmt.bake_vertex_attrs(jm, verts)
    ta = tmt.bake_vertex_attrs(tm, verts)
    assert set(ta) == set(ja)
    for k in ja:
        assert ta[k].dtype == np.float32 and ta[k].shape == ja[k].shape
        np.testing.assert_allclose(ta[k], ja[k], rtol=RTOL, atol=1e-6, err_msg=k)


def _surface(camera_kw, seed=5):
    """A normal map, unbiased depth and alpha of the lumpy sphere's
    neighbourhood: depth 2.6-3.4 where alpha > 0, a ring of empty pixels."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W] / np.float32(H)
    alpha = ((((xx - 0.5) ** 2 + (yy - 0.5) ** 2) < 0.18) * rng.uniform(0.3, 1.0, size=(H, W)))[..., None]
    depth = (3.0 + 0.4 * np.sin(4 * xx) * np.cos(3 * yy))[..., None] * (alpha > 0)
    nrm = rng.normal(size=(H, W, 3)) * 0.4 + np.array([0.0, 0.0, -1.0])
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    return nrm.astype(np.float32), depth.astype(np.float32), alpha.astype(np.float32)


def test_mesh_indirect_maps_matches_jax(monkeypatch):
    monkeypatch.setattr(tcm, "face_dirs", _jax_texel_grid)
    kw = dict(eye=np.array([0.3, -0.4, -3.0]), target=np.zeros(3), up=np.array([0.0, 1.0, 0.0]),
              fovx=0.8, fovy=0.8, width=W, height=H)
    jc, tc = jax_camera(**kw), torch_camera(**kw, device="cpu")
    verts, faces = _mesh(radius=1.1)
    jmesh, tmesh = jmt.build_mesh(verts, faces), tmt.build_mesh(verts, faces, device="cpu")
    nrm, depth, alpha = _surface(kw)
    _, jm, tm = _mips()
    jout = jax.jit(lambda m: jren.mesh_indirect_maps(m, jc, jnp.asarray(nrm), jnp.asarray(depth), jm,
                                                     jnp.asarray(alpha)))(jmesh)
    tout = tren.mesh_indirect_maps(tmesh, tc, torch.from_numpy(nrm), torch.from_numpy(depth), tm,
                                   torch.from_numpy(alpha))
    np.testing.assert_array_equal(tout["visibility"].numpy(), np.asarray(jout["visibility"]))
    occluded = float((1 - tout["visibility"]).sum())
    assert occluded > 20 and float((tout["visibility"] * (torch.from_numpy(alpha) > 0)).sum()) > 20
    _close(tout["indirect"], jout["indirect"], atol=1e-5, what="indirect")
    assert float(tout["indirect"][torch.from_numpy(alpha)[..., 0] <= 0].abs().max()) == 0.0
    assert tout["cull_dropped"] == int(jout["cull_dropped"]) == 0


def test_render_surfel_residual_matches_jax(monkeypatch):
    """render_surfel(mesh=...), the raytracing_residual branch:
    every shaded map, the visibility and indirect light it used, and the
    gradients of a weighted sum of the render with respect to the cubemap
    logits and the gaussians' parameters."""
    monkeypatch.setattr(tcm, "face_dirs", _jax_texel_grid)
    (jm, tm), _, env_base = _models()
    kw = dict(eye=np.array([0.3, -0.4, -3.0]), target=np.zeros(3), up=np.array([0.0, 1.0, 0.0]),
              fovx=0.8, fovy=0.8, width=W, height=H)
    jc, tc = jax_camera(**kw), torch_camera(**kw, device="cpu")
    verts, faces = _mesh()
    jmesh, tmesh = jmt.build_mesh(verts, faces), tmt.build_mesh(verts, faces, device="cpu")
    wgt = np.random.default_rng(6).uniform(size=(H, W, 3)).astype(np.float32)
    jopts = jren.RenderOptions(indirect_type="raytracing_residual", raster=JRaster(pair_capacity=1 << 12,
                                                                                   interpret=True))
    topts = tren.RenderOptions(raster=TRaster(pair_capacity=1 << 12))

    def jloss(params, base):
        mips = JMips.build(JEnv(base=base), n_samples=4)
        pkg = jren.render_surfel(jm.replace(params=params), jc, jnp.ones(3), mips, jopts, mesh=jmesh,
                                 mesh_cull_cap=512)
        return jnp.sum(pkg["render"] * wgt), pkg

    (jl, jpkg), (jgp, jgb) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        jm.params, jnp.asarray(env_base))
    tenv = TEnv(torch.tensor(env_base))
    tb = tenv.base
    mips = TMips.build(tenv, n_samples=4)
    leaves = {k: getattr(tm, k) for k in ("xyz", "rotation", "scaling", "opacity", "refl_strength", "roughness",
                                           "ori_color", "features_dc")}
    for p in leaves.values():
        p.requires_grad_(True)
    tpkg = tren.render_surfel(tm, tc, torch.ones(3), mips, topts, mesh=tmesh, mesh_cull_cap=512)
    tl = torch.sum(tpkg["render"] * torch.from_numpy(wgt))
    grads = torch.autograd.grad(tl, [tb] + list(leaves.values()))
    assert tpkg["mesh_cull_dropped"] == int(jpkg["mesh_cull_dropped"]) == 0
    vis_t = tpkg["visibility"].detach().numpy()
    # At this seed no reflected ray grazes a triangle edge within the two
    # packages' rounding of the rasterized normals: the same pixels are
    # occluded.
    np.testing.assert_array_equal(vis_t, np.asarray(jpkg["visibility"]))
    assert float((1 - vis_t).sum()) > 10
    for k in ("render", "specular_map", "indirect_light", "surf_depth", "rend_normal"):
        np.testing.assert_allclose(tpkg[k].detach().numpy(), np.asarray(jpkg[k]), atol=3e-4, rtol=1e-3, err_msg=k)
    assert float(np.abs(tpkg["indirect_light"].detach().numpy()).max()) > 0
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    for name, g, jg in zip(["env"] + list(leaves), grads, [jgb] + [getattr(jgp, k) for k in leaves]):
        scale = max(float(np.abs(np.asarray(jg)).max()), 1e-6)
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=2e-3 * scale, err_msg=name)
    assert float(np.abs(np.asarray(jgb)).max()) > 0
