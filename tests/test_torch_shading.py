"""PyTorch port vs the JAX package: cubemap sampling, the mip chain, the
FG LUT and deferred specular shading (atol 1e-5)."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from materialrefgs_tpu.cameras import look_at_camera as jax_camera  # noqa: E402
from materialrefgs_tpu.models.env_light import EnvLightMips as JMips  # noqa: E402
from materialrefgs_tpu.models.env_light import EnvLightParams as JEnv  # noqa: E402
from materialrefgs_tpu.ops import brdf_lut as jlut  # noqa: E402
from materialrefgs_tpu.ops import cubemap as jcm  # noqa: E402
from materialrefgs_tpu.render import shading as jshade  # noqa: E402

from materialrefgs_torch.cameras import look_at_camera as torch_camera  # noqa: E402
from materialrefgs_torch.models.env_light import EnvLightMips as TMips  # noqa: E402
from materialrefgs_torch.models.env_light import EnvLightParams as TEnv  # noqa: E402
from materialrefgs_torch.ops import brdf_lut as tlut  # noqa: E402
from materialrefgs_torch.ops import cubemap as tcm  # noqa: E402
from materialrefgs_torch.render import shading as tshade  # noqa: E402

ATOL = 1e-5


def close(a, b, atol=ATOL):
    np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), atol=atol, rtol=1e-5)


def _dirs(rng, n):
    d = rng.normal(size=(n, 3)).astype(np.float32)
    # Include exact axis directions and face-edge diagonals.
    d[:6] = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]])
    d[6:9] = np.array([[1, 1, 0], [0, -1, 1], [1, 1, 1]])
    return d


def test_sample_cubemap_and_latlong_match_jax():
    rng = np.random.default_rng(0)
    cube = rng.normal(size=(6, 16, 16, 3)).astype(np.float32)
    d = _dirs(rng, 500)
    close(jcm.sample_cubemap(jnp.asarray(cube), jnp.asarray(d)),
          tcm.sample_cubemap(torch.from_numpy(cube), torch.from_numpy(d)))
    close(jcm.cubemap_to_latlong(jnp.asarray(cube), 16, 32),
          tcm.cubemap_to_latlong(torch.from_numpy(cube), 16, 32))


@pytest.fixture
def same_texel_grid(monkeypatch):
    """Give the port JAX's texel-center directions. The two grids differ by
    at most one float32 ulp (XLA computes linspace with a reciprocal
    multiply and an FMA), but a prefilter sample direction that lands on a
    cube edge then picks the other face, and edge-clamped sampling is
    discontinuous there. With equal grids the algorithms are compared."""
    assert np.abs(np.asarray(jcm.face_dirs(32)) - tcm.face_dirs(32).numpy()).max() <= 2.4e-7
    monkeypatch.setattr(
        tcm, "face_dirs", lambda res, device=None: torch.tensor(np.asarray(jcm.face_dirs(res)), device=device)
    )


def test_mip_chain_and_env_queries_match_jax(same_texel_grid):
    rng = np.random.default_rng(1)
    base = rng.normal(size=(6, 32, 32, 3)).astype(np.float32)
    jm = JMips.build(JEnv(base=jnp.asarray(base)))
    with torch.no_grad():
        tm = TMips.build(TEnv(torch.from_numpy(base)))
    assert len(jm.specular) == len(tm.specular) == 2
    for a, b in zip(jm.specular, tm.specular):
        close(a, b)
    close(jm.diffuse, tm.diffuse)

    d = _dirs(rng, 400)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rough = rng.uniform(0.0, 1.0, size=(400, 1)).astype(np.float32)
    close(jcm.get_mip(jnp.asarray(rough[:, 0]), 5),
          tcm.get_mip(torch.from_numpy(rough[:, 0]), 5))
    with torch.no_grad():
        close(jm(jnp.asarray(d), roughness=jnp.asarray(rough)),
              tm(torch.from_numpy(d), roughness=torch.from_numpy(rough)))
        close(jm(jnp.asarray(d), mode="diffuse"), tm(torch.from_numpy(d), mode="diffuse"))


def test_fg_lut_matches_jax():
    rng = np.random.default_rng(2)
    nov = rng.uniform(-0.2, 1.2, size=(1000,)).astype(np.float32)
    rough = rng.uniform(-0.2, 1.2, size=(1000,)).astype(np.float32)
    close(jlut.sample_fg_lut(jnp.asarray(nov), jnp.asarray(rough)),
          tlut.sample_fg_lut(torch.from_numpy(nov), torch.from_numpy(rough)))


def test_specular_color_surfel_matches_jax(same_texel_grid):
    rng = np.random.default_rng(3)
    W, H = 24, 20
    kw = dict(eye=np.array([0.5, -0.3, -4.0]), target=np.zeros(3),
              up=np.array([0.0, 1.0, 0.0]), fovx=0.9, fovy=0.8, width=W, height=H)
    jc, tc = jax_camera(**kw), torch_camera(**kw, device="cpu")
    base = rng.normal(size=(6, 32, 32, 3)).astype(np.float32)
    maps = dict(
        albedo=rng.uniform(size=(H, W, 3)),
        normal_map=rng.normal(size=(H, W, 3)),
        render_alpha=rng.uniform(size=(H, W, 1)),
        refl_strength=rng.uniform(size=(H, W, 1)),
        roughness=rng.uniform(size=(H, W, 1)),
    )
    maps = {k: v.astype(np.float32) for k, v in maps.items()}
    close(jshade.camera_rays_world(jc)[0], tshade.camera_rays_world(tc)[0])
    jspec, jx = jshade.specular_color_surfel(
        JMips.build(JEnv(base=jnp.asarray(base))), camera=jc,
        **{k: jnp.asarray(v) for k, v in maps.items()},
    )
    with torch.no_grad():
        tspec, tx = tshade.specular_color_surfel(
            TMips.build(TEnv(torch.from_numpy(base))), camera=tc,
            **{k: torch.from_numpy(v) for k, v in maps.items()},
        )
    close(jspec, tspec)
    for k in ("direct_light", "specular_weight"):
        close(jx[k], tx[k])
