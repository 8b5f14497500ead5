"""The port's reflection-score mining (materialrefgs_torch/train/ref_score.py
and Trainer.mine_ref_scores) against the JAX package's, on inputs made from a
numpy seed: the wide neighbour graph, the score maps of compute_ref_scores,
and the masks the Trainers install from their own renders."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from materialrefgs_tpu import config as jcfg  # noqa: E402
from materialrefgs_tpu.ops.rasterize.api import RasterizeConfig as JRaster  # noqa: E402
from materialrefgs_tpu.train import ref_score as jrs  # noqa: E402
from materialrefgs_tpu.train import trainer as jtr  # noqa: E402

from materialrefgs_torch import config as tcfg  # noqa: E402
from materialrefgs_torch.ops.rasterize.api import RasterizeConfig as TRaster  # noqa: E402
from materialrefgs_torch.train import ref_score as trs  # noqa: E402
from materialrefgs_torch.train import trainer as ttr  # noqa: E402
from test_torch_train import jax_model, to_torch_model  # noqa: E402
from test_torch_warp import H, W, cameras, ring_eyes, smooth_field, sphere_maps  # noqa: E402


def test_neighbor_graph_wide_matches_jax():
    """A ring with uneven spacing, so that the angle and distance windows
    (5-90 deg, 0.1-1.5) and the lexsort order all cut somewhere."""
    rng = np.random.default_rng(0)
    angles = np.cumsum(rng.uniform(1.0, 25.0, size=14))
    eyes = [np.array([3.0 * np.sin(np.deg2rad(a)), 0.3, -3.0 * np.cos(np.deg2rad(a))]) for a in angles]
    jcs, tcs = cameras(eyes)
    jR = [np.asarray(c.world_view[:3, :3]) for c in jcs]
    tR = [c.world_view[:3, :3].numpy() for c in tcs]
    for kw in ({}, dict(num=3, max_dis=1.0)):
        want = [[int(j) for j in row] for row in jrs.neighbor_graph_wide(jcs, jR, **kw)]
        got = trs.neighbor_graph_wide(tcs, tR, **kw)
        assert got == want
        assert 0 < sum(map(len, got)) < len(got) * (len(got) - 1)


def test_compute_ref_scores_matches_jax():
    """Three views of a sphere with their own colours: every pixel the
    neighbours see scores its mean absolute patch difference."""
    rng = np.random.default_rng(1)
    jcs, tcs = cameras(ring_eyes(3, step_deg=9.0))
    maps = [sphere_maps(c, rng) for c in tcs]
    images = [smooth_field(rng, 3) for _ in tcs]
    nbrs = [[1, 2], [0, 2], [1]]
    for ps in (2, 4):
        want = jrs.compute_ref_scores(jcs, images, [m[0] for m in maps], [m[1] for m in maps],
                                      [m[2] for m in maps], nbrs, pixel_noise_th=1.0, patch_size=ps)
        got = trs.compute_ref_scores(tcs, [torch.from_numpy(i) for i in images],
                                     [torch.from_numpy(m[0]) for m in maps], [torch.from_numpy(m[1]) for m in maps],
                                     [torch.from_numpy(m[2]) for m in maps], nbrs, pixel_noise_th=1.0, patch_size=ps)
        for v, (g, w) in enumerate(zip(got, want)):
            w = np.asarray(w)
            assert (w > 0).sum() > 100, (v, (w > 0).sum())
            np.testing.assert_array_equal(g > 0, w > 0, err_msg=f"view {v}")
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=f"view {v}")


def test_trainer_mine_ref_scores_matches_jax():
    """Trainer.mine_ref_scores in both packages on one model: each renders
    its own depth, normal and distance maps, then the neighbours, the scores
    and the installed masks (each score map over its 98th percentile,
    > 0.5), which must agree exactly. The scores inherit the rasterizer's
    rounding (its forward parity tolerance, atol 3e-4 / rtol 1e-3: here the
    maps differ by up to 1.2e-4, the scores by up to 3.1e-5), so they are
    held to that tolerance; test_compute_ref_scores_matches_jax holds the
    scoring itself to rtol 1e-5 on shared maps."""
    jm = jax_model(2, sh_degree=1)
    eyes = [np.array([3.2 * np.sin(a), 0.4, -3.2 * np.cos(a)]) for a in np.deg2rad([0.0, 7.0, 14.0, 21.0])]
    jcs, tcs = cameras(eyes)
    rng = np.random.default_rng(3)
    images = [smooth_field(rng, 3) for _ in eyes]
    _, pipe, opt = jcfg.preset_refnerf()
    jt = jtr.Trainer(jm, jcs, images, opt, pipe, raster_cfg=JRaster(pair_capacity=1 << 14, interpret=True),
                     envmap_res=16)
    tt = ttr.Trainer(to_torch_model(jm), tcs, images, tcfg.OptimizationParams(**dataclasses.asdict(opt)),
                     tcfg.PipelineParams(**dataclasses.asdict(pipe)), raster_cfg=TRaster(pair_capacity=1 << 14),
                     envmap_res=16)
    jscores, jmasks = jt.mine_ref_scores()
    tscores, tmasks = tt.mine_ref_scores()
    assert len(tt.ref_score_masks) == len(eyes) and tt.ref_score_log and tt.ref_score_log[0][1] > 0
    for v, (ts, js, tm, jmask) in enumerate(zip(tscores, jscores, tmasks, jmasks)):
        js = np.asarray(js)
        assert (js > 0).sum() > 50, (v, (js > 0).sum())
        np.testing.assert_allclose(ts, js, rtol=1e-3, atol=3e-4, err_msg=f"view {v}")
        np.testing.assert_array_equal(tm, np.asarray(jmask), err_msg=f"view {v}")
        np.testing.assert_array_equal(tt.ref_score_masks[v].numpy(), np.asarray(jt.ref_score_masks[v]))
        assert 0 < tm.sum() < tm.size
