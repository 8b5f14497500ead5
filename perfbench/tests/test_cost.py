"""The work counts are exact on a hand-built scene: six surfels stacked in
front of a 16x16 camera, each covering every pixel with alpha about 0.89.
Transmittance after k of them is about 0.11^k, so each pixel (and each
traced ray) composites exactly four before its transmittance falls under
1e-4: 4 x 256 contributing hits."""
import math

import numpy as np
import pytest
import torch

from perfbench import cost
from perfbench.reference.plain import cameras
from perfbench.reference.plain.ops.rasterize import api as rapi
from perfbench.reference.plain.ops.rasterize import tiles_fwd
from perfbench.reference.plain.ops.tracer import api as tapi
from perfbench.reference.plain.ops.tracer import trace_fwd

P, OPACITY, HITS = 6, 0.89, 4 * 256


def stack():
    means = torch.tensor([[0.0, 0.0, 2.0 + i] for i in range(P)])
    scales = torch.full((P, 2), 50.0)
    rots = torch.tensor([[1.0, 0.0, 0.0, 0.0]] * P)
    opac = torch.full((P,), OPACITY)
    return means, scales, rots, opac


def test_rasterizer_hits_exact():
    means, scales, rots, opac = stack()
    cam = cameras.make_camera(np.eye(3), np.zeros(3), math.radians(60), math.radians(60), 16, 16, device="cpu")
    tiles_fwd.WORK = {}
    try:
        rapi.rasterize(means, scales, rots, opac, torch.rand(P, 3), torch.rand(P, 1), cam, torch.zeros(3),
                       config=rapi.RasterizeConfig(pair_capacity=1 << 12))
        (rec,) = tiles_fwd.WORK["launches"]
    finally:
        tiles_fwd.WORK = None
    assert rec["hits3d"] + rec["hits2d"] == HITS
    assert (rec["S"], rec["W"], rec["H"]) == (1, 16, 16)
    lc = cost.raster_launch(1, rec["hits3d"], rec["hits2d"], P, 16, 16)
    assert lc["fwd_flops"] == cost.HIT_TEST_FLOPS * HITS
    acc = 1 + 6
    assert lc["bwd_flops"] == (42 * HITS + (54 + 3 * acc + 54 + 10 + acc) * rec["hits3d"]
                               + (54 + 3 * acc + 7 + 4 + acc) * rec["hits2d"])
    assert lc["fwd_bytes"] == 4 * (P * (12 + 1 + 6) + 256 * (1 + 6 + 8))


def test_tracer_contribs_exact():
    means, scales, rots, opac = stack()
    g = torch.linspace(-0.2, 0.2, 16)
    d = torch.stack([g[None, :].expand(16, 16), g[:, None].expand(16, 16), torch.ones(16, 16)], -1).reshape(-1, 3)
    trace_fwd.WORK = {}
    try:
        out = tapi.trace(torch.zeros(256, 3), d / d.norm(dim=-1, keepdim=True), means, scales, rots, opac,
                         torch.zeros(P, 16, 3), tapi.TracerConfig(pair_capacity=1 << 14, cluster_pair_capacity=1 << 9),
                         sh_degree=3)
        (rec,) = trace_fwd.WORK["launches"]
    finally:
        trace_fwd.WORK = None
    assert int(out["overflow"]) == 0
    assert rec["contribs"] == HITS and rec["NB"] == 1 and rec["n_sh"] == 16
    lc = cost.trace_launch(16, rec["contribs"], P, 256)
    assert lc["fwd_flops"] == (45 + 3 + 2 + 3 * 33 + 6 + 2 + 8 + 4) * HITS
    assert lc["bwd_flops"] == (45 + 3 * 33 + 14 + 12 + 90 + 9 * 16 + 13 + 3 * 16) * HITS


@pytest.mark.parametrize("flops,n_bytes,expect", [(67e12, 0.0, 1.0), (0.0, 3.35e12, 1.0), (67e9, 6.7e9, 2e-3)])
def test_bound_is_the_larger_side(flops, n_bytes, expect):
    assert cost.bound_s(flops, n_bytes) == pytest.approx(expect)
