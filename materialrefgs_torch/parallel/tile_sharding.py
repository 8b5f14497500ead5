"""Tile-sharded single-camera rasterization over a process group (the JAX
package's parallel/tile_sharding.py).

One camera's 16x16 tile rows are split into equal blocks across the ranks of
a group, and the gaussians are replicated: each rank culls, bins and
rasterizes only its block (ops/rasterize/api._sorted_inputs, `rows=`). The
JAX package moves each block into a local pixel frame (Tv' = Tv - off * Tw,
mean2d_y' = mean2d_y - off) and runs its kernels unchanged; that shift rounds
differently from the whole view's arithmetic, and at 800x800 a few pixels
near the alpha and transmittance thresholds then differ from the unsharded
render by up to 1.4e-3. Here the rects are clipped to the block and the
keep mask and both tile kernels take the block's first tile row (`row0`),
so every pixel keeps the view's own coordinates and arithmetic: a block's
maps are bit for bit the whole view's rows (its contributor indices count
positions in pair lists that the keep mask may cut shorter for clipped
rects).

Differentiation follows the transpose of the JAX package's shard_map: the
replicated inputs pass through `_ReplicatedIn` (forward the identity,
backward the sum of the gradient over the group's ranks), and the blocks are
joined by `_GatherRows` (forward every rank's block in its place, backward
the slice of this rank's rows). torch.distributed.nn.functional.all_gather
would instead reduce-scatter the gradient, which multiplies it by the world
size when every rank computes the same full-image loss. The join is an
all_reduce of a zero-filled full map, which gloo also runs on CUDA tensors.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from materialrefgs_torch.cameras import Camera
from materialrefgs_torch.ops.rasterize.api import RasterizeConfig, _render, _sorted_inputs, _unpack
from materialrefgs_torch.ops.rasterize.layout import TILE


class _ReplicatedIn(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherRows(torch.autograd.Function):
    """(rows_local * grid_x, 256, C) blocks -> the full (grid_y * grid_x, 256,
    C) map on every rank; the backward returns this rank's slice."""

    @staticmethod
    def forward(ctx, block, group):
        rank, world = dist.get_rank(group), dist.get_world_size(group)
        n = block.shape[0]
        full = block.new_zeros((n * world,) + tuple(block.shape[1:]))
        full[rank * n : (rank + 1) * n] = block
        dist.all_reduce(full, group=group)
        ctx.rows = (rank * n, (rank + 1) * n)
        return full

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.rows
        return g[a:b].contiguous(), None


def _tile_local_render(means3d, scales, rotations, opacities, colors, features, camera: Camera,
                       scale_modifier: float, config: RasterizeConfig, row0: int, rows_local: int):
    """Cull, bin and rasterize the tile rows [row0, row0 + rows_local) of
    `camera` (JAX tile_sharding.py:82-145): ((rows_local * grid_x, 256,
    C_OUT) tile outputs, the binning overflow). `config.pair_capacity` is
    this block's pair budget."""
    si = _sorted_inputs(means3d, scales, rotations, opacities, colors, features, camera,
                        scale_modifier, config, rows=(row0, rows_local))
    return _render(si), si.bins.overflow


def _grid(camera: Camera, world: int) -> tuple[int, int, int]:
    grid_x = (camera.width + TILE - 1) // TILE
    grid_y = (camera.height + TILE - 1) // TILE
    if grid_y % world:
        raise ValueError(f"grid_y {grid_y} must divide by the group's {world} ranks")
    return grid_x, grid_y, grid_y // world


def rasterize_tile_sharded(
    group,
    means3d: torch.Tensor,
    scales: torch.Tensor,
    rotations: torch.Tensor,
    opacities: torch.Tensor,
    colors: torch.Tensor,
    features: torch.Tensor,
    camera: Camera,
    bg_color: torch.Tensor,
    scale_modifier: float = 1.0,
    config: RasterizeConfig = RasterizeConfig(),
) -> dict:
    """Differentiable tile-sharded rasterization: every rank of `group`
    (None: the default group) renders its block of tile rows and gets the
    same map dict as api.rasterize (without the per-gaussian entries), with
    'overflow' summed over the blocks. `config.pair_capacity` is the
    per-rank pair budget."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    grid_x, grid_y, rows_local = _grid(camera, world)
    args = [_ReplicatedIn.apply(a, group) for a in (means3d, scales, rotations, opacities, colors, features)]
    block, overflow = _tile_local_render(*args, camera, scale_modifier, config, rank * rows_local, rows_local)
    tiles = _GatherRows.apply(block, group)
    out = _unpack(tiles, features.shape[-1], grid_x, grid_y, camera.width, camera.height, bg_color)
    overflow = overflow.detach().to(torch.int64).reshape(1).clone()
    dist.all_reduce(overflow, group=group)
    out["overflow"] = overflow[0]
    return out


def dp_tp_groups(n_dp: int, n_tp: int):
    """(dp_group, tp_group) of this rank on an (n_dp, n_tp) grid of the
    default group's ranks, rank = d * n_tp + t: the tp group holds one
    camera's ranks (same d), the dp group the ranks of one tile block (same
    t). Every rank must call it, in the same order, as new_group requires."""
    if dist.get_world_size() != n_dp * n_tp:
        raise ValueError(f"a {n_dp} x {n_tp} grid needs {n_dp * n_tp} ranks, not {dist.get_world_size()}")
    rank = dist.get_rank()
    dp_group = tp_group = None
    for t in range(n_tp):
        g = dist.new_group([d * n_tp + t for d in range(n_dp)])
        if rank % n_tp == t:
            dp_group = g
    for d in range(n_dp):
        g = dist.new_group([d * n_tp + t for t in range(n_tp)])
        if rank // n_tp == d:
            tp_group = g
    return dp_group, tp_group


def dp_tp_render_grads(
    dp_group,
    tp_group,
    means3d, scales, rotations, opacities, colors, features,
    camera: Camera,
    gt: torch.Tensor,
    config: RasterizeConfig = RasterizeConfig(),
):
    """DP x TP (JAX dp_tp_render_grads): this rank renders its tile block
    (its index in `tp_group`) of its own camera (one per dp index) and scores
    it against the same rows of `gt` (H, W, 3). Returns (loss, grads) on
    every rank: loss = sum over every camera and block of the squared error /
    (n_dp * H * W), grads its gradient for (means3d, scales, rotations,
    opacities, colors, features), summed over the whole grid."""
    n_dp = dist.get_world_size(dp_group)
    t = dist.get_rank(tp_group)
    H, W = camera.height, camera.width
    grid_x, grid_y, rows_local = _grid(camera, dist.get_world_size(tp_group))
    denom = float(n_dp * H * W)
    # Pad GT to the tile grid so the last block's rows line up (JAX :162-176).
    if grid_y * TILE != H:
        gt = torch.cat([gt, gt.new_zeros((grid_y * TILE - H,) + tuple(gt.shape[1:]))], dim=0)
    inputs = [a.detach().requires_grad_(True) for a in (means3d, scales, rotations, opacities, colors, features)]
    block, _ = _tile_local_render(*inputs, camera, 1.0, config, t * rows_local, rows_local)
    blk = _unpack(block, features.shape[-1], grid_x, rows_local, W, rows_local * TILE,
                  torch.zeros(3, device=gt.device))
    r0 = t * rows_local * TILE
    gt_blk = gt[r0 : r0 + rows_local * TILE]
    # Rows past H (an image height that is not a multiple of 16) are padding.
    m = (torch.arange(r0, r0 + rows_local * TILE, device=gt.device) < H).to(gt.dtype)[:, None, None]
    local = torch.sum(m * (blk["render"] - gt_blk) ** 2)
    grads = torch.autograd.grad(local / denom, inputs, allow_unused=True)
    grads = [g if g is not None else torch.zeros_like(a) for g, a in zip(grads, inputs)]
    flat = torch.cat([local.detach().reshape(1)] + [g.reshape(-1) for g in grads])
    for group in (tp_group, dp_group):
        dist.all_reduce(flat, group=group)
    out, pos = [], 1
    for a in inputs:
        out.append(flat[pos : pos + a.numel()].view_as(a))
        pos += a.numel()
    return flat[0] / denom, tuple(out)
