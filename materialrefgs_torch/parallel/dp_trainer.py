"""Curriculum training over camera-batch data parallelism (the JAX package's
parallel/dp_trainer.py).

Every rank runs the single-process Trainer's host orchestration from the
same seed on the same replicated state: densify/prune, the resets, the SH
ladder, mesh extraction, env-GS upkeep and budget escalation run on every
rank on the same values with the same generator. Each iteration draws one
view per rank; rank r renders view r through the data-parallel production
step (parallel/data_parallel.py), whose gradient all_reduce keeps the
parameters equal. One iteration advances the curriculum by one (schedules,
learning rates and cadences keyed to it) while averaging the gradient over
world_size views. At world size 1 it draws what the Trainer draws and
reproduces its trajectory (an all_reduce over one rank is the identity).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from materialrefgs_torch.parallel.data_parallel import make_dp_production_step
from materialrefgs_torch.train.trainer import Trainer


class DPTrainer(Trainer):
    """Trainer whose step spans the ranks of `group` (None: the default
    group), one camera per rank. Only rank 0 writes the mesh PLYs and the
    visualisations; the caller writes the rest on rank 0 alone."""

    def __init__(self, *args, group=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.group = dist.group.WORLD if group is None else group
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        if self.rank != 0:
            self.mesh_dir = None
            self.vis_dir = None

    def _step_fn(self, stage: str, warp_on: bool = False):
        key = (stage, warp_on)
        if key not in self._steps:
            self._steps[key] = make_dp_production_step(
                self.group, stage, self.opt, self.pipe, self.spatial_lr_scale, self.raster_cfg,
                env_min_roughness=self.envmap_min_roughness,
                env_max_roughness=self.envmap_max_roughness,
                tracer_cfg=self.tracer_cfg,
                with_warp=warp_on,
                lpips_weights=self.lpips_weights,
                detect_anomaly=self.detect_anomaly,
            )
        return self._steps[key]

    def _agree(self, counts: dict) -> dict:
        """The largest of each drop count over the ranks: every rank then
        escalates the same budget and redoes its render together, or none
        does (a rank redoing alone would leave the next gradient all_reduce
        unmatched)."""
        keys = list(counts)
        v = torch.tensor([counts[k] for k in keys], dtype=torch.int64, device=self.state.model.device)
        dist.all_reduce(v, op=dist.ReduceOp.MAX, group=self.group)
        return dict(zip(keys, v.tolist()))

    def _run_step(self, iteration: int, stage: str) -> dict:
        # Every rank draws every rank's view and its warp in order, so the
        # rng and the generator stay in step; each keeps its own view's.
        cam_ids = [self._pick_view() for _ in range(self.world)]
        gate = self._warp_gate(iteration, stage)
        views = []
        for cid in cam_ids:
            extra, warp_on, near_id = self._view_extra(iteration, stage, cid)
            if gate and not warp_on:
                # The warp is batch-uniform once the gate is open (JAX
                # dp_trainer.py:63-77): a view without a neighbour warps onto
                # itself with photo weight 0 (an identity homography).
                cam = self.cameras[cid]
                uniforms = torch.rand(cam.height * cam.width, generator=self.generator, device=cam.device)
                extra.update(nearest_camera=cam, nearest_gt=self.images[cid], warp_photo_weight=0.0,
                             warp_uniforms=uniforms)
                warp_on = True
            views.append((cid, extra, warp_on, near_id))
        cid, extra, warp_on, near_id = views[self.rank]
        self._last_cam_id = cam_ids[0]
        metrics = self._render_and_update(iteration, stage, cid, extra, warp_on, near_id)
        metrics["dp_cam"] = cid
        return metrics
