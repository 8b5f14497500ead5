"""Gaussian surfel parameter store (reference scene/gaussian_model.py).

Fixed-capacity design with an `alive` mask, slot for slot the same as the JAX
package's model: every per-gaussian tensor is (CAP, ...), dead slots have
alive=False (and raw opacity -15) so the rasterizer culls them. Raw
parameters are `nn.Parameter`s; `alive`, `active_sh_degree` and the
densification statistics are buffers. Densify/prune and the resets write the
same slots as the JAX package's functions; where those return a new model,
the port updates the parameters in place (under no_grad), which keeps the
optimizer's references valid and spares a copy of every tensor.

Activations (gaussian_model.py:47-77): exp scaling, sigmoid for opacity /
refl (metallic) / metalness (EnvGS blend) / roughness / colors, normalized
quaternions.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from perfbench.reference.plain import resolve_device
from perfbench.reference.plain.ops.knn import mean_knn_dist2
from perfbench.reference.plain.utils import sh as sh_utils
from perfbench.reference.plain.utils.transforms import inverse_sigmoid, quat_to_rotmat

INIT_REFL = 0.1
INIT_ROUGHNESS = 0.1
INIT_METALNESS = 0.1
INIT_OPACITY = 0.1

# Raw parameter names and their trailing shapes; K = (max_sh_degree + 1)^2.
PARAM_SHAPES = {
    "xyz": lambda K: (3,),
    "scaling": lambda K: (2,),
    "rotation": lambda K: (4,),
    "opacity": lambda K: (1,),
    "refl_strength": lambda K: (1,),
    "metalness": lambda K: (1,),
    "roughness": lambda K: (1,),
    "ori_color": lambda K: (3,),
    "diffuse_color": lambda K: (3,),
    "features_dc": lambda K: (1, 3),
    "features_rest": lambda K: (K - 1, 3),
    "indirect_dc": lambda K: (1, 3),
    "indirect_rest": lambda K: (K - 1, 3),
    "indirect_asg": lambda K: (32, 5),
    "normal1": lambda K: (3,),
    "normal2": lambda K: (3,),
}


class GaussianModel(nn.Module):
    """Raw (pre-activation) per-gaussian parameters, leading dim CAP."""

    xyz: nn.Parameter
    scaling: nn.Parameter
    rotation: nn.Parameter
    opacity: nn.Parameter
    refl_strength: nn.Parameter
    metalness: nn.Parameter
    roughness: nn.Parameter
    ori_color: nn.Parameter
    diffuse_color: nn.Parameter
    features_dc: nn.Parameter
    features_rest: nn.Parameter
    indirect_dc: nn.Parameter
    indirect_rest: nn.Parameter
    indirect_asg: nn.Parameter
    normal1: nn.Parameter
    normal2: nn.Parameter

    def __init__(
        self,
        capacity: int,
        max_sh_degree: int = 3,
        device: str | torch.device | None = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.capacity = int(capacity)
        self.max_sh_degree = int(max_sh_degree)
        K = (max_sh_degree + 1) ** 2
        for name, shape in PARAM_SHAPES.items():
            t = torch.zeros((self.capacity,) + shape(K), dtype=torch.float32, device=dev)
            self.register_parameter(name, nn.Parameter(t))
        with torch.no_grad():
            self.scaling.fill_(-10.0)
            self.opacity.fill_(-15.0)
            self.rotation[:, 0] = 1.0
        self.register_buffer("alive", torch.zeros(self.capacity, dtype=torch.bool, device=dev))
        self.register_buffer("active_sh_degree", torch.zeros((), dtype=torch.int32, device=dev))
        for name in ("max_radii2d", "xyz_gradient_accum", "denom"):
            self.register_buffer(name, torch.zeros(self.capacity, dtype=torch.float32, device=dev))

    @classmethod
    def from_arrays(
        cls,
        arrays: dict[str, np.ndarray],
        alive: np.ndarray,
        active_sh_degree: int,
        max_sh_degree: int = 3,
        device: str | torch.device | None = None,
    ) -> "GaussianModel":
        """Model whose raw parameters are the given (CAP, ...) arrays, one per
        name of PARAM_SHAPES."""
        alive = np.array(alive, bool)  # writable copies for torch.from_numpy
        model = cls(alive.shape[0], max_sh_degree, device)
        K = (max_sh_degree + 1) ** 2
        with torch.no_grad():
            for name, shape in PARAM_SHAPES.items():
                a = np.array(arrays[name], np.float32)
                want = (model.capacity,) + shape(K)
                if a.shape != want:
                    raise ValueError(f"{name}: shape {a.shape}, expected {want}")
                getattr(model, name).copy_(torch.from_numpy(a))
            model.alive.copy_(torch.from_numpy(alive))
            model.active_sh_degree.fill_(int(active_sh_degree))
        return model

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    # ---------- activations ----------
    @property
    def get_xyz(self):
        return self.xyz

    @property
    def get_scaling(self):
        return torch.exp(self.scaling)

    @property
    def get_rotation(self):
        q = self.rotation
        return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-12)

    @property
    def get_opacity(self):
        return torch.sigmoid(self.opacity) * self.alive[:, None]

    @property
    def get_refl(self):
        return torch.sigmoid(self.refl_strength)

    @property
    def get_specular(self):
        """EnvGS blend weight (reference get_specular, gaussian_model.py:310)."""
        return torch.sigmoid(self.metalness)

    @property
    def get_rough(self):
        return torch.sigmoid(self.roughness)

    @property
    def get_ori_color(self):
        return torch.sigmoid(self.ori_color)

    @property
    def get_diffuse_color(self):
        return torch.sigmoid(self.diffuse_color)

    @property
    def n_alive(self):
        return torch.sum(self.alive.to(torch.int32))

    def get_features(self):
        """(CAP, K, 3) SH coefficients with inactive degree bands zeroed."""
        feats = torch.cat([self.features_dc, self.features_rest], dim=1)
        return self._mask_sh(feats)

    def get_indirect(self):
        # Indirect SH always evaluates at full degree.
        return torch.cat([self.indirect_dc, self.indirect_rest], dim=1)

    def _mask_sh(self, feats):
        K = feats.shape[1]
        band = torch.floor(torch.sqrt(torch.arange(K, dtype=torch.float32))).to(torch.int32)
        mask = (band.to(feats.device) <= self.active_sh_degree).to(feats.dtype)
        return feats * mask[None, :, None]

    def get_colors(self, campos: torch.Tensor) -> torch.Tensor:
        """SH -> clamped RGB toward the camera (forward.cu computeColorFromSH)."""
        dirs = self.xyz - campos[None, :]
        feats = self.get_features().transpose(1, 2)  # (CAP, 3, K)
        return sh_utils.sh_to_rgb(self.max_sh_degree, feats, dirs)

    def get_world_normal(self) -> torch.Tensor:
        """Splat normal in world space (3rd column of R)."""
        R = quat_to_rotmat(self.get_rotation)
        return R[..., :, 2]

    @torch.no_grad()
    def oneup_sh_degree(self) -> None:
        self.active_sh_degree.copy_(torch.clamp(self.active_sh_degree + 1, max=self.max_sh_degree))


def create_from_points(
    points: np.ndarray,
    colors: np.ndarray,
    capacity: int,
    max_sh_degree: int = 3,
    rng: np.random.Generator | None = None,
    init_refl: float = INIT_REFL,
    init_roughness: float = INIT_ROUGHNESS,
    device: str | torch.device | None = None,
) -> GaussianModel:
    """create_from_pcd (gaussian_model.py:355-433) with fixed capacity. The
    generator is drawn from in the JAX package's order (rotations, albedo,
    diffuse color), so one seed gives the same model in both packages."""
    rng = rng or np.random.default_rng(3407)
    P = points.shape[0]
    if P > capacity:
        raise ValueError(f"{P} points exceed capacity {capacity}")
    K = (max_sh_degree + 1) ** 2

    def padded(x, fill=0.0):
        out = np.full((capacity,) + x.shape[1:], fill, np.float32)
        out[:P] = x
        return out

    d2 = mean_knn_dist2(torch.as_tensor(np.asarray(points, np.float32))).numpy()
    d2 = np.maximum(d2, 1e-7)
    scales = np.log(np.sqrt(d2))[:, None].repeat(2, axis=1)
    rots = rng.random((P, 4)).astype(np.float32)

    def inv_sig(v):
        return float(np.log(v / (1 - v)))

    f_dc = sh_utils.rgb_to_sh(torch.as_tensor(np.asarray(colors, np.float32))).numpy()
    ori = np.clip(0.5 + (rng.random((P, 3)).astype(np.float32) - 0.5) * 0.05, 0.0, 1.0)
    dif = np.clip(0.5 + (rng.random((P, 3)).astype(np.float32) - 0.5) * 0.05, 0.0, 1.0)

    rotation = padded(rots)
    rotation[P:, 0] = 1.0
    arrays = {
        "xyz": padded(np.asarray(points, np.float32)),
        "scaling": padded(scales.astype(np.float32), fill=-10.0),
        "rotation": rotation,
        "opacity": padded(np.full((P, 1), inv_sig(INIT_OPACITY), np.float32), fill=-15.0),
        "refl_strength": padded(np.full((P, 1), inv_sig(init_refl), np.float32)),
        "metalness": padded(np.full((P, 1), inv_sig(INIT_METALNESS), np.float32)),
        "roughness": padded(np.full((P, 1), inv_sig(init_roughness), np.float32)),
        "ori_color": padded(np.asarray(np.log(ori / (1 - ori)), np.float32)),
        "diffuse_color": padded(np.asarray(np.log(dif / (1 - dif)), np.float32)),
        "features_dc": padded(f_dc.astype(np.float32)[:, None, :]),
        "features_rest": padded(np.zeros((P, K - 1, 3), np.float32)),
        "indirect_dc": padded(np.zeros((P, 1, 3), np.float32)),
        "indirect_rest": padded(np.zeros((P, K - 1, 3), np.float32)),
        "indirect_asg": padded(np.zeros((P, 32, 5), np.float32)),
        "normal1": padded(np.zeros((P, 3), np.float32)),
        "normal2": padded(np.zeros((P, 3), np.float32)),
    }
    return GaussianModel.from_arrays(arrays, np.arange(capacity) < P, 0, max_sh_degree, device)


# ---------------------------------------------------------------- densify ----


@torch.no_grad()
def add_densification_stats(
    model: GaussianModel,
    mean2d_grad: torch.Tensor,
    radii: torch.Tensor,
    ndc_scale: tuple[float, float] = (1.0, 1.0),
    group=None,
) -> None:
    """gaussian_model.py:1059-1062: accumulate view-space gradient norms
    where the gaussian was visible (radii > 0).

    ndc_scale: (0.5*W, 0.5*H). The rasterizer's mean2D gradients are in pixel
    units; the reference scales them to NDC units (backward.cu:260-261)
    before densify_grad_threshold=2e-4 applies, and so does this.

    group (data parallelism, JAX gaussian_model.py:264-272): each rank gives
    its own view's norms; the norms and the counts are summed over the
    ranks, as that many sequential views would add them (the norm of the
    averaged gradient would cancel opposing views), and max_radii2d takes
    the largest over the ranks."""
    upd = (radii > 0) & model.alive
    g = mean2d_grad * torch.tensor(ndc_scale, dtype=mean2d_grad.dtype, device=mean2d_grad.device)
    gnorm = torch.sqrt(torch.sum(g * g, dim=-1))
    accum = torch.where(upd, gnorm, torch.zeros_like(gnorm))
    denom = upd.to(torch.float32)
    max_r = torch.where(upd, torch.maximum(model.max_radii2d, radii), model.max_radii2d)
    if group is not None:
        import torch.distributed as dist

        both = torch.stack([accum, denom])
        dist.all_reduce(both, group=group)
        accum, denom = both[0], both[1]
        dist.all_reduce(max_r, op=dist.ReduceOp.MAX, group=group)
    model.xyz_gradient_accum.add_(accum)
    model.denom.add_(denom)
    model.max_radii2d.copy_(max_r)


@torch.no_grad()
def env_gs_from(model: GaussianModel) -> GaussianModel:
    """The environment gaussians at the surfel2 onset (the JAX Trainer's
    _init_env_gs, trainer.py:725-738; restore_from_refgs,
    env_gaussian_model3.py:553-589): a deep copy of the main model sharing
    its geometry and SH, with zeroed densification statistics."""
    env = GaussianModel(model.capacity, model.max_sh_degree, model.device)
    env.load_state_dict(model.state_dict())
    env.xyz_gradient_accum.zero_()
    env.denom.zero_()
    env.max_radii2d.zero_()
    return env


@torch.no_grad()
def add_env_stats(env: GaussianModel, xyz_grad: torch.Tensor) -> None:
    """The env model's densification statistics from its xyz gradient
    (trainer.py:473-477 of the JAX package): accum += |grad|, denom +=
    (|grad| > 0)."""
    gnorm = torch.linalg.vector_norm(xyz_grad, dim=-1)
    env.xyz_gradient_accum.add_(gnorm)
    env.denom.add_((gnorm > 0).to(torch.float32))


@torch.no_grad()
def densify_and_prune(
    model: GaussianModel,
    adam,
    generator: torch.Generator | None,
    max_grad: float,
    min_opacity: float,
    extent: float,
    max_screen_size: float | None,
    percent_dense: float = 0.01,
    N: int = 2,
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """Clone + split + prune (gaussian_model.py:1043-1057) on fixed capacity,
    slot for slot as the JAX package: free slots are taken in index order,
    clones first, then N children per split parent (ranked by parent index);
    candidates past the free slots are dropped; split parents die; then
    prune; dead slots get raw opacity -15; the statistics are zeroed and the
    written slots' Adam moments cleared (`adam.zero_rows`, if given).

    The split offsets are N x (CAP, 2) standard normal draws from
    `generator`, or `noise` (N, CAP, 2) when given (tests inject the JAX
    package's draws). Returns the written-slot mask."""
    cap = model.capacity
    dev = model.device
    params = {name: getattr(model, name) for name in PARAM_SHAPES}
    grads = model.xyz_gradient_accum / torch.clamp(model.denom, min=1.0)
    grads = torch.where(model.denom > 0, grads, torch.zeros_like(grads))
    scal = torch.exp(params["scaling"])
    max_scale = torch.amax(scal, dim=-1)

    sel_grad = (grads >= max_grad) & model.alive
    clone_sel = sel_grad & (max_scale <= percent_dense * extent)
    split_sel = sel_grad & (max_scale > percent_dense * extent)

    free = ~model.alive
    free_idx = torch.nonzero(free)[:, 0]  # free slots in index order
    n_free = free_idx.shape[0]

    def take_free(rank):
        ok = rank < n_free
        return free_idx[torch.clamp(rank, 0, max(n_free - 1, 0))] if n_free else rank, ok

    def exclusive_rank(sel):
        s = sel.to(torch.int64)
        return torch.cumsum(s, 0) - s

    new = {name: p.clone() for name, p in params.items()}
    written = torch.zeros(cap, dtype=torch.bool, device=dev)

    clone_dst, clone_ok = take_free(exclusive_rank(clone_sel))
    clone_valid = clone_sel & clone_ok
    for name, p in params.items():
        new[name][clone_dst[clone_valid]] = p[clone_valid]
    written[clone_dst[clone_valid]] = True

    n_clones_total = int(clone_valid.sum())
    split_rank0 = exclusive_rank(split_sel)
    q = params["rotation"]
    R = quat_to_rotmat(q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-12))
    new_scaling = torch.log(torch.clamp(scal / (0.8 * N), min=1e-12))
    for n in range(N):
        if noise is not None:
            z = noise[n].to(dev)
        else:
            z = torch.randn((cap, 2), generator=generator, device=dev)
        noise3 = torch.cat([z * scal, torch.zeros((cap, 1), device=dev)], dim=-1)
        new_xyz = params["xyz"] + torch.einsum("pij,pj->pi", R, noise3)
        dst, ok = take_free(n_clones_total + split_rank0 * N + n)
        valid = split_sel & ok
        for name, p in params.items():
            src = {"xyz": new_xyz, "scaling": new_scaling}.get(name, p)
            new[name][dst[valid]] = src[valid]
        written[dst[valid]] = True

    alive_new = (model.alive | written) & ~split_sel
    prune = torch.sigmoid(new["opacity"][:, 0]) < min_opacity
    if max_screen_size is not None:
        prune = prune | (model.max_radii2d > max_screen_size)
        prune = prune | (torch.amax(torch.exp(new["scaling"]), dim=-1) > 0.1 * extent)
    alive_new = alive_new & ~prune
    new["opacity"] = torch.where(alive_new[:, None], new["opacity"], torch.full_like(new["opacity"], -15.0))

    for name, p in params.items():
        p.copy_(new[name])
    model.alive.copy_(alive_new)
    model.xyz_gradient_accum.zero_()
    model.denom.zero_()
    model.max_radii2d.zero_()
    if adam is not None:
        adam.zero_rows(written)
    return written


# ------------------------------------------------------------------ resets ----


@torch.no_grad()
def reset_opacity0(model: GaussianModel) -> None:
    """gaussian_model.py:530-534: clamp opacity to <= 0.01."""
    new = inverse_sigmoid(torch.clamp(torch.sigmoid(model.opacity), max=0.01))
    model.opacity.copy_(torch.where(model.alive[:, None], new, torch.full_like(new, -15.0)))


@torch.no_grad()
def reset_opacity1(model: GaussianModel, exclusive_msk=None) -> None:
    """gaussian_model.py:536-546: pull opacities up to 0.9 unless already
    above (or excluded)."""
    RESET_V = 0.9
    op = torch.sigmoid(model.opacity)
    keep = (op > RESET_V)[:, 0]
    if exclusive_msk is not None:
        keep = keep | exclusive_msk
    new = torch.where(keep[:, None], model.opacity, inverse_sigmoid(torch.full_like(op, RESET_V)))
    model.opacity.copy_(torch.where(model.alive[:, None], new, torch.full_like(new, -15.0)))


@torch.no_grad()
def reset_refl(model: GaussianModel, exclusive_msk=None, rst_value=None) -> None:
    """gaussian_model.py:558-566: floor refl_strength at the init value."""
    v = INIT_REFL if rst_value is None else rst_value
    new = inverse_sigmoid(torch.clamp(torch.sigmoid(model.refl_strength), min=v))
    if exclusive_msk is not None:
        new = torch.where(exclusive_msk[:, None], model.refl_strength, new)
    model.refl_strength.copy_(new)


@torch.no_grad()
def dist_color(model: GaussianModel, generator: torch.Generator | None = None, exclusive_msk=None,
               noise: torch.Tensor | None = None) -> None:
    """gaussian_model.py:598-610: perturb f_dc of low-refl gaussians by
    U(-0.4, 0.4) noise, (CAP, 1, 3) uniforms from `generator`, or `noise`
    (the uniforms, as tests pass the JAX package's draw)."""
    REFL_MSK_THR = 0.02
    DIST_RANGE = 0.4
    refl_msk = (torch.sigmoid(model.refl_strength) > REFL_MSK_THR)[:, 0]
    if exclusive_msk is not None:
        refl_msk = refl_msk | exclusive_msk
    dcc = model.features_dc
    u = _uniforms(dcc.shape, generator, noise, dcc.device)
    new = torch.where(refl_msk[:, None, None], dcc, dcc + (u * DIST_RANGE * 2 - DIST_RANGE))
    dcc.copy_(new)


def _uniforms(shape, generator, noise, device) -> torch.Tensor:
    if noise is not None:
        return noise.to(device=device, dtype=torch.float32).reshape(shape)
    return torch.rand(shape, generator=generator, device=device)


@torch.no_grad()
def reset_ori_color(model: GaussianModel, generator: torch.Generator | None = None, reset_value=0.5,
                    noise_level=0.05, noise: torch.Tensor | None = None) -> None:
    """gaussian_model.py:699+: re-init albedo around reset_value, with
    (CAP, 3) uniforms from `generator`, or `noise` (the uniforms)."""
    u = _uniforms(model.ori_color.shape, generator, noise, model.ori_color.device)
    v = torch.clamp(reset_value + (u - 0.5) * noise_level, 1e-4, 1 - 1e-4)
    model.ori_color.copy_(inverse_sigmoid(v))


def _logit32(value: float) -> float:
    """log(v / (1 - v)) as the JAX package takes it: the ratio in Python
    floats, the log in float32 (float(jnp.log(...)))."""
    return float(torch.log(torch.tensor(value / (1 - value), dtype=torch.float32)))


@torch.no_grad()
def reset_roughness(model: GaussianModel, value=INIT_ROUGHNESS) -> None:
    model.roughness.fill_(_logit32(value))


@torch.no_grad()
def reset_refl_strength(model: GaussianModel, value=INIT_REFL) -> None:
    model.refl_strength.fill_(_logit32(value))


def enlarge_refl_scales(
    model: GaussianModel,
    enlarge_scale: float = 1.5,
    refl_msk_thr: float = 0.02,
    rough_msk_thr: float = 0.1,
    exclusive_msk=None,
) -> torch.Tensor:
    """gaussian_model.py:624-643: enlarged log-scales for reflective gaussians."""
    refl_msk = (torch.sigmoid(model.refl_strength) < refl_msk_thr)[:, 0]
    rough_msk = (torch.sigmoid(model.roughness) > rough_msk_thr)[:, 0]
    msk = refl_msk | rough_msk
    if exclusive_msk is not None:
        msk = msk | exclusive_msk
    enlarged = model.scaling + float(np.log(enlarge_scale))
    return torch.where(msk[:, None], model.scaling, enlarged)


@torch.no_grad()
def reset_scale(model: GaussianModel, exclusive_msk=None) -> None:
    """gaussian_model.py:663-667."""
    model.scaling.copy_(enlarge_refl_scales(model, exclusive_msk=exclusive_msk))
