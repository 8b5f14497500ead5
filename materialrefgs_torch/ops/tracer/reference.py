"""Dense reference splat tracer (materialrefgs_tpu/ops/tracer/reference.py),
a test oracle only.

Every ray against every surfel, composited front to back in each ray's exact
hit-t order over the whole list, with the tracer's alpha law (3-sigma cutoff,
alpha_min 1/255, T-stop 1e-4). It is NOT the forward kernel's plain version
(that is trace_fwd.trace_bundles_fwd_plain): the kernel sorts each ray's hits
within 128-pair chunks of the bundle's depth-sorted list, so the two differ
where splats swap order across a chunk boundary. O(N_rays * P) memory.
"""
from __future__ import annotations

import torch

from materialrefgs_torch.utils import sh as sh_utils
from materialrefgs_torch.utils.transforms import quat_to_rotmat

T_STOP = 1e-4
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
RHO_CUTOFF = 9.0  # 3 sigma


def trace_reference(
    rays_o: torch.Tensor,  # (N, 3)
    rays_d: torch.Tensor,  # (N, 3) need not be unit
    means3d: torch.Tensor,  # (P, 3)
    scales: torch.Tensor,  # (P, 2)
    rotations: torch.Tensor,  # (P, 4)
    opacities: torch.Tensor,  # (P,)
    colors: torch.Tensor | None,  # (P, 3) fixed per-gaussian colors, or None
    tmin: float = 1e-3,
    shs: torch.Tensor | None = None,  # (P, K_sh, 3): per-ray SH colors instead
    sh_degree: int = 3,
) -> dict:
    """Returns per-ray rgb (N,3), acc (N,), depth (N,), normal (N,3), final_T (N,)."""
    if shs is not None:
        n_sh = (sh_degree + 1) ** 2
        d_unit = rays_d / torch.clamp(torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True), min=1e-12)
        colors = sh_utils.sh_to_rgb(
            sh_degree, shs[None, :, :n_sh, :].transpose(2, 3), d_unit[:, None, :]
        )  # (N, P, 3)
    R = quat_to_rotmat(rotations)
    tu = R[:, :, 0] / torch.clamp(scales[:, 0:1], min=1e-12)
    tv = R[:, :, 1] / torch.clamp(scales[:, 1:2], min=1e-12)
    n = R[:, :, 2]

    denom = torch.einsum("nd,pd->np", rays_d, n)
    denom_ok = torch.abs(denom) > 1e-9
    denom_s = torch.where(denom_ok, denom, torch.ones_like(denom))
    po = means3d[None, :, :] - rays_o[:, None, :]
    t = torch.einsum("npd,pd->np", po, n) / denom_s
    q = rays_o[:, None, :] + t[..., None] * rays_d[:, None, :] - means3d[None, :, :]
    u = torch.einsum("npd,pd->np", q, tu)
    v = torch.einsum("npd,pd->np", q, tv)
    rho = u * u + v * v

    alpha = torch.clamp(opacities[None, :] * torch.exp(-0.5 * rho), max=ALPHA_MAX)
    ok = denom_ok & (t >= tmin) & (rho <= RHO_CUTOFF) & (alpha >= ALPHA_MIN)
    zero = torch.zeros((), device=t.device)
    a = torch.where(ok, alpha, zero)

    order = torch.sort(torch.where(ok, t, torch.full_like(t, float("inf"))), dim=1, stable=True).indices
    a_s = torch.gather(a, 1, order)
    t_s = torch.gather(torch.where(ok, t, zero), 1, order)
    one_m = 1.0 - a_s
    T_incl = torch.cumprod(one_m, dim=1)
    T_before = torch.cat([torch.ones_like(T_incl[:, :1]), T_incl[:, :-1]], dim=1)
    included = (T_before * one_m) >= T_STOP
    w = a_s * T_before * included

    if colors.dim() == 2:
        colors = colors[None].expand(rays_o.shape[0], -1, -1)
    cols_s = torch.gather(colors, 1, order[..., None].expand(-1, -1, 3))
    n_eff = torch.where(denom[..., None] > 0, -n[None], n[None])
    n_s = torch.gather(n_eff, 1, order[..., None].expand(-1, -1, 3))
    return {
        "rgb": torch.einsum("np,npc->nc", w, cols_s),
        "acc": torch.sum(w, dim=1),
        "depth": torch.sum(w * t_s, dim=1),
        "normal": torch.einsum("np,npc->nc", w, n_s),
        "final_T": torch.prod(torch.where(included, one_m, torch.ones_like(one_m)), dim=1),
    }
