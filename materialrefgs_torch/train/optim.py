"""Adam as the JAX package trains with it (trainer.py:87-89, 426-437):
optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-15) followed by p - lr * u with
a learning rate per parameter.

Unlike torch.optim.Adam, one step count is shared by every parameter (as
optax keeps one `count` for the whole tree), and a parameter without a
gradient is updated with a zero gradient (its moments decay) instead of being
skipped, so the bias corrections stay in step with the JAX package's. The
update is in place, with torch's foreach kernels.
"""
from __future__ import annotations

import torch


class Adam:
    def __init__(self, params: dict[str, torch.Tensor], b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-15):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.names = list(params)
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor | None],
             lrs: dict[str, float]) -> None:
        """One update of every parameter in place: p <- p - lr * u."""
        names = self.names
        g = [grads[k] if grads.get(k) is not None else torch.zeros_like(params[k]) for k in names]
        mu = [self.mu[k] for k in names]
        nu = [self.nu[k] for k in names]
        # mu = (1 - b1) * g + b1 * mu;  nu = (1 - b2) * g^2 + b2 * nu
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1 - self.b1))
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), 1 - self.b2))
        self.count += 1
        f32 = torch.float32
        bc1 = float(1 - torch.tensor(self.b1, dtype=f32) ** self.count)
        bc2 = float(1 - torch.tensor(self.b2, dtype=f32) ** self.count)
        # u = (mu / bc1) / (sqrt(nu / bc2) + eps)
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        u = torch._foreach_div(mu, bc1)
        torch._foreach_div_(u, denom)
        for k, uk in zip(names, u):
            lr = lrs[k]
            if lr != 0.0:
                params[k].sub_(lr * uk)

    @torch.no_grad()
    def zero_rows(self, row_mask: torch.Tensor) -> None:
        """Clear the moments of newly written gaussians in every per-gaussian
        parameter (cat_tensors_to_optimizer semantics)."""
        n = row_mask.shape[0]
        for k in self.names:
            for m in (self.mu[k], self.nu[k]):
                if m.dim() >= 1 and m.shape[0] == n:
                    m[row_mask] = 0.0

    @torch.no_grad()
    def zero_param(self, name: str) -> None:
        """Whole-tensor moment reset for one parameter
        (replace_tensor_to_optimizer semantics)."""
        self.mu[name].zero_()
        self.nu[name].zero_()
