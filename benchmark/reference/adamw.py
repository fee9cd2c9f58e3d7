"""Per-tensor gradient clipping and AdamW with optax's numerics.

``optax.chain(clip_by_per_tensor_norm(max_norm), adamw(lr, b1, b2, eps,
weight_decay))`` written out over a dict of tensors:

  g  <- g * min(max_norm / (||g|| + 1e-6), 1)       each tensor alone
  mu <- b1 mu + (1 - b1) g;   nu <- b2 nu + (1 - b2) g^2
  p  <- p - lr ((mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps) + wd p)
"""

from __future__ import annotations

from typing import Dict

import torch


class AdamW:
    def __init__(self, lr: float, max_norm: float, weight_decay: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.max_norm, self.wd = lr, max_norm, weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.t = 0
        self.mu: Dict[str, torch.Tensor] = {}
        self.nu: Dict[str, torch.Tensor] = {}

    def clip(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        out = {}
        for n, g in grads.items():
            norm = torch.linalg.vector_norm(g)
            out[n] = g * torch.clamp_max(self.max_norm / (norm + 1e-6), 1.0)
        return out

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Update ``params`` in place; returns the clipped gradients."""
        self.t += 1
        clipped = self.clip(grads)
        bc1 = 1 - self.b1 ** self.t
        bc2 = 1 - self.b2 ** self.t
        for n, g in clipped.items():
            mu = self.b1 * self.mu.get(n, torch.zeros_like(g)) + (1 - self.b1) * g
            nu = self.b2 * self.nu.get(n, torch.zeros_like(g)) + (1 - self.b2) * g * g
            self.mu[n], self.nu[n] = mu, nu
            p = params[n]
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps) + self.wd * p
            p.sub_(self.lr * u)
        return clipped
