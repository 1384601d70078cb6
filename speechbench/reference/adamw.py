"""AdamW with global-norm clipping and the warm-up schedule, plain: what
the port's optimizer (cli/train.py's default: `constantlr` with a linear
warm-up from lr * 1e-3, clip 1.0, no weight decay) applies, written from
its definition (optax's adamw after clip_by_global_norm, bias-corrected
moments, eps outside the square root)."""
from __future__ import annotations

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


def warmup_constant(lr: float, warmup_steps: int):
    """lr * 1e-3 rising linearly to lr over warmup_steps, then lr."""
    def fn(step: int) -> float:
        if warmup_steps <= 0 or step >= warmup_steps:
            return lr
        frac = 1.0 - step / warmup_steps
        return (lr * 1e-3 - lr) * frac + lr
    return fn


class AdamW:
    def __init__(self, params: list, lr: float, warmup_steps: int,
                 grad_clip: float = 1.0, weight_decay: float = 0.0):
        self.params = params
        self.schedule = warmup_constant(lr, warmup_steps)
        self.clip = grad_clip
        self.wd = weight_decay
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: list) -> list:
        """Update the parameters in place; returns the clipped gradients
        (what the moments took in)."""
        norm = torch.sqrt(sum(torch.sum(g.double() * g.double())
                              for g in grads))
        if norm >= self.clip:
            grads = [g * (self.clip / norm).to(g.dtype) for g in grads]
        lr = self.schedule(self.count)
        self.count += 1
        c1, c2 = 1.0 - B1 ** self.count, 1.0 - B2 ** self.count
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.mul_(B1).add_(g, alpha=1 - B1)
            nu.mul_(B2).addcmul_(g, g, value=1 - B2)
            u = (mu / c1) / (torch.sqrt(nu / c2) + EPS)
            if self.wd:
                u = u + self.wd * p
            p.add_(u, alpha=-lr)
        return grads
