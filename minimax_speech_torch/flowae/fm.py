"""flowae's flow-matching formulation and Euler sampler.

Port of minimax_speech_tpu/flowae/fm.py:
  x_t = (1 - t) x + (sigma_min + t (1 - sigma_min)) eps
  target ("negative velocity") = x - (1 - sigma_min) eps
  sampler: t from 1 to 0, x += neg_v * dt, CFG as
  uncond + g (cond - uncond); immiscible noise (the nearest of k
  candidates) optional.

Every function that draws takes its draws as arguments (`FMDraws`, the
Euler start noise), made by `make_fm_draws` / `torch.randn` from a
torch.Generator, so that a test can feed both packages JAX's numbers.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch


@dataclass(frozen=True)
class FMConfig:
    sigma_min: float = 1e-5
    timescale: float = 1.0
    use_immiscible: bool = True
    k_candidates: int = 4


@dataclass
class FMDraws:
    """One fm_loss call's draws: t (B,) float32 in [t_min, 1); noise
    (B, k, ...) standard normal candidates with immiscible noise, else
    (B, ...)."""
    t: torch.Tensor
    noise: torch.Tensor

    def to(self, device) -> "FMDraws":
        return FMDraws(self.t.to(device), self.noise.to(device))


def make_fm_draws(cfg: FMConfig, shape, generator: torch.Generator,
                  t_min: float = 0.0) -> FMDraws:
    """FMDraws for an x of `shape` from `generator`, on its device."""
    dev = generator.device
    b = shape[0]
    t = t_min + (1.0 - t_min) * torch.rand(b, generator=generator,
                                           device=dev)
    cand = ((b, cfg.k_candidates) + tuple(shape[1:])
            if cfg.use_immiscible else tuple(shape))
    return FMDraws(t, torch.randn(cand, generator=generator, device=dev))


def alpha(t, cfg: FMConfig):
    return 1.0 - t


def sigma(t, cfg: FMConfig):
    return cfg.sigma_min + t * (1.0 - cfg.sigma_min)


def immiscible_noise(x: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """The candidate (B, k, ...) nearest (L2) to each x."""
    b, k = cand.shape[:2]
    diff = (cand - x[:, None]).reshape(b, k, -1)
    best = torch.argmin(torch.sum(diff * diff, dim=-1), dim=1)
    return cand[torch.arange(b, device=cand.device), best]


def add_noise(x: torch.Tensor, t: torch.Tensor, cfg: FMConfig,
              noise: torch.Tensor):
    """t: (B,); noise: the draw (candidates with immiscible noise).
    Returns (x_t, the noise used)."""
    if cfg.use_immiscible:
        noise = immiscible_noise(x, noise)
    s = (x.shape[0],) + (1,) * (x.ndim - 1)
    x_t = alpha(t, cfg).reshape(s) * x + sigma(t, cfg).reshape(s) * noise
    return x_t, noise


def fm_loss(net: Callable, x: torch.Tensor, cfg: FMConfig, draws: FMDraws,
            net_kwargs: Optional[dict] = None) -> torch.Tensor:
    """MSE(net(x_t, t), x - (1 - sigma_min) eps), in float32; net_kwargs
    are extra conditioning inputs (z_dec etc.)."""
    x_t, noise = add_noise(x, draws.t, cfg, draws.noise)
    pred = net(x_t, draws.t * cfg.timescale, **(net_kwargs or {}))
    target = x - (1.0 - cfg.sigma_min) * noise
    return torch.mean((pred.float() - target.float()) ** 2)


def get_prediction(net, x_t, t, cfg: FMConfig, net_kwargs=None,
                   uncond_net_kwargs=None, guidance: float = 1.0):
    pred = net(x_t, t * cfg.timescale, **(net_kwargs or {}))
    if guidance != 1.0:
        uncond = net(x_t, t * cfg.timescale, **(uncond_net_kwargs or {}))
        pred = uncond + guidance * (pred - uncond)
    return pred


def time_steps(n_steps: int) -> np.ndarray:
    """linspace(1, 0, n_steps + 1) in float32 as jnp.linspace gives it on
    the CPU: 1 - i * (1 / n), then exactly 0."""
    i = np.arange(n_steps, dtype=np.float32)
    return np.append(np.float32(1) - i * (np.float32(1)
                                          / np.float32(n_steps)),
                     np.float32(0))


@torch.no_grad()
def euler_sample(net, noise: torch.Tensor, n_steps: int, cfg: FMConfig,
                 net_kwargs=None, uncond_net_kwargs=None,
                 guidance: float = 1.0) -> torch.Tensor:
    """t: 1 -> 0 Euler integration of the negative velocity from the
    start noise (B, ...)."""
    ts = time_steps(n_steps)
    x = noise
    for i in range(n_steps):
        t = torch.full((x.shape[0],), float(ts[i]), device=x.device)
        neg_v = get_prediction(net, x, t, cfg, net_kwargs,
                               uncond_net_kwargs, guidance)
        x = x + neg_v * float(ts[i] - ts[i + 1])
    return x
