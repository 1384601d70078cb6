"""Conditional flow matching inference: Euler ODE sampling with CFG.

Port of the inference part of minimax_speech_tpu/models/cfm.py: the
cosine t-schedule, the fixed numpy noise table, and `solve_euler` with
classifier-free guidance as a batch of 2 (conditional and unconditional
branches in one estimator call per step).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch


@dataclass(frozen=True)
class CFMConfig:
    sigma_min: float = 1e-6
    t_scheduler: str = "cosine"
    training_cfg_rate: float = 0.2
    inference_cfg_rate: float = 0.7
    use_immiscible: bool = True
    immiscible_k: int = 8
    use_contrastive_fm: bool = True
    contrastive_lambda: float = 0.05


def cosine_schedule(t: torch.Tensor) -> torch.Tensor:
    return 1.0 - torch.cos(t * 0.5 * math.pi)


def make_fixed_noise(max_frames: int = 15000, n_feats: int = 80,
                     seed: int = 0) -> np.ndarray:
    """(max_frames, n_feats) deterministic inference noise table, the same
    numbers as the JAX package's for the same seed."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((max_frames, n_feats)).astype(np.float32)


def euler_grid(n_timesteps: int, cfg: CFMConfig):
    t_span = torch.linspace(0.0, 1.0, n_timesteps + 1)
    if cfg.t_scheduler == "cosine":
        t_span = cosine_schedule(t_span)
    return t_span[:-1], t_span[1:] - t_span[:-1]


def solve_euler(estimator: Callable, x: torch.Tensor, mu: torch.Tensor,
                mask: torch.Tensor, spks: torch.Tensor, cond: torch.Tensor,
                n_timesteps: int, cfg: CFMConfig) -> torch.Tensor:
    """Euler solve from noise x (B, T, D). `estimator(x, mask, mu, t,
    spks, cond)` returns the velocity. With guidance, each step runs the
    conditional and unconditional branches as one batch of 2B."""
    b = x.shape[0]
    ts, dts = euler_grid(n_timesteps, cfg)
    rate = cfg.inference_cfg_rate
    if rate == 0.0:
        for t, dt in zip(ts.tolist(), dts.tolist()):
            t1 = torch.full((b,), t, dtype=x.dtype, device=x.device)
            x = x + dt * estimator(x, mask, mu, t1, spks, cond).to(x.dtype)
        return x

    mu2 = torch.cat([mu, torch.zeros_like(mu)], dim=0)
    spks2 = torch.cat([spks, torch.zeros_like(spks)], dim=0)
    cond2 = torch.cat([cond, torch.zeros_like(cond)], dim=0)
    mask2 = torch.cat([mask, mask], dim=0)
    for t, dt in zip(ts.tolist(), dts.tolist()):
        x2 = torch.cat([x, x], dim=0)
        t2 = torch.full((2 * b,), t, dtype=x.dtype, device=x.device)
        d2 = estimator(x2, mask2, mu2, t2, spks2, cond2)
        dphi = (1.0 + rate) * d2[:b] - rate * d2[b:]
        x = x + dt * dphi.to(x.dtype)
    return x
