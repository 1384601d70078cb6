"""Conditional flow matching: the OT-CFM training loss and Euler ODE
sampling with CFG.

Port of minimax_speech_tpu/models/cfm.py. Training (`compute_loss`):
cosine t-schedule, immiscible noise (the nearest of k candidates), CFG
dropout, and the contrastive loss against a derangement of the batch.
Its random draws come in as one explicit `CFMDraws` value
(`make_draws` makes it from a torch.Generator on the model's device),
so that a test can feed both packages the same numbers. Inference: the
fixed numpy noise table, and the Euler solvers with classifier-free
guidance as a batch of 2 (conditional and unconditional branches in one
estimator call per step): `solve_euler` over a whole sequence, and for
chunked streaming `solve_euler_collect` (the prompt, collecting the
estimator's state at every step) and `solve_euler_chunk` (one chunk
against those states).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from minimax_speech_torch.parallel.collectives import all_gather_cat
from minimax_speech_torch.utils import losses


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


@dataclass
class CFMDraws:
    """The random numbers of one `compute_loss` call, as JAX's
    compute_loss draws them from its key: t (B,) uniform in [0, 1)
    before the cosine schedule; cand (B, k, T, D) standard normal noise
    candidates (k = 1 without immiscible noise); keep (B,) the CFG
    dropout's keep mask (1.0 or 0.0); perm (B,) a permutation of
    range(B) before the derangement's fix-up; row0 the global index of
    the first row (`rows`)."""
    t: torch.Tensor
    cand: torch.Tensor
    keep: torch.Tensor
    perm: torch.Tensor
    row0: int = 0

    def rows(self, start: int, n: int) -> "CFMDraws":
        """The draws of rows [start, start + n) of the global batch; perm
        stays the global batch's, and row0 marks where these rows sit."""
        return CFMDraws(self.t[start:start + n], self.cand[start:start + n],
                        self.keep[start:start + n], self.perm,
                        self.row0 + start)


def make_draws(cfg: CFMConfig, b: int, t: int, d: int,
               generator: torch.Generator) -> CFMDraws:
    """CFMDraws for a (B, T, D) target from `generator`, on its device."""
    dev = generator.device
    k = cfg.immiscible_k if cfg.use_immiscible else 1
    return CFMDraws(
        t=torch.rand(b, generator=generator, device=dev),
        cand=torch.randn(b, k, t, d, generator=generator, device=dev),
        keep=(torch.rand(b, generator=generator, device=dev)
              > cfg.training_cfg_rate).float(),
        perm=torch.randperm(b, generator=generator, device=dev))


def immiscible_noise(x1: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """The candidate (B, k, T, D) nearest (L2) to each target (B, T, D)."""
    b, k = cand.shape[:2]
    dist = (cand - x1[:, None]).reshape(b, k, -1).square().sum(-1)
    best = dist.argmin(dim=1)
    return cand[torch.arange(b, device=cand.device), best]


def derangement(perm: torch.Tensor) -> torch.Tensor:
    """perm with each self-pair redirected to the next index (mod B), as
    JAX's derangement fixes its permutation up; B = 1 keeps its
    self-pair."""
    idx = torch.arange(perm.shape[0], device=perm.device)
    return torch.where(perm == idx, (idx + 1) % perm.shape[0], perm)


def compute_loss(estimator: Callable, x1: torch.Tensor, mask: torch.Tensor,
                 mu: torch.Tensor, spks: torch.Tensor, cond: torch.Tensor,
                 cfg: CFMConfig, draws: CFMDraws,
                 streaming: bool = False, group=None) -> torch.Tensor:
    """The OT-CFM loss (contrastive with cfg.use_contrastive_fm).
    x1, mu, cond: (B, T, D); mask: (B, T) float; spks: (B, D);
    `estimator(x, mask, mu, t, spks, cond, streaming=)` returns the
    velocity. The loss averages over mask.sum() * D. group: the
    data-parallel group the global batch is split over, these rows its
    rows [draws.row0, draws.row0 + B): the denominator is the global
    batch's and each row's contrastive negative the target velocity of
    its deranged row of the global batch (gathered over the group), so
    the result is this rank's share of the global batch's loss."""
    d = x1.shape[-1]
    t = draws.t.to(x1.dtype)[:, None, None]
    if cfg.t_scheduler == "cosine":
        t = cosine_schedule(t)
    cand = draws.cand.to(x1.dtype)
    z = immiscible_noise(x1, cand) if cfg.use_immiscible else cand[:, 0]
    y = (1.0 - (1.0 - cfg.sigma_min) * t) * z + t * x1
    u_pos = x1 - (1.0 - cfg.sigma_min) * z
    if cfg.training_cfg_rate > 0:
        keep = draws.keep.to(x1.dtype)
        mu = mu * keep[:, None, None]
        spks = spks * keep[:, None]
        cond = cond * keep[:, None, None]
    pred = estimator(y, mask, mu, t[:, 0, 0], spks, cond, streaming=streaming)
    m = mask[..., None]
    denom = losses.global_count(mask.sum(), group) * d
    pos_loss = (((pred - u_pos) * m) ** 2).sum() / denom
    if not cfg.use_contrastive_fm:
        return pos_loss
    b = x1.shape[0]
    pairs = derangement(draws.perm)[draws.row0:draws.row0 + b]
    # u_pos holds no parameter: the gather needs no gradient
    u_all = u_pos if group is None else all_gather_cat(u_pos, group, 0)
    u_neg = u_all[pairs]
    neg_loss = (((pred - u_neg) * m) ** 2).sum() / denom
    return pos_loss - cfg.contrastive_lambda * neg_loss


def euler_grid(n_timesteps: int, cfg: CFMConfig):
    t_span = torch.linspace(0.0, 1.0, n_timesteps + 1)
    if cfg.t_scheduler == "cosine":
        t_span = cosine_schedule(t_span)
    return t_span[:-1], t_span[1:] - t_span[:-1]


def solve_euler(estimator: Callable, x: torch.Tensor, mu: torch.Tensor,
                mask: torch.Tensor, spks: torch.Tensor, cond: torch.Tensor,
                n_timesteps: int, cfg: CFMConfig, **est_kw) -> torch.Tensor:
    """Euler solve from noise x (B, T, D). `estimator(x, mask, mu, t,
    spks, cond, **est_kw)` returns the velocity (est_kw: the UNet's
    `streaming`, `window`, `unit_align`). With guidance, each step runs
    the conditional and unconditional branches as one batch of 2B."""
    b = x.shape[0]
    ts, dts = euler_grid(n_timesteps, cfg)
    rate = cfg.inference_cfg_rate
    if rate == 0.0:
        for t, dt in zip(ts.tolist(), dts.tolist()):
            t1 = torch.full((b,), t, dtype=x.dtype, device=x.device)
            x = x + dt * estimator(x, mask, mu, t1, spks, cond,
                                   **est_kw).to(x.dtype)
        return x

    mask2, mu2, spks2, cond2 = _cfg_batch(mask, mu, spks, cond)
    for t, dt in zip(ts.tolist(), dts.tolist()):
        x2 = torch.cat([x, x], dim=0)
        t2 = torch.full((2 * b,), t, dtype=x.dtype, device=x.device)
        d2 = estimator(x2, mask2, mu2, t2, spks2, cond2, **est_kw)
        dphi = (1.0 + rate) * d2[:b] - rate * d2[b:]
        x = x + dt * dphi.to(x.dtype)
    return x


def _cfg_batch(mask, mu, spks, cond):
    """The CFG batch of 2B: the conditioning, then zeros for the
    unconditional branch; the mask twice."""
    return (torch.cat([mask, mask], dim=0),
            torch.cat([mu, torch.zeros_like(mu)], dim=0),
            torch.cat([spks, torch.zeros_like(spks)], dim=0),
            torch.cat([cond, torch.zeros_like(cond)], dim=0))


def solve_euler_collect(estimator: Callable, x, mu, mask, spks, cond,
                        n_timesteps: int, cfg: CFMConfig, collect_len: int,
                        window: int = 100):
    """The chunked-streaming prefill: the Euler solve over the (padded)
    prompt that also collects the estimator's streaming state at each
    step. `estimator(..., collect_len=, window=)` returns (velocity,
    state). Returns (x, [state per step]); each state holds the CFG
    batch of 2B."""
    b = x.shape[0]
    ts, dts = euler_grid(n_timesteps, cfg)
    rate = cfg.inference_cfg_rate
    mask2, mu2, spks2, cond2 = _cfg_batch(mask, mu, spks, cond)
    states = []
    for t, dt in zip(ts.tolist(), dts.tolist()):
        x2 = torch.cat([x, x], dim=0)
        t2 = torch.full((2 * b,), t, dtype=x.dtype, device=x.device)
        d2, state = estimator(x2, mask2, mu2, t2, spks2, cond2,
                              collect_len=collect_len, window=window)
        dphi = (1.0 + rate) * d2[:b] - rate * d2[b:]
        x = x + dt * dphi.to(x.dtype)
        states.append(state)
    return x, states


def solve_euler_chunk(estimator: Callable, x, mu, spks, cond,
                      n_timesteps: int, cfg: CFMConfig, states: list,
                      offset: int, q_valid: int, window: int = 100):
    """One streaming hop of the Euler solve: x, mu, cond are the chunk's
    frames (B, cq, D) from absolute frame `offset`, q_valid of them valid;
    `states` the per-step states of solve_euler_collect or the previous
    hop. O(chunk) work. Returns (x, [new state per step])."""
    b, cq, _ = x.shape
    ts, dts = euler_grid(n_timesteps, cfg)
    rate = cfg.inference_cfg_rate
    mask = (torch.arange(cq, device=x.device) < q_valid)[None].to(x.dtype)
    mask2, mu2, spks2, cond2 = _cfg_batch(mask, mu, spks, cond)
    new_states = []
    for (t, dt), state in zip(zip(ts.tolist(), dts.tolist()), states):
        x2 = torch.cat([x, x], dim=0)
        t2 = torch.full((2 * b,), t, dtype=x.dtype, device=x.device)
        d2, state = estimator(x2, mask2, mu2, t2, spks2, cond2,
                              cache=state, cache_offset=offset,
                              q_valid=q_valid, window=window)
        dphi = (1.0 + rate) * d2[:b] - rate * d2[b:]
        x = x + dt * dphi.to(x.dtype)
        new_states.append(state)
    return x, new_states
