"""Nucleus and repetition-aware (RAS) sampling from pregenerated noise.

Port of ops/sampling.py:nucleus_gumbel_max, ras_sample_batch_pregen,
ras_sample and push_recent of the JAX package. The noise arrives as
arguments, so the same tables give the same ids in both packages.
"""
from __future__ import annotations

import torch


def gumbel(shape, generator: torch.Generator | None = None,
           device=None) -> torch.Tensor:
    """Standard Gumbel draws, float32."""
    u = torch.rand(shape, generator=generator, device=device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp(min=tiny)))


def nucleus_gumbel_max(g_top: torch.Tensor, logp: torch.Tensor,
                       top_p: float = 0.8, top_k: int = 25) -> torch.Tensor:
    """Batched nucleus sampling: Gumbel-max over the log of the kept
    top-p/top-k prefix. g_top (B, top_k); logp (B, V). Returns (B,)."""
    probs = torch.softmax(logp.float(), dim=-1)
    k = min(top_k, probs.shape[-1])
    top_vals, top_idx = torch.topk(probs, k, dim=-1)
    cum_excl = torch.cumsum(top_vals, dim=-1) - top_vals
    kept = torch.where(cum_excl < top_p, top_vals, torch.zeros_like(top_vals))
    scores = torch.log(torch.clamp(kept, min=1e-30)) + g_top[:, :k]
    i = torch.argmax(scores, dim=-1)
    return torch.gather(top_idx, 1, i[:, None])[:, 0]


def ras_sample_batch_pregen(g_top: torch.Tensor, g_fallback: torch.Tensor,
                            logp: torch.Tensor, recent: torch.Tensor,
                            top_p: float = 0.8, top_k: int = 25,
                            win_size: int = 10,
                            tau_r: float = 0.1) -> torch.Tensor:
    """RAS: the nucleus draw, unless it already appears >= win_size*tau_r
    times in `recent` (B, W); then a draw from the full distribution,
    argmax(logp + g_fallback) with g_fallback (B, V). Both branches are
    computed and selected per row, with no host sync. Returns (B,) int32."""
    top_ids = nucleus_gumbel_max(g_top, logp, top_p, top_k).to(torch.int32)
    rep_num = (recent == top_ids[:, None]).sum(dim=1)
    need = rep_num >= win_size * tau_r
    fallback = torch.argmax(logp.float() + g_fallback, dim=-1).to(torch.int32)
    return torch.where(need, fallback, top_ids)


def ras_sample(g_top: torch.Tensor, g_fallback: torch.Tensor,
               logp: torch.Tensor, recent: torch.Tensor, top_p: float = 0.8,
               top_k: int = 25, win_size: int = 10,
               tau_r: float = 0.1) -> torch.Tensor:
    """RAS for one row: logp (V,), recent (W,), g_top (top_k,) and
    g_fallback (V,) the Gumbel draws behind JAX's two categorical calls
    (jax.random.categorical(k, x) is argmax(x + gumbel(k, x.shape))).
    Returns a 0-d int32 tensor."""
    return ras_sample_batch_pregen(g_top[None], g_fallback[None], logp[None],
                                   recent[None], top_p, top_k, win_size,
                                   tau_r)[0]


def push_recent(recent: torch.Tensor, token: torch.Tensor) -> torch.Tensor:
    """Shift the ring buffer (W,) left and append the newest token."""
    return torch.cat([recent[1:], token.reshape(1).to(recent.dtype)])
