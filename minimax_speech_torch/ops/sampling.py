"""Nucleus and repetition-aware (RAS) sampling from pregenerated noise.

Port of ops/sampling.py:nucleus_gumbel_max and ras_sample_batch_pregen
of the JAX package. The noise arrives as arguments, so the same tables
give the same ids in both packages.
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
