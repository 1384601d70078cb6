"""Plain masked attention: what K1 and K2 compute, by dense torch ops.

A frozen copy of the plain version beside the port's K1 wrapper
(`reference_attention`, `visible_mask`), with no kernel behind it.

mask modes (q sees k iff all apply):
  pad     k < kv_len[b]
  causal  k <= q
  chunk   k < (q // chunk + 1) * chunk, and with left_chunks >= 0 also
          k >= (q // chunk - left_chunks) * chunk
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def visible_mask(t: int, kv_len: torch.Tensor | None, chunk: int = 0,
                 left_chunks: int = -1, causal: bool = False,
                 batch: int = 1, device=None) -> torch.Tensor:
    """(B, 1, T, T) bool: True where query q sees key k."""
    pos = torch.arange(t, device=device)
    k_pos, q_pos = pos[None, :], pos[:, None]
    mask = torch.ones((t, t), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if chunk > 0:
        mask = mask & (k_pos < (q_pos // chunk + 1) * chunk)
        if left_chunks >= 0:
            mask = mask & (k_pos >= torch.clamp(
                (q_pos // chunk - left_chunks) * chunk, min=0))
    mask = mask[None, None].expand(batch, 1, t, t)
    if kv_len is not None:
        mask = mask & (k_pos[None, None] < kv_len.to(device)[:, None, None,
                                                             None])
    return mask


def reference_attention(q, k, v, kv_len=None, chunk=0, left_chunks=-1,
                        causal=False) -> torch.Tensor:
    """The plain PyTorch version: dense scores in float32, the same masks,
    the result cast back to q's dtype."""
    b, h, t, d = q.shape
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(d)
    mask = visible_mask(t, kv_len, chunk, left_chunks, causal, b, q.device)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, v.float()).to(q.dtype)
