"""Rotary position embeddings, rotate-half convention.

A frozen copy of the port's twin of minimax_speech_tpu/ops/rope.py (S3 tokenizer and Qwen2 RoPE).
"""
from __future__ import annotations

import numpy as np
import torch


def rope_cos_sin(max_len: int, head_dim: int, theta: float = 10000.0,
                 positions: torch.Tensor | None = None,
                 dtype=torch.float32, device=None):
    """cos, sin of shape (T, head_dim); frequencies theta^(-2i/d)
    duplicated over both halves. Angles are taken in float32."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (np.arange(0, half, dtype=np.float64)
                             * 2 / head_dim))
    if positions is None:
        positions = torch.arange(max_len, dtype=torch.float32, device=device)
    freqs_t = torch.as_tensor(freqs, dtype=torch.float32,
                              device=positions.device)
    angles = positions[:, None].float() * freqs_t[None, :]
    angles = torch.cat([angles, angles], dim=-1)
    return torch.cos(angles).to(dtype), torch.sin(angles).to(dtype)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor):
    """q, k: (B, T, H, D); cos/sin: (T, D), broadcast over batch and heads."""
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    return q * c + rotate_half(q) * s, k * c + rotate_half(k) * s
