"""Padding / chunk masks (boolean, True = attend/keep).

Port of minimax_speech_tpu/ops/masks.py (the full-sequence helpers).
"""
from __future__ import annotations

import torch


def make_non_pad_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) lengths -> (B, max_len) bool, True on valid positions."""
    pos = torch.arange(max_len, device=lengths.device)
    return pos[None, :] < lengths[:, None]


def subsequent_chunk_mask(size: int, chunk_size: int,
                          num_left_chunks: int = -1,
                          device=None) -> torch.Tensor:
    """(size, size) chunk-causal mask: position i sees positions
    < (i // chunk_size + 1) * chunk_size, and with num_left_chunks >= 0
    only the last num_left_chunks chunks before its own."""
    pos = torch.arange(size, device=device)
    block_end = (pos // chunk_size + 1) * chunk_size
    mask = pos[None, :] < block_end[:, None]
    if num_left_chunks >= 0:
        block_start = torch.clamp(
            (pos // chunk_size - num_left_chunks) * chunk_size, min=0)
        mask = mask & (pos[None, :] >= block_start[:, None])
    return mask


def add_optional_chunk_mask(pad_mask: torch.Tensor, static_chunk_size: int,
                            num_left_chunks: int = -1) -> torch.Tensor:
    """(B, T) or (B, 1, T) key pad mask [& static chunk mask] -> (B, T, T).
    static_chunk_size == 0 means full attention."""
    if pad_mask.dim() == 2:
        pad_mask = pad_mask[:, None, :]
    t = pad_mask.shape[-1]
    if static_chunk_size > 0:
        chunk = subsequent_chunk_mask(t, static_chunk_size, num_left_chunks,
                                      pad_mask.device)
        return pad_mask & chunk[None]
    return pad_mask.expand(pad_mask.shape[0], t, t)


def mask_to_bias(mask: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """bool mask -> additive bias, 0 where True and -1e10 where False (the
    reference's constant, kept so attention outputs compare)."""
    zero = torch.zeros((), dtype=dtype, device=mask.device)
    return torch.where(mask, zero, torch.full_like(zero, -1.0e10))
