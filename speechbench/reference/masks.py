"""Padding / chunk masks (boolean, True = attend/keep).

A frozen copy of the port's twin of minimax_speech_tpu/ops/masks.py.
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


def unit_chunk_mask(size: int, prompt_len: int, chunk: int, window: int = -1,
                    device=None) -> torch.Tensor:
    """(size, size) chunk mask on the prompt-anchored grid: unit 0 is
    positions [0, prompt_len), unit k >= 1 is [prompt_len + (k-1)*chunk,
    prompt_len + k*chunk). A query sees every key up to the end of its
    own unit; with window >= 0 only `window` keys before its unit's
    start. The full-sequence twin of the chunked streaming path."""
    pos = torch.arange(size, device=device)
    in_prompt = pos < prompt_len
    k = torch.clamp(pos - prompt_len, min=0) // chunk
    unit_end = torch.where(in_prompt, prompt_len, prompt_len + (k + 1) * chunk)
    mask = pos[None, :] < unit_end[:, None]
    if window >= 0:
        unit_start = torch.where(in_prompt, 0, prompt_len + k * chunk)
        mask = mask & (pos[None, :] >= (unit_start - window)[:, None])
    return mask


def tail(x: torch.Tensor, n: int, valid_len: int) -> torch.Tensor:
    """The last n frames of x's valid prefix [0, valid_len) along dim 1,
    zero-padded on the left when valid_len < n: the streaming state a
    causal conv or an attention window carries to the next chunk."""
    zeros = x.new_zeros((x.shape[0], n) + x.shape[2:])
    return torch.cat([zeros, x], dim=1)[:, valid_len: valid_len + n]


def mask_to_bias(mask: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """bool mask -> additive bias, 0 where True and -1e10 where False (the
    reference's constant, kept so attention outputs compare)."""
    zero = torch.zeros((), dtype=dtype, device=mask.device)
    return torch.where(mask, zero, torch.full_like(zero, -1.0e10))
