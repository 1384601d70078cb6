"""Finite Scalar Quantization: 8 dims x 3 levels = 6561 codes.

Port of minimax_speech_tpu/ops/fsq.py.
"""
from __future__ import annotations

import torch

FSQ_DIM = 8
FSQ_LEVEL = 3
FSQ_SCALE = 0.9990000128746033  # the reference's tanh scale
CODEBOOK_SIZE = FSQ_LEVEL ** FSQ_DIM  # 6561


def fsq_encode(h: torch.Tensor) -> torch.Tensor:
    """(..., 8) features -> (...,) int32 codes in [0, 6561): tanh, scale,
    round half to even, +1 gives base-3 digits; the code is their
    little-endian value, with exact integer powers."""
    h = torch.tanh(h.float()) * FSQ_SCALE
    digits = (torch.round(h) + 1.0).to(torch.int32)
    powers = torch.tensor([FSQ_LEVEL ** i for i in range(FSQ_DIM)],
                          dtype=torch.int32, device=h.device)
    return (digits * powers).sum(dim=-1, dtype=torch.int32)


def fsq_digits(codes: torch.Tensor) -> torch.Tensor:
    """(...,) int codes -> (..., 8) digits in {0, 1, 2} (little-endian
    base 3), in the codes' dtype."""
    powers = FSQ_LEVEL ** torch.arange(FSQ_DIM, dtype=codes.dtype,
                                       device=codes.device)
    return torch.div(codes[..., None], powers, rounding_mode="floor") \
        % FSQ_LEVEL


def fsq_centers(codes: torch.Tensor) -> torch.Tensor:
    """(...,) int codes -> (..., 8) float32 quantization centers in
    {-1, 0, 1}."""
    return (fsq_digits(codes) - 1).float()
