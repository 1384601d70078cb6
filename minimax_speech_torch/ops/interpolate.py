"""1-D interpolation matching torch.nn.functional.interpolate.

Port of minimax_speech_tpu/ops/interpolate.py: the static-gather forms
of 'nearest' (integer scale) and 'linear' (align_corners=False). The
legacy flow's InterpolateRegulator resamples its encoder output to the
mel grid through interpolate_linear.
"""
from __future__ import annotations

import numpy as np
import torch


def interpolate_nearest(x: torch.Tensor, scale: int) -> torch.Tensor:
    """(..., T) -> (..., T*scale), each sample repeated `scale` times."""
    return torch.repeat_interleave(x, scale, dim=-1)


def interpolate_linear(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """(..., T) -> (..., out_len), torch 'linear' with align_corners=False:
    in_coord = (out_coord + 0.5) * T / out_len - 0.5, clamped to [0, T-1];
    the indices and weights are fixed by the shapes (numpy, float64)."""
    t = x.shape[-1]
    coord = (np.arange(out_len, dtype=np.float64) + 0.5) * (t / out_len) \
        - 0.5
    coord = np.clip(coord, 0.0, t - 1)
    lo = np.floor(coord).astype(np.int64)
    hi = np.minimum(lo + 1, t - 1)
    w_hi = torch.as_tensor((coord - lo).astype(np.float32), device=x.device,
                           dtype=x.dtype)
    lo_t = torch.as_tensor(lo, device=x.device)
    hi_t = torch.as_tensor(hi, device=x.device)
    return x[..., lo_t] * (1.0 - w_hi) + x[..., hi_t] * w_hi
