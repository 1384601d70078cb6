"""Monotonic alignment search (MAS): the batched Viterbi DP of Glow-TTS
and Matcha-TTS.

Port of minimax_speech_tpu/ops/monotonic_align.py. value (B, Tx, Ty)
holds the log-likelihood of text position x explaining mel frame y; the
path is the monotonic surjective alignment that maximises its sum:
v[x, y] = value[x, y] + max(v[x, y-1], v[x-1, y-1]), backtracked from
(tx-1, ty-1), the diagonal taken on ties (v[x-1, y-1] >= v[x, y-1]), as
the reference's Cython kernel does.

`maximum_path` runs on the tensors' device as torch ops, batched: a loop
over the Ty frames forward, each step one (B, Tx) column, then a loop
backward over the recorded choices. It reads nothing back to the host
inside either loop. `maximum_path_numpy` is the reference DP, one
sample at a time, for tests.
"""
from __future__ import annotations

import numpy as np
import torch

NEG = -1e9


def maximum_path(value: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """value: (B, Tx, Ty) float; mask: (B, Tx, Ty) bool or 0/1, a
    rectangle per sample. Returns the one-hot path (B, Tx, Ty) float32."""
    b, tx, ty = value.shape
    mask = mask.bool()
    value = torch.where(mask, value, torch.full_like(value, NEG))
    x_lens = mask[:, :, 0].sum(dim=1)
    y_lens = mask[:, 0, :].sum(dim=1)

    # forward: carry the (B, Tx) score column; diag[..., y] records
    # whether frame y came from x-1 (the choice made on column y-1)
    v = torch.full((b, tx), NEG, dtype=value.dtype, device=value.device)
    v[:, 0] = value[:, 0, 0]
    neg = torch.full((b, 1), NEG, dtype=value.dtype, device=value.device)
    diag = torch.zeros((b, tx, ty), dtype=torch.bool, device=value.device)
    for y in range(1, ty):
        shifted = torch.cat([neg, v[:, :-1]], dim=1)
        diag[:, :, y] = shifted >= v
        v = value[:, :, y] + torch.maximum(v, shifted)

    # backward from (x_lens-1, y_lens-1): mark x at each valid frame,
    # step to x-1 where the diagonal was taken
    rows = torch.arange(b, device=value.device)
    x = torch.clamp(x_lens - 1, min=0)
    path = torch.zeros((b, tx, ty), dtype=torch.float32, device=value.device)
    for y in range(ty - 1, -1, -1):
        active = y < y_lens
        path[rows, x, y] = active.float()
        took = diag[rows, x, y]
        x = torch.clamp(torch.where(active & took, x - 1, x), min=0)
    return path * mask.float()


def maximum_path_numpy(value: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """The reference DP (the Cython kernel's recurrence), for tests."""
    b, tx, ty = value.shape
    path = np.zeros_like(value, dtype=np.float32)
    for i in range(b):
        txi = int(mask[i, :, 0].sum())
        tyi = int(mask[i, 0, :].sum())
        v = np.full((txi, tyi), -np.inf)
        v[0, 0] = value[i, 0, 0]
        for y in range(1, tyi):
            for x in range(min(y + 1, txi)):
                best = v[x, y - 1]
                if x > 0 and v[x - 1, y - 1] >= best:
                    best = v[x - 1, y - 1]
                v[x, y] = value[i, x, y] + best
        x = txi - 1
        for y in range(tyi - 1, -1, -1):
            path[i, x, y] = 1.0
            if y > 0 and x > 0 and v[x - 1, y - 1] >= v[x, y - 1]:
                x -= 1
    return path
