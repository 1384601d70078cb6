"""The LM's training losses: label-smoothed cross-entropy and accuracy.

Port of the LM half of minimax_speech_tpu/utils/losses.py (the DPO and
GAN losses wait for their slices).
"""
from __future__ import annotations

import math

import torch

IGNORE_ID = -1


def label_smoothing_ce(logits: torch.Tensor, targets: torch.Tensor,
                       smoothing: float = 0.0,
                       normalize_length: bool = True) -> torch.Tensor:
    """KL(smoothed one-hot || softmax) summed over valid tokens, divided by
    their count (normalize_length) or by the batch size. logits (B, T, V);
    targets (B, T) with IGNORE_ID on padding. The log-softmax is taken in
    float32."""
    v = logits.shape[-1]
    valid = targets != IGNORE_ID
    t_safe = torch.where(valid, targets, torch.zeros_like(targets)).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, t_safe[..., None])[..., 0]
    if smoothing > 0:
        confidence = 1.0 - smoothing
        low = smoothing / (v - 1)
        smooth_term = -logp.sum(dim=-1)
        ent = (confidence * math.log(max(confidence, 1e-20))
               + (v - 1) * low * math.log(max(low, 1e-20)))
        loss_tok = confidence * nll + low * (smooth_term - nll) + ent
    else:
        loss_tok = nll
    loss_tok = torch.where(valid, loss_tok, torch.zeros_like(loss_tok))
    denom = torch.clamp(valid.sum(), min=1) if normalize_length \
        else logits.shape[0]
    return loss_tok.sum() / denom


def accuracy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Fraction of argmax predictions equal to the target over non-ignored
    positions."""
    valid = targets != IGNORE_ID
    correct = (logits.argmax(dim=-1) == targets) & valid
    return correct.sum() / torch.clamp(valid.sum(), min=1)
