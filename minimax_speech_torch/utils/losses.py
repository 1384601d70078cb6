"""The LM's training losses: label-smoothed cross-entropy, accuracy and
DPO.

Port of the LM half of minimax_speech_tpu/utils/losses.py (the GAN losses
wait for their slice).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

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


def dpo_loss(chosen_logp: torch.Tensor, rejected_logp: torch.Tensor,
             ref_chosen_logp: torch.Tensor, ref_rejected_logp: torch.Tensor,
             beta: float = 0.01, label_smoothing: float = 0.0,
             ipo: bool = False):
    """Sigmoid DPO (conservative with label_smoothing > 0), or IPO, over
    per-sequence log-probs (B,). Returns (loss, chosen_reward,
    rejected_reward), the rewards beta times the policy-over-reference
    log ratios (B,)."""
    chosen_ratio = chosen_logp - ref_chosen_logp
    rejected_ratio = rejected_logp - ref_rejected_logp
    diff = chosen_ratio - rejected_ratio
    if ipo:
        loss = ((diff - 1.0 / (2 * beta)) ** 2).mean()
    else:
        loss = (-F.logsigmoid(beta * diff) * (1 - label_smoothing)
                - F.logsigmoid(-beta * diff) * label_smoothing).mean()
    return loss, beta * chosen_ratio, beta * rejected_ratio
