"""The LM's training losses: label-smoothed cross-entropy, accuracy and
DPO.

Port of the LM half of minimax_speech_tpu/utils/losses.py (the GAN losses
wait for their slice).

Each takes `group`, the data-parallel process group the global batch is
split over (None: the batch is whole). With a group, a function returns
this rank's share of the global batch's value: its own sum over the
global denominator (the valid tokens, rows or pairs summed over the
group), so that the shares sum over the group to what one process
computes on the global batch, and so do their gradients. The mean of
per-rank means is another function whenever the ranks hold different
counts.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

IGNORE_ID = -1


def global_count(n, group=None) -> torch.Tensor:
    """A count (no gradient) summed over `group`."""
    n = torch.as_tensor(n).detach().clone()
    if group is not None:
        dist.all_reduce(n, group=group)
    return n


def label_smoothing_ce(logits: torch.Tensor, targets: torch.Tensor,
                       smoothing: float = 0.0,
                       normalize_length: bool = True,
                       group=None) -> torch.Tensor:
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
    n = valid.sum() if normalize_length \
        else torch.tensor(logits.shape[0], device=logits.device)
    return loss_tok.sum() / torch.clamp(global_count(n, group), min=1)


def accuracy(logits: torch.Tensor, targets: torch.Tensor,
             group=None) -> torch.Tensor:
    """Fraction of argmax predictions equal to the target over non-ignored
    positions."""
    valid = targets != IGNORE_ID
    correct = (logits.argmax(dim=-1) == targets) & valid
    return correct.sum() / torch.clamp(global_count(valid.sum(), group),
                                       min=1)


def dpo_loss(chosen_logp: torch.Tensor, rejected_logp: torch.Tensor,
             ref_chosen_logp: torch.Tensor, ref_rejected_logp: torch.Tensor,
             beta: float = 0.01, label_smoothing: float = 0.0,
             ipo: bool = False, group=None):
    """Sigmoid DPO (conservative with label_smoothing > 0), or IPO, over
    per-sequence log-probs (B,). Returns (loss, chosen_reward,
    rejected_reward), the rewards beta times the policy-over-reference
    log ratios (B,)."""
    chosen_ratio = chosen_logp - ref_chosen_logp
    rejected_ratio = rejected_logp - ref_rejected_logp
    diff = chosen_ratio - rejected_ratio
    if ipo:
        per_pair = (diff - 1.0 / (2 * beta)) ** 2
    else:
        per_pair = (-F.logsigmoid(beta * diff) * (1 - label_smoothing)
                    - F.logsigmoid(-beta * diff) * label_smoothing)
    n = global_count(torch.tensor(diff.shape[0], device=diff.device), group)
    return (per_pair.sum() / n, beta * chosen_ratio,
            beta * rejected_ratio)
