"""Training losses: label-smoothed cross-entropy, accuracy and DPO for
the LM; LSGAN, feature matching, TPR and KL for the codec and vocoder
GANs.

Port of minimax_speech_tpu/utils/losses.py.

Each LM loss takes `group`, the data-parallel process group the global batch is
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


# --- GAN losses (DAC-VAE and HiFT training) --------------------------------
# Scores and feature maps are lists over sub-discriminators (feature maps
# lists of lists); every reduction is over all elements, so the layout of
# a score does not matter.

def discriminator_loss(real_outputs, fake_outputs):
    """LSGAN: sum over sub-discriminators of mean((1 - real)^2) +
    mean(fake^2)."""
    loss = 0.0
    for dr, df in zip(real_outputs, fake_outputs):
        loss = loss + torch.mean((1.0 - dr) ** 2) + torch.mean(df ** 2)
    return loss


def generator_adv_loss(fake_outputs):
    loss = 0.0
    for df in fake_outputs:
        loss = loss + torch.mean((1.0 - df) ** 2)
    return loss


def feature_matching_loss(real_feats, fake_feats):
    loss = 0.0
    for fr, ff in zip(real_feats, fake_feats):
        for r, f in zip(fr, ff):
            loss = loss + torch.mean(torch.abs(r - f))
    return loss


def median(x: torch.Tensor) -> torch.Tensor:
    """The median of all elements, the mean of the two middle ones for an
    even count (as jnp.median; torch.median takes the lower one)."""
    v = torch.sort(x.flatten()).values
    n = v.numel()
    return (v[(n - 1) // 2] + v[n // 2]) * 0.5


def tpr_loss(real_outputs, fake_outputs, tau: float = 0.04):
    """Truncated pointwise relativistic loss: per pair, over the elements
    where d = real - fake lies below its median m, the mean of (d - m)^2,
    truncated from above at tau (tau - relu(tau - L))."""
    loss = 0.0
    for dr, df in zip(real_outputs, fake_outputs):
        d = dr - df
        m = median(d)
        mask = d < m
        l_rel = torch.sum(torch.where(mask, (d - m) ** 2, 0.0)) / torch.clamp(
            mask.sum(), min=1)
        loss = loss + (tau - F.relu(tau - l_rel))
    return loss


def kl_loss(mu: torch.Tensor, logs: torch.Tensor) -> torch.Tensor:
    """KL of N(mu, exp(logs)^2) to N(0, 1), mean over elements."""
    return torch.mean(0.5 * (mu ** 2 + torch.exp(2 * logs) - 2 * logs - 1.0))
