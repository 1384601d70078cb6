"""The LM's label-smoothed cross-entropy: a frozen copy of the port's,
for one process (no data-parallel group)."""
from __future__ import annotations

import math

import torch

IGNORE_ID = -1


def _count(n) -> torch.Tensor:
    """A count, with no gradient."""
    return torch.as_tensor(n).detach().clone()


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
    n = valid.sum() if normalize_length \
        else torch.tensor(logits.shape[0], device=logits.device)
    return loss_tok.sum() / torch.clamp(_count(n), min=1)


