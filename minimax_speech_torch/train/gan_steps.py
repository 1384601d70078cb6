"""Preference fine-tuning of the Stage-1 LM: the DPO step.

Port of make_dpo_step of minimax_speech_tpu/train/gan_steps.py (the
codec and vocoder GAN steps of that module wait for their slice). The
step runs four LM forwards, chosen and rejected plans through the policy
and through a frozen reference policy (a second SpeechLM, without grad),
and one backward, through the port's optimizer as the LM step does
(steps.backward_and_update). The JAX step has no bf16 route, nor does
this one.

Under a mesh the reference policy is sharded as the policy is: the caller
puts it on its tensor-parallel slices (parallel.layers.shard_module with
the "lm" rules), so each rank holds a tp share of it. The loss and the
metrics are this rank's shares of the global batch's pairs, as the LM
step's (utils/losses.py).
"""
from __future__ import annotations

import torch

from minimax_speech_torch.train import steps
from minimax_speech_torch.utils import losses
from minimax_speech_torch.utils.device import check_on, resolve_device

PLAN_KEYS = ("src_type", "tok_id", "target", "seq_len")
REJ = "_rej"  # suffix of the rejected plans' keys in a DPO batch


def _speaker(model, batch: dict):
    """The batch's spk_emb, else its reference mels through `model`'s
    speaker encoder (trained jointly in the policy)."""
    if "spk_emb" in batch:
        return batch["spk_emb"]
    return steps.speaker_of(model, batch)


def _seq_logps(model, batch: dict):
    """(chosen, rejected) summed target log-probs (B,) under `model`."""
    spk = _speaker(model, batch)
    return tuple(model.sequence_logp(*(batch[k + sfx] for k in PLAN_KEYS),
                                     spk) for sfx in ("", REJ))


def make_dpo_step(model, ref_model, beta: float = 0.01,
                  label_smoothing: float = 0.0, ipo: bool = False,
                  device=None):
    """Returns step(state, batch) -> (state, metrics) for the policy
    `model`, held to `ref_model` (set here to no grad and eval). batch:
    the chosen plans (src_type, tok_id, target, seq_len), the rejected
    ones under the same keys with the suffix _rej, and spk_emb or
    reference_mel (+ reference_mel_len), on the models' device. Metrics:
    dpo/loss, dpo/chosen_reward, dpo/rejected_reward (batch means) and
    dpo/reward_acc (the share with chosen above rejected). Both models
    must live on `device` (default cuda, which raises without a GPU)."""
    dev = resolve_device(device)
    check_on(model, dev, "the policy")
    check_on(ref_model, dev, "the reference policy")
    ref_model.requires_grad_(False).eval()

    def step(state: steps.TrainState, batch):
        group = state.dp_group
        with torch.no_grad():
            ref_chosen, ref_rej = _seq_logps(ref_model, batch)
        chosen, rej = _seq_logps(model, batch)
        loss, cr, rr = losses.dpo_loss(chosen, rej, ref_chosen, ref_rej,
                                       beta, label_smoothing, ipo,
                                       group=group)
        steps.backward_and_update(state, loss)
        n = losses.global_count(torch.tensor(cr.shape[0], device=cr.device),
                                group)
        return state, steps.dp_sum(state, {
            "dpo/loss": loss.detach(),
            "dpo/chosen_reward": cr.detach().sum() / n,
            "dpo/rejected_reward": rr.detach().sum() / n,
            "dpo/reward_acc": (cr > rr).float().sum() / n})

    return step
