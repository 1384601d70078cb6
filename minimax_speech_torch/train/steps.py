"""The LM training step: forward, backward, clip, update, metrics.

Port of the LM half of minimax_speech_tpu/train/steps.py (the flow step
comes with the flow training slice). PyTorch runs eagerly, so a step is
a plain function that updates the state in place; the metrics stay on
the device until a caller reads them.

bf16=True runs the forward and backward through bfloat16 copies of the
float32 parameters (torch.func.functional_call), with the batch's float
tensors cast too, so the gradients land on the float32 masters, as the
JAX package's cast of the parameter tree does. Norms and softmax still
accumulate in float32 inside the modules.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from minimax_speech_torch.train.schedule import (OptState, Optimizer,
                                                 global_norm)
from minimax_speech_torch.utils.device import check_on, resolve_device
from minimax_speech_torch.utils.params_io import named_flax_params

LM_NORM_GROUPS = {"llm": "llm/", "decoder": "llm_decoder",
                  "speech_emb": "speech_embedding"}


@dataclass
class TrainState:
    """module (its parameters are the float32 masters), optimizer, its
    state, and the count of steps taken (micro-steps under
    accumulation)."""
    module: nn.Module
    optimizer: Optimizer
    opt_state: OptState
    step: int = 0

    def params(self) -> list:
        """The parameters in the optimizer state's order."""
        return [p for _, p in named_flax_params(self.module)]


def make_train_state(module: nn.Module, optimizer: Optimizer) -> TrainState:
    return TrainState(module, optimizer, optimizer.init(
        [p for _, p in named_flax_params(module)]))


def grad_norms_by_component(named_grads, groups: dict[str, str]) -> dict:
    """L2 norm per named component; groups maps name -> a substring of
    the parameter's flax path."""
    out = {}
    for name, needle in groups.items():
        sel = [g for path, g in named_grads if needle in path]
        out[f"grad_norm/{name}"] = global_norm(sel) if sel \
            else torch.zeros(())
    return out


class _LMLoss(nn.Module):
    """The LM loss as one module call, so that functional_call can swap
    in bf16 parameters: speaker conditioning from the batch's reference
    mels (the speaker encoder trains jointly) or its spk_emb, then the
    plan forward."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, batch: dict):
        m = self.model
        if "reference_mel" in batch:
            mel = batch["reference_mel"]
            mask = None
            if "reference_mel_len" in batch:
                t = mel.shape[1]
                mask = (torch.arange(t, device=mel.device)[None]
                        < batch["reference_mel_len"][:, None])
            spk = m.embed_speaker(mel, mask)
        else:
            spk = batch["spk_emb"]
        return m(batch["src_type"], batch["tok_id"], batch["target"],
                 batch["seq_len"], spk)


def _cast_floats(batch: dict, dtype) -> dict:
    return {k: v.to(dtype) if torch.is_floating_point(v) else v
            for k, v in batch.items()}


def make_lm_loss_fn(model, bf16: bool = False):
    """loss_fn(batch) -> (loss, acc): batch holds the plan tensors
    (src_type, tok_id, target, seq_len) and reference_mel (+
    reference_mel_len) or spk_emb, on the model's device."""
    wrapper = _LMLoss(model)

    def loss_fn(batch):
        if not bf16:
            return wrapper(batch)
        params = {f"model.{n}": p.to(torch.bfloat16)
                  for n, p in model.named_parameters()}
        return torch.func.functional_call(
            wrapper, params, (_cast_floats(batch, torch.bfloat16),))

    return loss_fn


def make_lm_train_step(model, bf16: bool = False, device=None):
    """Returns step(state, batch) -> (state, metrics); metrics: loss, acc,
    grad_norm (before the clip) and grad_norm/<component>, as tensors.
    The model must live on `device` (default cuda, which raises without
    a GPU)."""
    check_on(model, resolve_device(device), "the LM")
    loss_fn = make_lm_loss_fn(model, bf16=bf16)
    names = [path for path, _ in named_flax_params(model)]

    def step(state: TrainState, batch):
        params = state.params()
        loss, acc = loss_fn(batch)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        metrics = {"loss": loss.detach(), "acc": acc.detach(),
                   "grad_norm": global_norm(grads),
                   **grad_norms_by_component(list(zip(names, grads)),
                                             LM_NORM_GROUPS)}
        state.optimizer.apply(params, grads, state.opt_state)
        state.step += 1
        return state, metrics

    return step
