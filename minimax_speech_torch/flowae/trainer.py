"""flowae trainer: the DiTo train step with an EMA of the parameters,
and the reconstruction eval.

Port of minimax_speech_tpu/flowae/trainer.py. A step updates the state
in place (train/steps.py's TrainState and optimizer) and the EMA, a list
of tensors in the state's parameter order; its draws come in as an
argument (dito.DiToDraws) where the JAX step takes a key.
"""
from __future__ import annotations

import copy
from typing import Optional

import torch
from torch import nn

from minimax_speech_torch.flowae.dito import DiToAudio, dito_decode
from minimax_speech_torch.train.schedule import global_norm
from minimax_speech_torch.train.steps import TrainState, backward_and_update
from minimax_speech_torch.utils.device import check_on, resolve_device
from minimax_speech_torch.utils.params_io import named_flax_params


def ema_init(module: nn.Module) -> list:
    """The EMA's starting point: a copy of the module's parameters, in
    the order of TrainState.params()."""
    return [p.detach().clone() for _, p in named_flax_params(module)]


@torch.no_grad()
def ema_update(ema: list, params: list, decay: float = 0.9999) -> list:
    """e <- e decay + p (1 - decay), in place; returns ema."""
    for e, p in zip(ema, params):
        e.copy_(e * decay + p.to(e.dtype) * (1 - decay))
    return ema


@torch.no_grad()
def with_params(module: nn.Module, tensors: list) -> nn.Module:
    """A copy of `module` holding `tensors` (an EMA) as its parameters."""
    out = copy.deepcopy(module)
    for (_, p), t in zip(named_flax_params(out), tensors):
        p.copy_(t)
    return out


def make_ae_step(model, batch_key: str, kl_weight: float, zaug_p: float,
                 ema_decay: float, bf16: bool, device):
    """The DiTo step of either track over batch[batch_key]."""
    check_on(model, resolve_device(device), "the DiTo model")

    def step(state: TrainState, ema, batch, draws):
        x = batch[batch_key]
        if bf16:
            x = x.to(torch.bfloat16).float()
        rec, kl, _ = model.loss(x, draws, zaug_p)
        loss = rec + kl_weight * kl
        grads = backward_and_update(state, loss)
        ema_update(ema, state.params(), ema_decay)
        return state, ema, {"loss": loss.detach(),
                            "grad_norm": global_norm(grads),
                            "rec": rec.detach(), "kl": kl.detach()}

    return step


def make_dito_step(model: DiToAudio, kl_weight: float = 1e-4,
                   zaug_p: float = 0.1, ema_decay: float = 0.9999,
                   bf16: bool = True, device=None):
    """Returns step(state, ema, batch{'audio': (B, T, 1)}, draws) ->
    (state, ema, metrics{loss, grad_norm, rec, kl}); draws a
    dito.DiToDraws. bf16 rounds the audio to bfloat16 and computes in
    float32, parameters and activations. The model must live on `device`
    (default cuda, which raises without a GPU)."""
    return make_ae_step(model, "audio", kl_weight, zaug_p, ema_decay, bf16,
                        device)


@torch.no_grad()
def eval_reconstruction(model: DiToAudio, audio, noise=None,
                        generator: Optional[torch.Generator] = None,
                        n_steps: Optional[int] = None) -> dict:
    """Encode -> sample (from `noise` or a draw of `generator`) -> MSE
    and SNR in dB."""
    _, mu, _ = model.encode(audio)
    rec = dito_decode(model, mu, audio.shape[1], noise, generator, n_steps)
    mse = torch.mean((rec - audio) ** 2)
    sig = torch.mean(audio ** 2)
    snr = 10.0 * torch.log10(torch.clamp(sig, min=1e-12)
                             / torch.clamp(mse, min=1e-12))
    return {"eval/mse": mse, "eval/snr_db": snr}
