"""ZDM: a latent ("z-space") diffusion prior over a flowae autoencoder.

Port of minimax_speech_tpu/flowae/zdm.py: a frozen DiTo provides z
(its mu), normalised per frame by an affine-free LayerNorm; the prior
is a DiT over z trained with the same FM objective; generation samples
normalised z from the prior, then decodes through the autoencoder's
renderer. zaug noises z with the FM forward process at a random
t <= zaug_tmax with probability zaug_p.

Draws come in as arguments: FMDraws for the loss, the Euler start noise
of each sampling (or a torch.Generator to draw it).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch
from torch import nn

from minimax_speech_torch.flowae import fm as fm_lib
from minimax_speech_torch.flowae.dit import DiT1D, DiTConfig
from minimax_speech_torch.flowae.dito import (DiToAudio, dito_decode,
                                              draw_normal)
from minimax_speech_torch.flowae.trainer import ema_update
from minimax_speech_torch.train.schedule import global_norm
from minimax_speech_torch.train.steps import TrainState, backward_and_update
from minimax_speech_torch.utils.device import (check_on, module_device,
                                               resolve_device)


@dataclass(frozen=True)
class ZDMConfig:
    z_dim: int = 32
    net: DiTConfig = field(default_factory=lambda: DiTConfig(
        hidden=128, depth=4, num_heads=4, patch=1, in_channels=32,
        out_channels=32, cond_dim=0))
    fm: fm_lib.FMConfig = field(default_factory=fm_lib.FMConfig)
    n_steps: int = 18
    guidance: float = 1.0
    ema_rate: float = 0.9999
    zaug_p: float = 0.1
    zaug_tmax: float = 1.0


def normalize_latents(z: torch.Tensor) -> torch.Tensor:
    """Per-frame affine-free LayerNorm over the z channels (population
    variance, eps 1e-5)."""
    mean = z.mean(dim=-1, keepdim=True)
    var = z.var(dim=-1, keepdim=True, unbiased=False)
    return (z - mean) / torch.sqrt(var + 1e-5)


class ZDMNet(nn.Module):
    """Unconditional DiT over latent frames, built for n_frames of them:
    x (B, Tz, z_dim), t (B,)."""

    def __init__(self, cfg: ZDMConfig = ZDMConfig(), n_frames: int = 64):
        super().__init__()
        self.cfg = cfg
        self.dit = DiT1D(cfg.net, n_tok=n_frames // cfg.net.patch)

    def forward(self, x, t, z_dec=None):
        return self.dit(x, t, z_dec=z_dec)


def zaug(z: torch.Tensor, cfg: ZDMConfig, t: torch.Tensor,
         noise: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """z augmentation: rows where mask (B,) holds take z noised by the FM
    forward process at t * zaug_tmax (t (B,) uniform in [0, 1); noise
    the FM noise draw, candidates with immiscible noise)."""
    zt, _ = fm_lib.add_noise(z, t * cfg.zaug_tmax, cfg.fm, noise)
    return torch.where(mask.reshape((-1,) + (1,) * (z.ndim - 1)), zt, z)


def check_prior(device, zdm, ae):
    """Both modules on the device an entry point asks for (cuda by
    default, which raises without a GPU)."""
    dev = resolve_device(device)
    check_on(zdm, dev, "the ZDM")
    check_on(ae, dev, "the autoencoder")


def make_zdm_step(zdm: ZDMNet, ae: DiToAudio,
                  ema_decay: Optional[float] = None, device=None):
    """The prior's step: encode the batch with the frozen autoencoder (no
    gradient), normalise, FM loss on the prior. Returns step(state, ema,
    batch{'audio'}, draws) -> (state, ema, metrics{zdm/loss,
    zdm/grad_norm}); draws FMDraws for z's shape. Both modules must live
    on `device` (default cuda, which raises without a GPU)."""
    cfg = zdm.cfg
    decay = ema_decay if ema_decay is not None else cfg.ema_rate
    check_prior(device, zdm, ae)

    def step(state: TrainState, ema, batch, draws: fm_lib.FMDraws):
        with torch.no_grad():
            _, mu, _ = ae.encode(batch["audio"])
            z = normalize_latents(mu)
        loss = fm_lib.fm_loss(lambda x_t, t: zdm(x_t, t), z, cfg.fm, draws)
        grads = backward_and_update(state, loss)
        ema_update(ema, state.params(), decay)
        return state, ema, {"zdm/loss": loss.detach(),
                            "zdm/grad_norm": global_norm(grads)}

    return step


def start_noises(noise, generator, shapes, device):
    """The given start noises, or draws of `generator` for `shapes`."""
    if noise is not None:
        return [n.to(device) for n in noise]
    return [draw_normal(s, generator, device) for s in shapes]


@torch.no_grad()
def zdm_generate(zdm: ZDMNet, ae: DiToAudio, batch_size: int,
                 z_frames: int, out_len: int, noise=None,
                 generator: Optional[torch.Generator] = None,
                 n_steps: Optional[int] = None,
                 render_steps: Optional[int] = None,
                 return_z: bool = False):
    """Unconditional generation: FM-sample normalised z from the prior,
    decode through the autoencoder's renderer. noise: (the prior's start
    noise (B, z_frames, z_dim), the renderer's (B, out_len, C)), else
    drawn from `generator` in that order. Returns (B, out_len, C) audio
    (the z with return_z)."""
    cfg = zdm.cfg
    dev = module_device(zdm)
    nz, nd = start_noises(noise, generator, [
        (batch_size, z_frames, cfg.z_dim),
        (batch_size, out_len, ae.cfg.in_channels)], dev)
    z = fm_lib.euler_sample(lambda x_t, t: zdm(x_t, t), nz,
                            n_steps or cfg.n_steps, cfg.fm)
    if return_z:
        return z
    return dito_decode(ae, z, out_len, nd, n_steps=render_steps)


@torch.no_grad()
def eval_zdm(zdm: ZDMNet, ae: DiToAudio, audio, draws: fm_lib.FMDraws,
             sample_noise: torch.Tensor) -> dict:
    """Held-out prior loss (draws for z's shape) and the latent moments
    of a batch sampled from sample_noise (z's shape)."""
    _, mu, _ = ae.encode(audio)
    z = normalize_latents(mu)
    net = lambda x_t, t: zdm(x_t, t)  # noqa: E731
    loss = fm_lib.fm_loss(net, z, zdm.cfg.fm, draws)
    sample = fm_lib.euler_sample(net, sample_noise, zdm.cfg.n_steps,
                                 zdm.cfg.fm)
    return {"zdm_eval/loss": loss,
            "zdm_eval/sample_mean": torch.mean(sample),
            "zdm_eval/sample_std": torch.std(sample, unbiased=False)}
