"""GLPTo: the GAN + perceptual autoencoder variant (audio).

Port of minimax_speech_tpu/flowae/glpto.py: DiTo's encoder and latent,
a feed-forward decoder (GroupNorm, silu, stride-s transposed convs of
kernel 2s, a 7-tap output conv, tanh) trained with L1 + a multi-scale
STFT loss (the perceptual term) + KL + the adversarial loss against an
MSD, weighted adaptively by lambda = ||grad nll|| / (||grad adv|| +
1e-4), both norms over all the generator's parameters.

Channel-last at the surface, (B, T, C), as in the JAX package; the
encoder's reparameterization noise comes in as `eps`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from minimax_speech_torch.flowae.consistency_unet import GN_EPS, conv
from minimax_speech_torch.flowae.dito import (ConvEncoder, DiToConfig,
                                              kl_term, split_latent)
from minimax_speech_torch.train.schedule import global_norm
from minimax_speech_torch.train.steps import TrainState, backward_and_update
from minimax_speech_torch.utils import audio_losses, losses
from minimax_speech_torch.utils.device import check_on, resolve_device


@dataclass(frozen=True)
class GLPToConfig:
    in_channels: int = 1
    z_dim: int = 32
    enc_channels: int = 32
    enc_strides: Tuple[int, ...] = (4, 4, 4)
    disc_start: int = 0
    gan_weight: float = 1.0
    kl_weight: float = 1e-4
    perceptual_weight: float = 1.0


class ConvDecoder(nn.Module):
    def __init__(self, cfg: GLPToConfig):
        super().__init__()
        ch = cfg.enc_channels * (2 ** len(cfg.enc_strides))
        self.head = conv(1, cfg.z_dim, ch, 3)
        self.n = len(cfg.enc_strides)
        for i, s in enumerate(reversed(cfg.enc_strides)):
            k = 2 * s
            pad = (k - s) // 2
            self.add_module(f"norm_{i}", nn.GroupNorm(8, ch, eps=GN_EPS))
            self.add_module(f"up_{i}", nn.ConvTranspose1d(
                ch, ch // 2, k, stride=s, padding=pad,
                output_padding=(k - s) - 2 * pad))
            ch //= 2
        self.out = conv(1, ch, cfg.in_channels, 7)

    def forward(self, z):
        """(B, Tz, z_dim) -> (B, Tz * prod(strides), C) in [-1, 1]."""
        h = self.head(z.movedim(-1, 1))
        for i in range(self.n):
            h = F.silu(getattr(self, f"norm_{i}")(h))
            h = getattr(self, f"up_{i}")(h)
        return torch.tanh(self.out(h)).movedim(1, -1)


class GLPToAudio(nn.Module):
    def __init__(self, cfg: GLPToConfig = GLPToConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = ConvEncoder(DiToConfig(
            in_channels=cfg.in_channels, z_dim=cfg.z_dim,
            enc_channels=cfg.enc_channels, enc_strides=cfg.enc_strides))
        self.decoder = ConvDecoder(cfg)

    def encode(self, x, eps=None):
        return split_latent(self.encoder(x), eps)

    def decode(self, z):
        return self.decoder(z)

    def forward(self, x, eps=None):
        z, mu, logvar = self.encode(x, eps)
        return self.decode(z), mu, logvar


def make_glpto_steps(model: GLPToAudio, discriminator: nn.Module,
                     cfg: GLPToConfig, sample_rate: int = 24000,
                     device=None):
    """(gen_step, disc_step), each step(state, batch{'audio': (B, T, 1)},
    eps) -> (state, metrics); eps the encoder's noise (B, Tz, z_dim),
    the same in both steps of an iteration. The discriminator (an MSD)
    maps (B, T) to (scores, feature maps). Both modules must live on
    `device` (default cuda, which raises without a GPU)."""
    dev = resolve_device(device)
    check_on(model, dev, "the GLPTo model")
    check_on(discriminator, dev, "the discriminator")

    def recon_losses(fake, real):
        l1 = audio_losses.l1_loss(fake, real)
        spec = audio_losses.multi_scale_stft_loss(
            fake[..., 0], real[..., 0], (512, 128))
        return l1 + cfg.perceptual_weight * spec

    def gen_step(g_state: TrainState, batch, eps):
        x = batch["audio"]
        rec, mu, logvar = model(x, eps)
        nll = recon_losses(rec, x)
        kl = kl_term(mu, logvar)
        scores, _ = discriminator(rec[..., 0])
        g_adv = losses.generator_adv_loss([scores])
        params = g_state.params()

        def norm(loss):
            g = torch.autograd.grad(loss, params, retain_graph=True,
                                    allow_unused=True)
            return global_norm([t for t in g if t is not None])

        adaptive = torch.clamp(norm(nll) / (norm(g_adv) + 1e-4), 0.0, 1e4)
        use_gan = float(g_state.step >= cfg.disc_start)
        total = (nll + cfg.kl_weight * kl
                 + use_gan * cfg.gan_weight * adaptive * g_adv)
        backward_and_update(g_state, total)
        return g_state, {"gen/loss": total.detach(), "gen/nll": nll.detach(),
                         "gen/kl": kl.detach(), "gen/g_adv": g_adv.detach(),
                         "gen/adaptive_w": adaptive}

    def disc_step(d_state: TrainState, batch, eps):
        x = batch["audio"]
        with torch.no_grad():
            rec, _, _ = model(x, eps)
        real_s, _ = discriminator(x[..., 0])
        fake_s, _ = discriminator(rec[..., 0])
        loss = losses.discriminator_loss([real_s], [fake_s])
        backward_and_update(d_state, loss)
        return d_state, {"disc/loss": loss.detach()}

    return gen_step, disc_step
