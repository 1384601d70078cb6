"""DiTo: the diffusion-tokenizer autoencoder (audio).

Port of minimax_speech_tpu/flowae/dito.py: a strided conv encoder to a
diagonal-Gaussian latent z, and a diffusion renderer (a DiT or the 1-D
consistency UNet conditioned on z) trained with the FM loss; decoding is
FM Euler sampling conditioned on z, with optional renderer CFG against a
learned drop-z embedding.

Channel-last at the surface, (B, T, C) audio and (B, T / 64, z_dim)
latents, as in the JAX package. The DiT renderer's position table is
sized by the clip length the model is built for (`length`); the UNet's
has no such limit. The draws of `loss` come in as a `DiToDraws`.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from minimax_speech_torch.flowae import fm as fm_lib
from minimax_speech_torch.flowae.consistency_unet import (
    GN_EPS, ConsistencyUNet, ConsistencyUNetConfig, conv)
from minimax_speech_torch.flowae.dit import DiT1D, DiTConfig
from minimax_speech_torch.utils.params_io import load_flax_params


@dataclass(frozen=True)
class DiToConfig:
    in_channels: int = 1           # waveform
    z_dim: int = 32
    enc_channels: int = 64
    enc_strides: tuple = (4, 4, 4)  # total downsample 64x
    renderer_type: str = "dit"     # 'dit' | 'unet' (consistency decoder)
    renderer: DiTConfig = field(default_factory=lambda: DiTConfig(
        hidden=192, depth=6, num_heads=6, patch=16, in_channels=1,
        out_channels=1, cond_dim=32))
    unet: ConsistencyUNetConfig = field(
        default_factory=lambda: ConsistencyUNetConfig(dims=1))
    fm: fm_lib.FMConfig = field(default_factory=fm_lib.FMConfig)
    render_n_steps: int = 18
    renderer_guidance: float = 1.0
    z_std_target: float = 1.0


def latent_length(n: int, strides) -> int:
    """The encoder's output length for n samples (SAME: ceil per stage)."""
    for s in strides:
        n = -(-n // s)
    return n


class ConvEncoder(nn.Module):
    """Strided SAME convs (kernel 2s, stride s), each followed by
    GroupNorm(8) and silu, channels doubling, then a 3-tap head to
    (mu, logvar). dims 1 takes (B, T, C), dims 2 (B, H, W, C); groups
    None is 8, or 1 where a width does not divide by 8 (the image
    encoder's rule)."""

    def __init__(self, cfg, dims: int = 1, groups: Optional[int] = 8):
        super().__init__()
        cin, ch = cfg.in_channels, cfg.enc_channels
        for i, s in enumerate(cfg.enc_strides):
            self.add_module(f"down_{i}", conv(dims, cin, ch, 2 * s, s))
            g = groups or (8 if ch % 8 == 0 else 1)
            self.add_module(f"norm_{i}", nn.GroupNorm(g, ch, eps=GN_EPS))
            cin, ch = ch, 2 * ch
        self.n = len(cfg.enc_strides)
        self.head = conv(dims, cin, 2 * cfg.z_dim, 3)

    def forward(self, x):
        h = x.movedim(-1, 1).to(self.head.weight.dtype)
        for i in range(self.n):
            h = getattr(self, f"down_{i}")(h)
            h = F.silu(getattr(self, f"norm_{i}")(h))
        return self.head(h).movedim(1, -1)


def split_latent(h: torch.Tensor, eps: Optional[torch.Tensor] = None):
    """(mu || logvar) -> (z, mu, logvar), logvar clipped to [-30, 20];
    z = mu + exp(logvar / 2) eps, or mu without eps."""
    mu, logvar = h.chunk(2, dim=-1)
    logvar = torch.clamp(logvar, -30.0, 20.0)
    if eps is None:
        return mu, mu, logvar
    return mu + torch.exp(0.5 * logvar) * eps, mu, logvar


def kl_term(mu, logvar):
    return torch.mean(0.5 * (mu ** 2 + torch.exp(logvar) - logvar - 1.0))


@dataclass
class DiToDraws:
    """The draws of one `loss` call: eps the encoder's (B, Tz, z_dim)
    standard normal; drop (B,) bool, which rows take the drop-z
    embedding (with zaug_p > 0); fm the renderer's FM draws."""
    eps: torch.Tensor
    drop: torch.Tensor
    fm: fm_lib.FMDraws

    def to(self, device) -> "DiToDraws":
        return DiToDraws(self.eps.to(device), self.drop.to(device),
                         self.fm.to(device))


def make_dito_draws(cfg, x_shape, generator: torch.Generator,
                    zaug_p: float = 0.0) -> DiToDraws:
    """DiToDraws for x of `x_shape` (audio or image, `cfg` a DiToConfig
    or DiToImageConfig) from `generator`, on its device."""
    dev = generator.device
    zs = tuple(latent_length(n, cfg.enc_strides) for n in x_shape[1:-1])
    eps = torch.randn((x_shape[0],) + zs + (cfg.z_dim,),
                      generator=generator, device=dev)
    drop = torch.rand(x_shape[0], generator=generator, device=dev) < zaug_p
    return DiToDraws(eps, drop, fm_lib.make_fm_draws(cfg.fm, x_shape,
                                                     generator))


class DiToBase(nn.Module):
    """What the audio and image DiTo share: encode to the diagonal
    Gaussian, the renderer's call and the training loss. A subclass
    builds `encoder`, `renderer` and `drop_z_emb`."""

    def init_weights(self, generator):
        self.drop_z_emb.normal_(0.0, 0.02, generator=generator)

    def encode(self, x, eps: Optional[torch.Tensor] = None):
        """x: channel-last -> (z, mu, logvar); z = mu without eps."""
        return split_latent(self.encoder(x), eps)

    def render_net(self, x_t, t, z_dec):
        return self.renderer(x_t, t, z_dec=z_dec)

    def loss(self, x, draws: DiToDraws, zaug_p: float = 0.0):
        """(FM reconstruction loss through the latent bottleneck, KL, z);
        with zaug_p > 0 the rows draws.drop take the drop embedding in
        place of z (training the unconditional branch)."""
        z, mu, logvar = self.encode(x, draws.eps)
        if zaug_p > 0:
            keep = ~draws.drop.reshape((-1,) + (1,) * (z.ndim - 1))
            z = torch.where(keep, z, self.drop_z_emb.expand_as(z))
        rec = fm_lib.fm_loss(self.render_net, x, self.cfg.fm, draws.fm,
                             net_kwargs={"z_dec": z})
        return rec, kl_term(mu, logvar), z


class DiToAudio(DiToBase):
    """The audio DiTo, built for clips of `length` samples (the DiT
    renderer's position table)."""

    def __init__(self, cfg: DiToConfig = DiToConfig(), length: int = 4096):
        super().__init__()
        self.cfg = cfg
        self.encoder = ConvEncoder(cfg)
        if cfg.renderer_type == "unet":
            self.renderer = ConsistencyUNet(dataclasses.replace(
                cfg.unet, dims=1, in_channels=cfg.in_channels,
                out_channels=cfg.in_channels, z_dec_channels=cfg.z_dim))
        else:
            self.renderer = DiT1D(cfg.renderer,
                                  n_tok=length // cfg.renderer.patch)
        # the learned unconditional embedding of renderer CFG
        self.drop_z_emb = nn.Parameter(torch.zeros(1, 1, cfg.z_dim))


def dito_from_tree(cfg: DiToConfig, tree: dict) -> DiToAudio:
    """A DiToAudio holding a flax variables tree (params_io.load_params),
    its DiT renderer sized by the tree's position table."""
    length = 4096
    if cfg.renderer_type != "unet":
        pos = tree.get("params", tree)["renderer"]["pos_emb"]
        length = pos.shape[1] * cfg.renderer.patch
    return load_flax_params(DiToAudio(cfg, length), tree)


def draw_normal(shape, generator=None, device=None) -> torch.Tensor:
    """Standard normal `shape` from `generator` on its own device (a host
    generator gives the same numbers for every device), on `device`."""
    gdev = generator.device if generator is not None else device
    return torch.randn(shape, generator=generator, device=gdev).to(device)


def start_noise(shape, z: torch.Tensor, noise=None, generator=None):
    """The Euler start noise: `noise` as given, else a draw of
    `generator`, on z's device."""
    if noise is not None:
        return noise.to(z.device)
    return draw_normal(shape, generator, z.device)


def sample_renderer(model, z, shape, n_steps, guidance, noise, generator):
    """FM Euler sampling of model.render_net conditioned on z, CFG
    against the drop-z embedding when guidance != 1 (the DiTo decode of
    either track)."""
    cfg = model.cfg
    n_steps = n_steps or cfg.render_n_steps
    guidance = guidance if guidance is not None else cfg.renderer_guidance
    uncond = None
    if guidance != 1.0:
        uncond = {"z_dec": model.drop_z_emb.expand_as(z)}
    return fm_lib.euler_sample(
        model.render_net, start_noise(shape, z, noise, generator), n_steps,
        cfg.fm, net_kwargs={"z_dec": z}, uncond_net_kwargs=uncond,
        guidance=guidance)


def dito_decode(model: DiToAudio, z, out_len: int, noise=None,
                generator: Optional[torch.Generator] = None,
                n_steps: Optional[int] = None,
                guidance: Optional[float] = None):
    """A waveform (B, out_len, C) from latents z by FM Euler sampling
    from `noise` (or a draw of `generator`)."""
    return sample_renderer(model, z, (z.shape[0], out_len,
                                      model.cfg.in_channels),
                           n_steps, guidance, noise, generator)
