"""The VQGAN stack of the GLPTo image track.

Port of minimax_speech_tpu/flowae/vqgan.py: a taming-transformers VQGAN
(ResNet encoder and decoder with mid attention, a nearest-codebook
VectorQuantizer with the straight-through estimator and commitment
loss), a PatchGAN discriminator, a VGG16-shaped LPIPS perceptual
distance (random features unless weights are loaded), and the adaptive
generator/GAN weight from the gradients at the decoder's last conv.

Images are (B, H, W, C) at the surface, as in the JAX package; the
convolutions run channels-first inside. The codebook parameter is kept
as flax stores it, uniform(0, 2/n), and shifted by -1/n in the forward
pass.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from minimax_speech_torch.flowae.consistency_unet import GN_EPS
from minimax_speech_torch.train.steps import TrainState, backward_and_update
from minimax_speech_torch.utils.device import check_on, resolve_device


def _cl(x):  # channels-first -> channel-last
    return x.movedim(1, -1)


def _cf(x):  # channel-last -> channels-first
    return x.movedim(-1, 1)


# ---------------------------------------------------------------- quantizer
class VectorQuantizer(nn.Module):
    """Nearest-codebook VQ with straight-through gradients; z (..., e_dim)
    channel-last. Returns (z_q, loss, indices)."""

    def __init__(self, n_e: int, e_dim: int, beta: float = 0.25):
        super().__init__()
        self.n_e, self.e_dim, self.beta = n_e, e_dim, beta
        self.embedding = nn.Parameter(torch.zeros(n_e, e_dim))

    def init_weights(self, generator):
        self.embedding.uniform_(0.0, 2.0 / self.n_e, generator=generator)

    def codebook(self):
        return self.embedding - 1.0 / self.n_e  # uniform(-1/n, 1/n)

    def forward(self, z):
        emb = self.codebook()
        flat = z.reshape(-1, self.e_dim)
        d = (torch.sum(flat ** 2, dim=1, keepdim=True)
             + torch.sum(emb ** 2, dim=1)[None]
             - 2.0 * flat @ emb.T)
        idx = torch.argmin(d, dim=1)
        z_q = emb[idx].reshape(z.shape)
        commit = torch.mean((z_q.detach() - z) ** 2)
        embed = torch.mean((z_q - z.detach()) ** 2)
        loss = self.beta * commit + embed
        z_q = z + (z_q - z).detach()  # straight-through
        return z_q, loss, idx.reshape(z.shape[:-1])

    def lookup(self, indices):
        return self.codebook()[indices]


# ------------------------------------------------------------ encoder/decoder
def _gn(channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(min(32, channels), channels, eps=GN_EPS)


def _conv3(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1)


class ResnetBlock(nn.Module):
    """GroupNorm-swish-conv twice, + a 1x1 shortcut where the width
    changes. Channels-first."""

    def __init__(self, cin: int, out_ch: int):
        super().__init__()
        self.norm1 = _gn(cin)
        self.conv1 = _conv3(cin, out_ch)
        self.norm2 = _gn(out_ch)
        self.conv2 = _conv3(out_ch, out_ch)
        if cin != out_ch:
            self.nin_shortcut = nn.Conv2d(cin, out_ch, 1)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head spatial self-attention (plain torch). Channels-first."""

    def __init__(self, c: int):
        super().__init__()
        self.norm = _gn(c)
        self.q = nn.Conv2d(c, c, 1)
        self.k = nn.Conv2d(c, c, 1)
        self.v = nn.Conv2d(c, c, 1)
        self.proj_out = nn.Conv2d(c, c, 1)

    def forward(self, x):
        b, c, hh, ww = x.shape
        h = self.norm(x)
        q = self.q(h).reshape(b, c, hh * ww).transpose(1, 2)
        k = self.k(h).reshape(b, c, hh * ww).transpose(1, 2)
        v = self.v(h).reshape(b, c, hh * ww).transpose(1, 2)
        w = torch.softmax(q @ k.transpose(1, 2) / math.sqrt(c), dim=-1)
        o = (w @ v).transpose(1, 2).reshape(b, c, hh, ww)
        return x + self.proj_out(o)


@dataclass(frozen=True)
class VQGANConfig:
    in_channels: int = 3
    ch: int = 32
    ch_mult: Tuple[int, ...] = (1, 2, 4)
    num_res_blocks: int = 1
    z_channels: int = 16
    n_embed: int = 256
    embed_dim: int = 16
    beta: float = 0.25
    attn_mid: bool = True


def _add_mid(owner: nn.Module, c: int, attn: bool):
    """mid_block_1, mid_attn (with attn) and mid_block_2 on `owner`."""
    owner.mid_block_1 = ResnetBlock(c, c)
    if attn:
        owner.mid_attn = AttnBlock(c)
    owner.mid_block_2 = ResnetBlock(c, c)


def _run_mid(owner: nn.Module, h):
    h = owner.mid_block_1(h)
    if hasattr(owner, "mid_attn"):
        h = owner.mid_attn(h)
    return owner.mid_block_2(h)


class VQGANEncoder(nn.Module):
    """Channels-first (B, C, H, W) -> (B, z_channels, H / 2^(L-1), ...)."""

    def __init__(self, cfg: VQGANConfig):
        super().__init__()
        self.cfg = c = cfg
        self.conv_in = _conv3(c.in_channels, c.ch)
        ch = c.ch
        for i, m in enumerate(c.ch_mult):
            for j in range(c.num_res_blocks):
                self.add_module(f"down_{i}_block_{j}",
                                ResnetBlock(ch, c.ch * m))
                ch = c.ch * m
            if i != len(c.ch_mult) - 1:
                self.add_module(f"down_{i}_downsample", _conv3(ch, ch, 2))
        _add_mid(self, ch, c.attn_mid)
        self.norm_out = _gn(ch)
        self.conv_out = _conv3(ch, c.z_channels)

    def forward(self, x):
        c = self.cfg
        h = self.conv_in(x)
        for i in range(len(c.ch_mult)):
            for j in range(c.num_res_blocks):
                h = getattr(self, f"down_{i}_block_{j}")(h)
            if i != len(c.ch_mult) - 1:
                h = getattr(self, f"down_{i}_downsample")(h)
        h = _run_mid(self, h)
        return self.conv_out(F.silu(self.norm_out(h)))


class VQGANDecoder(nn.Module):
    """Channels-first (B, z_channels, h, w) -> (B, C, H, W)."""

    def __init__(self, cfg: VQGANConfig):
        super().__init__()
        self.cfg = c = cfg
        ch = c.ch * c.ch_mult[-1]
        self.conv_in = _conv3(c.z_channels, ch)
        _add_mid(self, ch, c.attn_mid)
        for i, m in enumerate(reversed(c.ch_mult)):
            for j in range(c.num_res_blocks):
                self.add_module(f"up_{i}_block_{j}",
                                ResnetBlock(ch, c.ch * m))
                ch = c.ch * m
            if i != len(c.ch_mult) - 1:
                self.add_module(f"up_{i}_upsample", _conv3(ch, ch))
        self.norm_out = _gn(ch)
        self.conv_out = _conv3(ch, c.in_channels)

    def forward(self, z):
        c = self.cfg
        h = _run_mid(self, self.conv_in(z))
        for i in range(len(c.ch_mult)):
            for j in range(c.num_res_blocks):
                h = getattr(self, f"up_{i}_block_{j}")(h)
            if i != len(c.ch_mult) - 1:
                h = F.interpolate(h, scale_factor=2, mode="nearest")
                h = getattr(self, f"up_{i}_upsample")(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class VQGAN(nn.Module):
    def __init__(self, cfg: VQGANConfig = VQGANConfig()):
        super().__init__()
        c = self.cfg = cfg
        self.encoder = VQGANEncoder(c)
        self.decoder = VQGANDecoder(c)
        self.quant_conv = nn.Conv2d(c.z_channels, c.embed_dim, 1)
        self.post_quant_conv = nn.Conv2d(c.embed_dim, c.z_channels, 1)
        self.quantize = VectorQuantizer(c.n_embed, c.embed_dim, c.beta)

    def encode(self, x):
        """(B, H, W, C) -> (z_q (B, h, w, embed_dim), loss, indices)."""
        h = self.quant_conv(self.encoder(_cf(x)))
        return self.quantize(_cl(h))

    def decode(self, z_q):
        return _cl(self.decoder(self.post_quant_conv(_cf(z_q))))

    def forward(self, x):
        z_q, q_loss, idx = self.encode(x)
        return self.decode(z_q), q_loss, idx


# -------------------------------------------------------------- discriminator
class NLayerDiscriminator(nn.Module):
    """PatchGAN over (B, H, W, C) images -> (B, h, w, 1) logits."""

    def __init__(self, ndf: int = 32, n_layers: int = 3, in_channels: int = 3):
        super().__init__()
        self.n_layers = n_layers
        self.conv0 = nn.Conv2d(in_channels, ndf, 4, stride=2, padding=1)
        ch = ndf
        for n in range(1, n_layers + 1):
            out = ndf * min(2 ** n, 8)
            stride = 2 if n < n_layers else 1
            self.add_module(f"conv{n}", nn.Conv2d(ch, out, 4, stride=stride,
                                                  padding=1, bias=False))
            self.add_module(f"norm{n}", _gn(out))
            ch = out
        self.conv_out = nn.Conv2d(ch, 1, 4, padding=1)

    def forward(self, x):
        h = F.leaky_relu(self.conv0(_cf(x)), 0.2)
        for n in range(1, self.n_layers + 1):
            h = getattr(self, f"conv{n}")(h)
            h = F.leaky_relu(getattr(self, f"norm{n}")(h), 0.2)
        return _cl(self.conv_out(h))


# ---------------------------------------------------------------- perceptual
class VGGFeatures(nn.Module):
    """VGG16-shaped feature pyramid (the LPIPS backbone); the 5 relu
    stages, channels-first."""

    def __init__(self, widths: Tuple[int, ...] = (64, 128, 256, 512, 512),
                 convs_per_stage: Tuple[int, ...] = (2, 2, 3, 3, 3),
                 in_channels: int = 3):
        super().__init__()
        self.shape = list(zip(widths, convs_per_stage))
        ch = in_channels
        for s, (w, n) in enumerate(self.shape):
            for j in range(n):
                self.add_module(f"conv{s}_{j}", _conv3(ch, w))
                ch = w

    def forward(self, x):
        feats = []
        h = x
        for s, (_, n) in enumerate(self.shape):
            for j in range(n):
                h = F.relu(getattr(self, f"conv{s}_{j}")(h))
            feats.append(h)
            if s != len(self.shape) - 1:
                h = F.max_pool2d(h, 2, 2)
        return feats


class LPIPS(nn.Module):
    """Perceptual distance of (B, H, W, C) images: unit-normalised
    feature differences through per-channel |lin| weights, spatially
    averaged, summed over the stages."""

    def __init__(self, backbone: Optional[VGGFeatures] = None):
        super().__init__()
        self.backbone = backbone or VGGFeatures()
        for i, (w, _) in enumerate(self.backbone.shape):
            self.register_parameter(f"lin{i}", nn.Parameter(torch.ones(w)))

    def init_weights(self, generator):
        for i in range(len(self.backbone.shape)):
            nn.init.ones_(getattr(self, f"lin{i}"))

    def forward(self, x, y):
        total = 0.0
        for i, (a, b) in enumerate(zip(self.backbone(_cf(x)),
                                       self.backbone(_cf(y)))):
            a = a / torch.clamp(torch.linalg.vector_norm(
                a, dim=1, keepdim=True), min=1e-10)
            b = b / torch.clamp(torch.linalg.vector_norm(
                b, dim=1, keepdim=True), min=1e-10)
            w = torch.abs(getattr(self, f"lin{i}"))[None, :, None, None]
            total = total + torch.mean(torch.sum((a - b) ** 2 * w, dim=1))
        return total


# ------------------------------------------------------------------- training
def adaptive_gan_weight(rec_loss, gan_loss, last_weight: torch.Tensor,
                        max_w: float = 1e4) -> torch.Tensor:
    """lambda = ||d rec / d W|| / (||d gan / d W|| + 1e-4) at the last
    layer's weight W, clipped to [0, max_w], without gradient (the
    norms do not depend on W's layout)."""
    g_rec, = torch.autograd.grad(rec_loss, last_weight, retain_graph=True)
    g_gan, = torch.autograd.grad(gan_loss, last_weight, retain_graph=True)
    w = torch.linalg.vector_norm(g_rec) / (torch.linalg.vector_norm(g_gan)
                                           + 1e-4)
    return torch.clamp(w, 0.0, max_w).detach()


def make_vqgan_steps(model: VQGAN, disc: NLayerDiscriminator,
                     perceptual: Optional[LPIPS] = None,
                     perceptual_weight: float = 1.0,
                     disc_weight: float = 0.5, adaptive: bool = True,
                     device=None):
    """(gen_step, disc_step), each step(state, batch{'image'}) ->
    (state, metrics): the generator's L1 (+ LPIPS) + codebook loss +
    disc_weight * lambda * (-mean logits), lambda the adaptive weight at
    decoder.conv_out; the discriminator's hinge loss. The modules must
    live on `device` (default cuda, which raises without a GPU)."""
    dev = resolve_device(device)
    for what, mod in (("the VQGAN", model), ("the discriminator", disc),
                      ("the perceptual net", perceptual)):
        if mod is not None:
            check_on(mod, dev, what)

    def gen_step(g_state: TrainState, batch):
        x = batch["image"]
        rec, q_loss, _ = model(x)
        rec_l = torch.mean(torch.abs(rec - x))
        if perceptual is not None:
            rec_l = rec_l + perceptual_weight * perceptual(rec, x)
        g_loss = -torch.mean(disc(rec))
        w = adaptive_gan_weight(rec_l, g_loss, model.decoder.conv_out.weight) \
            if adaptive else torch.ones((), device=x.device)
        total = rec_l + q_loss + disc_weight * w * g_loss
        backward_and_update(g_state, total)
        return g_state, {"vq/loss": total.detach(), "vq/rec": rec_l.detach(),
                         "vq/quant": q_loss.detach(),
                         "vq/g_loss": g_loss.detach(), "vq/adaptive_w": w}

    def disc_step(d_state: TrainState, batch):
        x = batch["image"]
        with torch.no_grad():
            rec, _, _ = model(x)
        real = disc(x)
        fake = disc(rec)
        loss = 0.5 * (torch.mean(F.relu(1.0 - real))
                      + torch.mean(F.relu(1.0 + fake)))
        backward_and_update(d_state, loss)
        return d_state, {"disc/loss": loss.detach(),
                         "disc/real": real.mean().detach(),
                         "disc/fake": fake.mean().detach()}

    return gen_step, disc_step
