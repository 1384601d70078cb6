"""The DiTo image track: a 2-D diffusion-tokenizer autoencoder and its
latent prior.

Port of minimax_speech_tpu/flowae/image.py: an f8 strided conv encoder
to 4-channel latents, the 2-D consistency UNet (or a DiT2D) as the
renderer, FM timescale 1000 and 50 render steps; a class-conditional
prior (a DiT2D over the latent grid, class index n_classes the CFG null
token); PSNR eval and PNG sample grids.

Images are (B, H, W, C) in [-1, 1] at the surface, as in the JAX
package. Draws come in as arguments (dito.DiToDraws, ImageZDMDraws, the
Euler start noise, or a torch.Generator to draw it). The grid writer
encodes its PNG with zlib, so it needs no PIL.
"""
from __future__ import annotations

import dataclasses
import struct
import zlib
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
from torch import nn

from minimax_speech_torch.flowae import fm as fm_lib
from minimax_speech_torch.flowae.consistency_unet import (
    ConsistencyUNet, ConsistencyUNetConfig)
from minimax_speech_torch.flowae.dit import DiT2D, DiTConfig
from minimax_speech_torch.flowae.dito import (ConvEncoder, DiToBase,
                                              sample_renderer)
from minimax_speech_torch.flowae.trainer import ema_update, make_ae_step
from minimax_speech_torch.flowae.zdm import (check_prior, normalize_latents,
                                             start_noises)
from minimax_speech_torch.train.schedule import global_norm
from minimax_speech_torch.train.steps import TrainState, backward_and_update
from minimax_speech_torch.utils.device import module_device


@dataclass(frozen=True)
class DiToImageConfig:
    in_channels: int = 3
    z_dim: int = 4                  # f8c4: 4-channel latents
    enc_channels: int = 64
    enc_strides: tuple = (2, 2, 2)  # f8: total downsample 8x
    renderer_type: str = "unet"     # 'unet' | 'dit'
    unet: ConsistencyUNetConfig = field(
        default_factory=lambda: ConsistencyUNetConfig(dims=2))
    renderer: DiTConfig = field(default_factory=lambda: DiTConfig(
        hidden=192, depth=6, num_heads=6, patch=8, in_channels=3,
        out_channels=3, cond_dim=4))
    fm: fm_lib.FMConfig = field(
        default_factory=lambda: fm_lib.FMConfig(timescale=1000.0))
    render_n_steps: int = 50
    renderer_guidance: float = 1.0


class ConvEncoder2D(ConvEncoder):
    """The f8 encoder: SAME convs of kernel 2s and stride s, GroupNorm(8)
    (1 group where a width does not divide by 8), silu, then a 3x3 head
    to (mu, logvar)."""

    def __init__(self, cfg: DiToImageConfig):
        super().__init__(cfg, dims=2, groups=None)


class DiToImage(DiToBase):
    """The image DiTo, built for images of hw = (H, W) (the DiT
    renderer's position table; the UNet takes any multiple of 8)."""

    def __init__(self, cfg: DiToImageConfig = DiToImageConfig(),
                 hw=(32, 32)):
        super().__init__()
        self.cfg = cfg
        self.encoder = ConvEncoder2D(cfg)
        if cfg.renderer_type == "unet":
            self.renderer = ConsistencyUNet(dataclasses.replace(
                cfg.unet, dims=2, in_channels=cfg.in_channels,
                out_channels=cfg.in_channels, z_dec_channels=cfg.z_dim))
        else:
            self.renderer = DiT2D(cfg.renderer, hw=tuple(hw))
        self.drop_z_emb = nn.Parameter(torch.zeros(1, 1, 1, cfg.z_dim))


def dito_image_decode(model: DiToImage, z, out_hw, noise=None,
                      generator: Optional[torch.Generator] = None,
                      n_steps: Optional[int] = None,
                      guidance: Optional[float] = None):
    """Latent grid (B, h, w, z_dim) -> images (B, H, W, C) by FM Euler
    sampling from `noise` (or a draw of `generator`)."""
    shape = (z.shape[0],) + tuple(out_hw) + (model.cfg.in_channels,)
    return sample_renderer(model, z, shape, n_steps, guidance, noise,
                           generator)


def make_dito_image_step(model: DiToImage, kl_weight: float = 1e-4,
                         zaug_p: float = 0.1, ema_decay: float = 0.9999,
                         bf16: bool = False, device=None):
    """step(state, ema, batch{'image': (B, H, W, C) in [-1, 1]}, draws)
    -> (state, ema, metrics{loss, grad_norm, rec, kl}); draws a
    dito.DiToDraws. The model must live on `device` (default cuda, which
    raises without a GPU)."""
    return make_ae_step(model, "image", kl_weight, zaug_p, ema_decay, bf16,
                        device)


# ---------------------------------------------------------------------------
# the image latent prior (a ZDM over the 2-D latent grid)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ImageZDMConfig:
    z_dim: int = 4
    net: DiTConfig = field(default_factory=lambda: DiTConfig(
        hidden=128, depth=4, num_heads=4, patch=2, in_channels=4,
        out_channels=4, cond_dim=0))
    fm: fm_lib.FMConfig = field(default_factory=fm_lib.FMConfig)
    n_steps: int = 18
    ema_rate: float = 0.9999
    # class-conditional prior: class index n_classes is the CFG null token
    n_classes: int = 0              # 0 = unconditional
    class_emb_dim: int = 64
    label_drop: float = 0.1
    guidance: float = 1.0


class ImageZDMNet(nn.Module):
    """DiT2D over the latent grid, built for z_hw; class-conditional
    through an embedding of n_classes + 1 rows when n_classes > 0."""

    def __init__(self, cfg: ImageZDMConfig = ImageZDMConfig(), z_hw=(4, 4)):
        super().__init__()
        self.cfg = cfg
        if cfg.n_classes > 0:
            self.class_emb = nn.Embedding(cfg.n_classes + 1,
                                          cfg.class_emb_dim)
        self.dit = DiT2D(cfg.net, hw=tuple(z_hw))

    def forward(self, x, t, class_labels=None):
        z_dec = None
        if self.cfg.n_classes > 0:
            if class_labels is None:
                raise ValueError("class-conditional ZDM needs class_labels")
            z_dec = self.class_emb(class_labels.long())
        return self.dit(x, t, z_dec=z_dec)


@dataclass
class ImageZDMDraws:
    """One prior step's draws: fm for the latent grid's shape; drop (B,)
    bool, the labels that fall to the null class (class-conditional)."""
    fm: fm_lib.FMDraws
    drop: torch.Tensor

    def to(self, device) -> "ImageZDMDraws":
        return ImageZDMDraws(self.fm.to(device), self.drop.to(device))


def make_image_zdm_draws(cfg: ImageZDMConfig, z_shape,
                         generator: torch.Generator) -> ImageZDMDraws:
    fm = fm_lib.make_fm_draws(cfg.fm, z_shape, generator)
    return ImageZDMDraws(fm, torch.rand(
        z_shape[0], generator=generator,
        device=generator.device) < cfg.label_drop)


def make_image_zdm_step(zdm: ImageZDMNet, ae: DiToImage,
                        ema_decay: Optional[float] = None, device=None):
    """The frozen-autoencoder prior's step over batch{'image', 'label'}:
    with n_classes > 0 the labels condition the prior and draws.drop's
    rows fall to the null class, so CFG has an unconditional branch.
    Returns step(state, ema, batch, draws) -> (state, ema,
    metrics{zdm/loss, zdm/grad_norm}). Both modules must live on
    `device` (default cuda, which raises without a GPU)."""
    cfg = zdm.cfg
    decay = ema_decay if ema_decay is not None else cfg.ema_rate
    check_prior(device, zdm, ae)

    def step(state: TrainState, ema, batch, draws: ImageZDMDraws):
        with torch.no_grad():
            _, mu, _ = ae.encode(batch["image"])
            z = normalize_latents(mu)
        labels = None
        if cfg.n_classes > 0:
            labels = torch.where(draws.drop, cfg.n_classes,
                                 batch["label"].long())
        loss = fm_lib.fm_loss(
            lambda x_t, t: zdm(x_t, t, class_labels=labels), z, cfg.fm,
            draws.fm)
        grads = backward_and_update(state, loss)
        ema_update(ema, state.params(), decay)
        return state, ema, {"zdm/loss": loss.detach(),
                            "zdm/grad_norm": global_norm(grads)}

    return step


@torch.no_grad()
def image_zdm_generate(zdm: ImageZDMNet, ae: DiToImage, batch_size: int,
                       z_hw, out_hw, noise=None,
                       generator: Optional[torch.Generator] = None,
                       n_steps: Optional[int] = None,
                       render_steps: Optional[int] = None,
                       class_labels=None,
                       guidance: Optional[float] = None):
    """Sample normalised z (class-conditional with CFG against the null
    class when the prior has classes), decode. noise: (the prior's start
    noise (B, h, w, z_dim), the renderer's (B, H, W, C)), else drawn from
    `generator` in that order."""
    cfg = zdm.cfg
    dev = module_device(zdm)
    nz, nd = start_noises(noise, generator, [
        (batch_size,) + tuple(z_hw) + (cfg.z_dim,),
        (batch_size,) + tuple(out_hw) + (ae.cfg.in_channels,)], dev)
    net_kwargs, uncond_kwargs, g = None, None, 1.0
    if cfg.n_classes > 0:
        if class_labels is None:
            raise ValueError("class-conditional ZDM needs class_labels")
        labels = torch.as_tensor(np.asarray(class_labels), device=dev).long()
        net_kwargs = {"class_labels": labels}
        g = cfg.guidance if guidance is None else guidance
        if g != 1.0:
            uncond_kwargs = {"class_labels": torch.full_like(
                labels, cfg.n_classes)}
    z = fm_lib.euler_sample(zdm, nz, n_steps or cfg.n_steps, cfg.fm,
                            net_kwargs, uncond_kwargs, g)
    return dito_image_decode(ae, z, out_hw, nd, n_steps=render_steps)


@torch.no_grad()
def eval_image_reconstruction(model: DiToImage, images, noise=None,
                              generator: Optional[torch.Generator] = None,
                              n_steps: Optional[int] = None) -> dict:
    """MSE and PSNR on [-1, 1] images mapped to [0, 1]."""
    _, mu, _ = model.encode(images)
    rec = dito_image_decode(model, mu, images.shape[1:3], noise, generator,
                            n_steps)
    pred = torch.clamp(rec * 0.5 + 0.5, 0.0, 1.0)
    gt = torch.clamp(images * 0.5 + 0.5, 0.0, 1.0)
    mse = torch.mean((pred - gt) ** 2, dim=(1, 2, 3))
    psnr = torch.mean(-10.0 * torch.log10(torch.clamp(mse, min=1e-12)))
    return {"eval/mse": torch.mean(mse), "eval/psnr": psnr}


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray):
    """(H, W) grey or (H, W, 3) RGB uint8 as an 8-bit PNG."""
    h, w = img.shape[:2]
    color = 0 if img.ndim == 2 else 2
    rows = np.ascontiguousarray(img).reshape(h, -1)
    raw = b"".join(b"\x00" + r.tobytes() for r in rows)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color,
                                                  0, 0, 0))
                + _png_chunk(b"IDAT", zlib.compress(raw))
                + _png_chunk(b"IEND", b""))


def save_image_grid(images: np.ndarray, path: str, cols: int = 4):
    """[-1, 1] (N, H, W, C) -> a PNG grid, `cols` images a row."""
    arr = np.clip(np.asarray(images) * 0.5 + 0.5, 0, 1)
    n, h, w, c = arr.shape
    cols = min(cols, n)
    rows = (n + cols - 1) // cols
    grid = np.zeros((rows * h, cols * w, c), np.float32)
    for i in range(n):
        r, col = divmod(i, cols)
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = arr[i]
    img = (grid * 255).astype(np.uint8)
    write_png(path, img[..., 0] if c == 1 else img)
