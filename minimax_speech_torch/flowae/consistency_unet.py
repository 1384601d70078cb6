"""Consistency-decoder UNet renderers (1-D audio, 2-D image).

Port of minimax_speech_tpu/flowae/consistency_unet.py: positional time
embedding, FiLM-style (t1 + 1, t2) modulation in every block, 3
downsample stages of 3 resblocks + pool, a bottleneck, and an upsample
path where every resblock consumes one skip (16 skips, the stem's
included). The audio layout projects z_dec and concatenates it after
the stem; the image layout concatenates the raw z before it.

The public forward takes and returns channel-last tensors, (B, T, C) or
(B, H, W, C), as the JAX package; inside, the blocks run channels-first.
Resizing is linear in 1-D and nearest in 2-D with half-pixel centres,
as jax.image.resize; pooling is VALID; GroupNorm's epsilon is flax's
1e-6, with one group where the width does not divide by `groups`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

GN_EPS = 1e-6  # flax GroupNorm's


@dataclass(frozen=True)
class ConsistencyUNetConfig:
    dims: int = 1                # 1 = (B, T, C) audio, 2 = (B, H, W, C)
    in_channels: int = 1
    out_channels: int = 1
    z_dec_channels: Optional[int] = None
    c0: int = 128
    c1: int = 256
    c2: int = 512
    pe_dim: int = 320
    t_dim: int = 1280
    kernel: int = 3
    groups: int = 32             # GroupNorm groups (reference: 32)


def positional_time_embedding(t: torch.Tensor, pe_dim: int,
                              max_positions: float = 10000.0,
                              endpoint: bool = True) -> torch.Tensor:
    """(B,) -> (B, pe_dim) cos || sin embedding."""
    half = pe_dim // 2
    freqs = np.arange(half, dtype=np.float32)
    freqs = freqs / (half - (1 if endpoint else 0))
    freqs = (1.0 / max_positions) ** freqs
    ang = t[:, None].float() * torch.as_tensor(freqs, device=t.device)[None]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def group_norm(cfg: ConsistencyUNetConfig, channels: int) -> nn.GroupNorm:
    g = cfg.groups if channels % cfg.groups == 0 else 1
    return nn.GroupNorm(g, channels, eps=GN_EPS)


def conv(dims: int, cin: int, cout: int, kernel: int, stride: int = 1,
         bias: bool = True) -> nn.Module:
    """flax nn.Conv(padding="SAME"): a stride-1 odd kernel pads evenly
    through torch's own padding; otherwise SameConv1d/2d pad explicitly."""
    if kernel % 2 and stride == 1:
        cls = nn.Conv1d if dims == 1 else nn.Conv2d
        return cls(cin, cout, kernel, padding=kernel // 2, bias=bias)
    cls = SameConv1d if dims == 1 else SameConv2d
    return cls(cin, cout, kernel, stride=stride, bias=bias)


class _SamePad:
    """flax's SAME padding for a strided conv: per spatial axis the total
    pad max((ceil(n / s) - 1) s + k - n, 0), split (total // 2, the
    rest), padded explicitly before a conv with none (torch pads only
    evenly)."""

    def forward(self, x):
        pads = []
        for i in reversed(range(x.ndim - 2)):  # F.pad: last axis first
            n, k, s = x.shape[2 + i], self.kernel_size[i], self.stride[i]
            total = max((-(-n // s) - 1) * s + k - n, 0)
            pads += [total // 2, total - total // 2]
        return super().forward(F.pad(x, pads))


class SameConv1d(_SamePad, nn.Conv1d):
    pass


class SameConv2d(_SamePad, nn.Conv2d):
    pass


def resize(x: torch.Tensor, size, dims: int) -> torch.Tensor:
    """Channels-first x to spatial `size`: linear (1-D) or nearest (2-D),
    half-pixel centres, as jax.image.resize up-samples."""
    if dims == 1:
        return F.interpolate(x, size=tuple(size), mode="linear",
                             align_corners=False)
    return F.interpolate(x, size=tuple(size), mode="nearest-exact")


def _film(tm: torch.Tensor, dims: int):
    """(B, 2F) -> (t1 + 1, t2), each (B, F, 1...) channels-first."""
    t1, t2 = tm.chunk(2, dim=-1)
    sp = (1,) * dims
    return (t1.reshape(t1.shape + sp) + 1.0, t2.reshape(t2.shape + sp))


class ConvResblock(nn.Module):
    """GN -> silu -> conv -> GN -> FiLM(t) -> silu -> conv (+ 1x1 skip)."""

    def __init__(self, cfg: ConsistencyUNetConfig, cin: int, features: int):
        super().__init__()
        d = cfg.dims
        self.dims = d
        self.f_t = nn.Linear(cfg.t_dim, 2 * features)
        self.gn_1 = group_norm(cfg, cin)
        self.f_1 = conv(d, cin, features, cfg.kernel)
        self.gn_2 = group_norm(cfg, features)
        self.f_2 = conv(d, features, features, cfg.kernel)
        if cin != features:
            cls = nn.Conv1d if d == 1 else nn.Conv2d
            self.f_s = cls(cin, features, 1)

    def forward(self, x, t_emb):
        t1, t2 = _film(self.f_t(F.silu(t_emb)), self.dims)
        h = self.f_1(F.silu(self.gn_1(x)))
        h = self.f_2(F.silu(self.gn_2(h) * t1 + t2))
        skip = self.f_s(x) if hasattr(self, "f_s") else x
        return skip + h


class Resample(nn.Module):
    """Down (2x average pool) or up (2x resize) block with the same FiLM
    modulation."""

    def __init__(self, cfg: ConsistencyUNetConfig, feats: int, up: bool):
        super().__init__()
        d = cfg.dims
        self.dims, self.up = d, up
        self.f_t = nn.Linear(cfg.t_dim, 2 * feats)
        self.gn_1 = group_norm(cfg, feats)
        self.f_1 = conv(d, feats, feats, cfg.kernel)
        self.gn_2 = group_norm(cfg, feats)
        self.f_2 = conv(d, feats, feats, cfg.kernel)

    def _scale(self, v):
        if self.up:
            return resize(v, [2 * s for s in v.shape[2:]], self.dims)
        pool = F.avg_pool1d if self.dims == 1 else F.avg_pool2d
        return pool(v, 2, 2)

    def forward(self, x, t_emb):
        t1, t2 = _film(self.f_t(F.silu(t_emb)), self.dims)
        h = self.f_1(self._scale(F.silu(self.gn_1(x))))
        h = self.f_2(F.silu(self.gn_2(h) * t1 + t2))
        return h + self._scale(x)


class ConsistencyUNet(nn.Module):
    """x: (B, T, C) or (B, H, W, C); t: (B,); z_dec: latent conditioning
    (B, Tz, Cz) or (B, h, w, Cz) at a coarser rate, resized and
    concatenated (required when cfg.z_dec_channels is set). Spatial
    sizes must divide by 8 (three 2x pools)."""

    def __init__(self, cfg: ConsistencyUNetConfig = ConsistencyUNetConfig()):
        super().__init__()
        self.cfg = c = cfg
        d, k = c.dims, c.kernel
        zc = c.z_dec_channels
        stem_in = c.in_channels + (zc if d == 2 and zc else 0)
        self.embed = conv(d, stem_in, c.c0, k)
        ch = c.c0
        if d == 1 and zc:
            self.z_proj = nn.Conv1d(zc, c.c0, 1)
            ch = 2 * c.c0
        self.time_f1 = nn.Linear(c.pe_dim, c.t_dim)
        self.time_f2 = nn.Linear(c.t_dim, c.t_dim)
        widths = (c.c0, c.c1, c.c2, c.c2)
        skips = [ch]
        for s, w in enumerate(widths):
            for i in range(3):
                self.add_module(f"down_{s}_{i}", ConvResblock(c, ch, w))
                ch = w
                skips.append(ch)
            if s < 3:
                self.add_module(f"down_{s}_pool", Resample(c, ch, up=False))
                skips.append(ch)
        for i in range(2):
            self.add_module(f"mid_{i}", ConvResblock(c, ch, c.c2))
            ch = c.c2
        for s in (3, 2, 1, 0):
            w = widths[s]
            for i in range(4):
                self.add_module(f"up_{s}_{i}",
                                ConvResblock(c, ch + skips.pop(), w))
                ch = w
            if s > 0:
                self.add_module(f"up_{s}_resample", Resample(c, ch, up=True))
        self.out_gn = group_norm(c, c.c0)
        self.out_conv = conv(d, c.c0, c.out_channels, k)

    def forward(self, x, t=None, z_dec=None):
        c = self.cfg
        d = c.dims
        last = (0, d + 1) + tuple(range(1, d + 1))   # channel-last -> first
        first = (0,) + tuple(range(2, d + 2)) + (1,)  # and back
        dtype = self.embed.weight.dtype
        x = x.permute(last).to(dtype)
        if t is None:
            t = torch.zeros((x.shape[0],), device=x.device)
        if z_dec is not None:
            z_dec = z_dec.permute(last).to(dtype)
        if d == 2 and z_dec is not None:
            x = torch.cat([x, resize(z_dec, x.shape[2:], d)], dim=1)
        h = self.embed(x)
        if d == 1 and z_dec is not None:
            zp = self.z_proj(z_dec)
            h = torch.cat([h, resize(zp, h.shape[2:], d)], dim=1)

        te = positional_time_embedding(t, c.pe_dim)
        te = self.time_f2(F.silu(self.time_f1(te)))

        skips = [h]
        for s in range(4):
            for i in range(3):
                h = getattr(self, f"down_{s}_{i}")(h, te)
                skips.append(h)
            if s < 3:
                h = getattr(self, f"down_{s}_pool")(h, te)
                skips.append(h)
        for i in range(2):
            h = getattr(self, f"mid_{i}")(h, te)
        for s in (3, 2, 1, 0):
            for i in range(4):
                h = getattr(self, f"up_{s}_{i}")(
                    torch.cat([h, skips.pop()], dim=1), te)
            if s > 0:
                h = getattr(self, f"up_{s}_resample")(h, te)
        h = self.out_conv(F.silu(self.out_gn(h)))
        return h.permute(first)
