"""DiT: a diffusion transformer with adaLN-zero conditioning.

Port of minimax_speech_tpu/flowae/dit.py, in 1-D (audio latents or
waveform frames) and 2-D (image patches). The timestep (and an optional
context vector) modulates every block through adaLN-zero: shift, scale
and gate from a silu-Linear, zero-initialised. Inputs and outputs are
channel-last, (B, T, C) and (B, H, W, C), as in the JAX package.

The attention is plain torch, as the JAX package's is plain XLA:
softmax(QK^T / sqrt(d)) in float32, cast back to x's dtype. The learned
position table is sized by the token count the module is built for; a
shorter input takes its first rows (1-D), a longer one raises.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from minimax_speech_torch.models.decoder_unet import sinusoidal_pos_emb

EPS = 1e-6  # flax LayerNorm's


@dataclass(frozen=True)
class DiTConfig:
    hidden: int = 384          # DiT-S
    depth: int = 12
    num_heads: int = 6
    patch: int = 4             # patch length along time
    in_channels: int = 1
    out_channels: int = 1
    cond_dim: int = 0          # extra conditioning channels (z_dec), 0 = none
    mlp_ratio: int = 4


def _norm(d: int) -> nn.LayerNorm:
    return nn.LayerNorm(d, eps=EPS, elementwise_affine=False)


class _ZeroLinear(nn.Linear):
    """A Linear that flax initialises at zero (adaLN, final_proj)."""

    def init_weights(self, generator):
        nn.init.zeros_(self.weight)
        nn.init.zeros_(self.bias)


class DiTBlock(nn.Module):
    def __init__(self, hidden: int, num_heads: int, mlp_ratio: int = 4):
        super().__init__()
        self.num_heads = num_heads
        self.adaLN = _ZeroLinear(hidden, 6 * hidden)
        self.norm1 = _norm(hidden)
        self.q = nn.Linear(hidden, hidden)
        self.k = nn.Linear(hidden, hidden)
        self.v = nn.Linear(hidden, hidden)
        self.proj = nn.Linear(hidden, hidden)
        self.norm2 = _norm(hidden)
        self.mlp_in = nn.Linear(hidden, mlp_ratio * hidden)
        self.mlp_out = nn.Linear(mlp_ratio * hidden, hidden)

    def forward(self, x, c):
        """x: (B, T, D); c: (B, D) conditioning."""
        sh1, sc1, g1, sh2, sc2, g2 = self.adaLN(F.silu(c)).chunk(6, dim=-1)
        h = self.norm1(x) * (1 + sc1[:, None]) + sh1[:, None]
        b, t, d = h.shape
        hd = d // self.num_heads
        q = self.q(h).reshape(b, t, self.num_heads, hd)
        k = self.k(h).reshape(b, t, self.num_heads, hd)
        v = self.v(h).reshape(b, t, self.num_heads, hd)
        w = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        w = torch.softmax(w.float(), dim=-1).to(x.dtype)
        a = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, t, d)
        x = x + g1[:, None] * self.proj(a)

        h = self.norm2(x) * (1 + sc2[:, None]) + sh2[:, None]
        h = F.gelu(self.mlp_in(h), approximate="tanh")
        return x + g2[:, None] * self.mlp_out(h)


class _DiTBase(nn.Module):
    """Patch embedding, position table, time (and context) conditioning,
    the blocks and the adaLN-modulated output projection."""

    def __init__(self, cfg: DiTConfig, n_tok: int, patch_dim: int,
                 out_dim: int):
        super().__init__()
        self.cfg = cfg
        self.n_tok = n_tok
        d = cfg.hidden
        self.patch_embed = nn.Linear(patch_dim, d)
        self.pos_emb = nn.Parameter(torch.zeros(1, n_tok, d))
        self.t_mlp1 = nn.Linear(d, d)
        self.t_mlp2 = nn.Linear(d, d)
        if cfg.cond_dim > 0:
            self.cond_proj = nn.Linear(cfg.cond_dim, d)
        for i in range(cfg.depth):
            self.add_module(f"block_{i}",
                            DiTBlock(d, cfg.num_heads, cfg.mlp_ratio))
        self.final_adaLN = _ZeroLinear(d, 2 * d)
        self.final_norm = _norm(d)
        self.final_proj = _ZeroLinear(d, out_dim)

    def init_weights(self, generator):
        self.pos_emb.normal_(0.0, 0.02, generator=generator)

    def _tokens(self, h):
        n = h.shape[1]
        if n > self.n_tok:
            raise ValueError(f"{n} tokens, but the position table was built "
                             f"for {self.n_tok}")
        return self.patch_embed(h) + self.pos_emb[:, :n]

    def _time(self, t):
        c = sinusoidal_pos_emb(t, self.cfg.hidden, scale=1.0)
        return self.t_mlp2(F.silu(self.t_mlp1(c)))

    def _blocks_and_out(self, h, c):
        for i in range(self.cfg.depth):
            h = getattr(self, f"block_{i}")(h, c)
        sh, sc = self.final_adaLN(F.silu(c)).chunk(2, dim=-1)
        h = self.final_norm(h) * (1 + sc[:, None]) + sh[:, None]
        return self.final_proj(h)


class DiT2D(_DiTBase):
    """2-D DiT over (B, H, W, C) images, built for hw = (H, W)."""

    def __init__(self, cfg: DiTConfig = DiTConfig(), hw=(32, 32)):
        p = cfg.patch
        if hw[0] % p or hw[1] % p:
            raise ValueError(f"image {hw} not divisible by the patch {p}")
        super().__init__(cfg, (hw[0] // p) * (hw[1] // p),
                         p * p * cfg.in_channels, p * p * cfg.out_channels)

    def forward(self, x, t, z_dec: Optional[torch.Tensor] = None):
        cfg = self.cfg
        b, hh, ww, cin = x.shape
        p = cfg.patch
        if hh % p or ww % p:
            raise ValueError(f"image {(hh, ww)} not divisible by the patch "
                             f"{p}")
        nh, nw = hh // p, ww // p
        if nh * nw != self.n_tok:
            raise ValueError(f"{nh * nw} patches, but the position table "
                             f"was built for {self.n_tok}")
        x = x.to(self.patch_embed.weight.dtype)
        h = x.reshape(b, nh, p, nw, p, cin).permute(0, 1, 3, 2, 4, 5)
        h = self._tokens(h.reshape(b, nh * nw, p * p * cin))
        c = self._time(t)
        if z_dec is not None and cfg.cond_dim > 0:
            zc = z_dec.reshape(b, -1, z_dec.shape[-1]).mean(dim=1) \
                if z_dec.ndim > 2 else z_dec
            c = c + self.cond_proj(zc)
        h = self._blocks_and_out(h, c)
        h = h.reshape(b, nh, nw, p, p, cfg.out_channels)
        return h.permute(0, 1, 3, 2, 4, 5).reshape(b, hh, ww,
                                                   cfg.out_channels)


class DiT1D(_DiTBase):
    """1-D DiT over (B, T, in_channels) signals, built for n_tok tokens
    (T / patch) at most. With cond_dim > 0 it takes z_dec (B, T // patch
    / r, cond_dim) token-aligned conditioning (each z token repeated r
    times) or a (B, cond_dim) vector."""

    def __init__(self, cfg: DiTConfig = DiTConfig(), n_tok: int = 256):
        super().__init__(cfg, n_tok, cfg.patch * cfg.in_channels,
                         cfg.patch * cfg.out_channels)
        if cfg.cond_dim > 0:
            self.cond_tokens = nn.Linear(cfg.cond_dim, cfg.hidden)

    def forward(self, x, t, z_dec: Optional[torch.Tensor] = None):
        """x: (B, T, C_in); t: (B,). Returns (B, T, C_out)."""
        cfg = self.cfg
        b, tlen, cin = x.shape
        p = cfg.patch
        if tlen % p:
            raise ValueError(f"length {tlen} not divisible by the patch {p}")
        n_tok = tlen // p
        x = x.to(self.patch_embed.weight.dtype)
        h = self._tokens(x.reshape(b, n_tok, p * cin))
        c = self._time(t)
        if z_dec is not None and cfg.cond_dim > 0:
            zc = z_dec.mean(dim=1) if z_dec.ndim == 3 else z_dec
            c = c + self.cond_proj(zc)
            if z_dec.ndim == 3:
                zt = self.cond_tokens(z_dec)
                reps = n_tok // zt.shape[1]
                if reps > 1:
                    zt = torch.repeat_interleave(zt, reps, dim=1)
                h = h + zt[:, :n_tok]
        h = self._blocks_and_out(h, c)
        return h.reshape(b, tlen, cfg.out_channels)
