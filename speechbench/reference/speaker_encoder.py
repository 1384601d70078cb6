"""Learnable speaker encoder (Tortoise-style conditioning encoder).

A frozen copy of the port's twin of minimax_speech_tpu/models/speaker_encoder.py: mel (B, T, 80) ->
Dense to model_dim -> attention blocks (GroupNorm, fused qkv, per-head
attention with q and k each scaled by d^-1/4, mask applied after the
softmax, output projection, residual) -> first-position pool -> Dense
-> L2 normalize.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class SpeakerEncoderConfig:
    mel_dim: int = 80
    model_dim: int = 512
    output_dim: int = 192
    num_blocks: int = 6
    num_heads: int = 8
    mean_pooling: bool = False


def _group_count(channels: int) -> int:
    groups = 32
    if channels <= 16:
        groups = 8
    elif channels <= 64:
        groups = 16
    while channels % groups != 0:
        groups //= 2
    return groups


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-12)


class TortoiseAttentionBlock(nn.Module):
    def __init__(self, channels: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.norm = nn.GroupNorm(_group_count(channels), channels, eps=1e-5)
        self.qkv = nn.Linear(channels, 3 * channels)
        self.proj_out = nn.Linear(channels, channels)

    def forward(self, x, mask=None):
        b, t, c = x.shape
        # GroupNorm in float32 over channel-last input
        h = F.group_norm(x.float().transpose(1, 2), self.norm.num_groups,
                         self.norm.weight.float(), self.norm.bias.float(),
                         self.norm.eps).transpose(1, 2).to(x.dtype)
        d = c // self.num_heads
        qkv = self.qkv(h).view(b, t, self.num_heads, 3, d)  # head-major
        q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
        scale = d ** -0.25
        w = torch.einsum("bqhd,bkhd->bhqk", q * scale, k * scale)
        w = torch.softmax(w.float(), dim=-1).to(x.dtype)
        if mask is not None:
            w = w * mask[:, None, None, :].to(w.dtype)
        a = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, t, c)
        return x + self.proj_out(a)


class LearnableSpeakerEncoder(nn.Module):
    def __init__(self, cfg: SpeakerEncoderConfig = SpeakerEncoderConfig()):
        super().__init__()
        self.cfg = cfg
        self.init = nn.Linear(cfg.mel_dim, cfg.model_dim)
        self.blocks = []
        for i in range(cfg.num_blocks):
            blk = TortoiseAttentionBlock(cfg.model_dim, cfg.num_heads)
            self.add_module(f"attn_{i}", blk)
            self.blocks.append(blk)
        self.output_proj = nn.Linear(cfg.model_dim, cfg.output_dim)

    def forward(self, mel, mask=None):
        """mel: (B, T, mel_dim) -> (B, output_dim) unit-norm embedding."""
        h = self.init(mel.to(self.init.weight.dtype))
        for blk in self.blocks:
            h = blk(h, mask)
        if self.cfg.mean_pooling:
            if mask is not None:
                m = mask.to(h.dtype)[..., None]
                pooled = (h * m).sum(1) / torch.clamp(m.sum(1), min=1.0)
            else:
                pooled = h.mean(dim=1)
        else:
            pooled = h[:, 0]
        return l2_normalize(self.output_proj(pooled))
