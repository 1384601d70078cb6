"""Causal conditional UNet, the CFM velocity estimator (full forward).

Port of minimax_speech_tpu/models/decoder_unet.py without its streaming
modes (chunk masks, collect, chunk). A flat stack over latent frames:
down stage(s), mid stages and up stage(s), each a causal resnet block
plus transformer blocks. Channel-last (B, T, C).

Every transformer block's attention goes through K1
(kernels/flash_attention.py) with the frame mask as key lengths: the
kernel on CUDA, its plain version on the CPU. With a prefix frame mask
this is the function of the JAX package's XLA branch (key pad bias from
add_optional_chunk_mask(mask, 0)) on every query row that sees a key.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from minimax_speech_torch.kernels.flash_attention import flash_attention


@dataclass(frozen=True)
class DecoderUNetConfig:
    in_channels: int = 320       # packed x + mu + spk + cond
    out_channels: int = 80
    channels: Tuple[int, ...] = (256,)
    attention_head_dim: int = 64
    n_blocks: int = 4            # transformer blocks per stage
    num_mid_blocks: int = 12
    num_heads: int = 8
    act_fn: str = "gelu"
    static_chunk_size: int = 50
    num_left_chunks: int = -1


def sinusoidal_pos_emb(t: torch.Tensor, dim: int,
                       scale: float = 1000.0) -> torch.Tensor:
    """(B,) timesteps -> (B, dim)."""
    half = dim // 2
    emb = np.exp(np.arange(half) * -(np.log(10000.0) / (half - 1)))
    emb_t = torch.as_tensor(emb, dtype=torch.float32, device=t.device)
    ang = scale * t[:, None].float() * emb_t[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def mish(x):
    return x * torch.tanh(F.softplus(x))


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, t_emb):
        return self.linear_2(F.silu(self.linear_1(t_emb)))


class CausalBlock1D(nn.Module):
    """Causal conv (k = 3) -> LayerNorm -> Mish, masked in and out."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.conv = nn.Conv1d(dim_in, dim_out, 3)
        self.norm = nn.LayerNorm(dim_out, eps=1e-6)

    def forward(self, x, mask):
        h = F.pad((x * mask[..., None]).transpose(1, 2), (2, 0))
        h = self.norm(self.conv(h).transpose(1, 2))
        return mish(h) * mask[..., None]


class CausalResnetBlock1D(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, time_dim: int):
        super().__init__()
        self.block1 = CausalBlock1D(dim_in, dim_out)
        self.mlp = nn.Linear(time_dim, dim_out)
        self.block2 = CausalBlock1D(dim_out, dim_out)
        self.res_conv = nn.Linear(dim_in, dim_out)

    def forward(self, x, mask, t_emb):
        h = self.block1(x, mask) + self.mlp(mish(t_emb))[:, None, :]
        h = self.block2(h, mask)
        return h + self.res_conv(x * mask[..., None])


class UNetTransformerBlock(nn.Module):
    """LayerNorm -> MHA (no qkv bias) -> LayerNorm -> GELU FFN, residuals."""

    def __init__(self, dim: int, num_heads: int, head_dim: int):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = head_dim
        inner = num_heads * head_dim
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(dim, inner, bias=False)
        self.to_v = nn.Linear(dim, inner, bias=False)
        self.to_out = nn.Linear(inner, dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-6)
        self.ff_in = nn.Linear(dim, 4 * dim)
        self.ff_out = nn.Linear(4 * dim, dim)

    def forward(self, x, kv_len):
        b, t, _ = x.shape
        h = self.norm1(x)

        def heads(y):  # (B, T, H*D) -> contiguous (B, H, T, D)
            return y.view(b, t, self.num_heads, self.head_dim) \
                .transpose(1, 2).contiguous()

        o = flash_attention(heads(self.to_q(h)), heads(self.to_k(h)),
                            heads(self.to_v(h)), kv_len=kv_len)
        x = x + self.to_out(o.transpose(1, 2).reshape(b, t, -1))
        h = F.gelu(self.ff_in(self.norm3(x)))
        return x + self.ff_out(h)


class CausalConditionalDecoder(nn.Module):
    def __init__(self, cfg: DecoderUNetConfig = DecoderUNetConfig()):
        super().__init__()
        self.cfg = cfg
        time_dim = cfg.channels[0] * 4
        self.time_mlp = TimestepEmbedding(cfg.in_channels, time_dim)

        def stage(name: str, dim_in: int, dim: int, conv: bool):
            """(resnet, transformer blocks, stage conv or None)."""
            res = CausalResnetBlock1D(dim_in, dim, time_dim)
            self.add_module(f"{name}_resnet", res)
            tfs = []
            for j in range(cfg.n_blocks):
                blk = UNetTransformerBlock(dim, cfg.num_heads,
                                           cfg.attention_head_dim)
                self.add_module(f"{name}_tf_{j}", blk)
                tfs.append(blk)
            cv = None
            if conv:
                cv = nn.Conv1d(dim, dim, 3)
                self.add_module(f"{name}_conv", cv)
            return res, tfs, cv

        dim = cfg.in_channels
        self.down = []
        for i, ch in enumerate(cfg.channels):
            self.down.append(stage(f"down_{i}", dim, ch, True))
            dim = ch
        self.mid = [stage(f"mid_{i}", dim, cfg.channels[-1], False)
                    for i in range(cfg.num_mid_blocks)]
        dim = cfg.channels[-1]
        up_channels = tuple(reversed(cfg.channels)) + (cfg.channels[0],)
        skips = list(cfg.channels)
        self.up = []
        for i in range(len(up_channels) - 1):
            dim_in = dim + skips.pop()
            self.up.append(stage(f"up_{i}", dim_in, up_channels[i + 1], True))
            dim = up_channels[i + 1]
        self.final_block = CausalBlock1D(dim, dim)
        self.final_proj = nn.Linear(dim, cfg.out_channels)

    @staticmethod
    def _run_stage(stage, h, mask, t_emb, kv_len):
        res, tfs, _ = stage
        h = res(h, mask, t_emb)
        for blk in tfs:
            h = blk(h, kv_len)
        return h

    @staticmethod
    def _stage_conv(conv, h, mask):
        """Stride-1 causal stage conv (k = 3, left zero pad)."""
        h = F.pad((h * mask[..., None]).transpose(1, 2), (2, 0))
        return conv(h).transpose(1, 2)

    def forward(self, x, mask, mu, t, spks=None, cond=None):
        """x, mu, cond: (B, T, 80); mask: (B, T) float prefix mask; t: (B,);
        spks: (B, 80). Returns the velocity (B, T, 80)."""
        b, tlen, _ = x.shape
        t_emb = self.time_mlp(sinusoidal_pos_emb(t, self.cfg.in_channels)
                              .to(x.dtype))
        feats = [x, mu]
        if spks is not None:
            feats.append(spks[:, None, :].expand(b, tlen, spks.shape[-1]))
        if cond is not None:
            feats.append(cond)
        h = torch.cat(feats, dim=-1)
        kv_len = (mask > 0).sum(dim=1, dtype=torch.int32)

        skips = []
        for stage in self.down:
            h = self._run_stage(stage, h, mask, t_emb, kv_len)
            skips.append(h)
            h = self._stage_conv(stage[2], h, mask)
        for stage in self.mid:
            h = self._run_stage(stage, h, mask, t_emb, kv_len)
        for stage in self.up:
            h = torch.cat([h, skips.pop()], dim=-1)
            h = self._run_stage(stage, h, mask, t_emb, kv_len)
            h = self._stage_conv(stage[2], h, mask)
        h = self.final_block(h, mask)
        return self.final_proj(h * mask[..., None]) * mask[..., None]
