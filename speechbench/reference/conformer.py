"""WeNet/ESPnet-style conformer primitives, full sequence: a frozen copy
of the port's (ESPnet relative positions, rel-pos attention with the
Transformer-XL u/v biases and rel-shift, position-wise FFN, the
optional macaron FFN and convolution module, the pre-norm encoder
layer), without its chunked streaming mode. Layout (B, T, C);
attention masks (B, T, T) bool."""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@functools.lru_cache(maxsize=8)
def _rel_pos_table(t: int, d_model: int) -> np.ndarray:
    """The table of espnet_rel_pos_emb, read-only; kept for the streaming
    path, which asks for the same two sizes every hop."""
    pos = np.arange(t - 1, -t, -1, dtype=np.float64)
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float64)
                 * -(np.log(10000.0) / d_model))
    ang = pos[:, None] * div[None, :]
    pe = np.zeros((2 * t - 1, d_model), np.float32)
    pe[:, 0::2] = np.sin(ang)
    pe[:, 1::2] = np.cos(ang)
    pe.setflags(write=False)
    return pe


def espnet_rel_pos_emb(t: int, d_model: int, dtype=torch.float32,
                       device=None) -> torch.Tensor:
    """(1, 2T-1, d) relative positional encoding, positions T-1 .. -(T-1)."""
    return torch.tensor(_rel_pos_table(t, d_model), device=device,
                        dtype=dtype)[None]


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, 2T-1) -> (B, H, T, T) Transformer-XL relative shift."""
    b, h, t, n = x.shape
    x = F.pad(x, (1, 0))
    x = x.reshape(b, h, n + 1, t)[:, :, 1:, :].reshape(b, h, t, n)
    return x[..., : n // 2 + 1]


class RelPositionAttention(nn.Module):
    def __init__(self, n_head: int, n_feat: int, key_bias: bool = True):
        super().__init__()
        self.n_head = n_head
        c = n_feat
        self.linear_q = nn.Linear(c, c)
        self.linear_k = nn.Linear(c, c, bias=key_bias)
        self.linear_v = nn.Linear(c, c)
        self.linear_pos = nn.Linear(c, c, bias=False)
        self.linear_out = nn.Linear(c, c)
        self.pos_bias_u = nn.Parameter(torch.zeros(n_head, c // n_head))
        self.pos_bias_v = nn.Parameter(torch.zeros(n_head, c // n_head))

    def _qkv(self, x):
        b, t, c = x.shape
        h = self.n_head
        return (self.linear_q(x).view(b, t, h, c // h),
                self.linear_k(x).view(b, t, h, c // h),
                self.linear_v(x).view(b, t, h, c // h))

    def forward(self, x, attn_mask, pos_emb):
        b, t, c = x.shape
        h = self.n_head
        d = c // h
        q, k, v = self._qkv(x)
        p = self.linear_pos(pos_emb).view(1, -1, h, d).expand(b, -1, h, d)

        ac = torch.einsum("bqhd,bkhd->bhqk", q + self.pos_bias_u, k)
        bd = torch.einsum("bqhd,bphd->bhqp", q + self.pos_bias_v, p)
        if bd.shape != ac.shape:
            bd = rel_shift(bd)
        scores = (ac + bd) / math.sqrt(d)

        m = attn_mask[:, None]
        neg = torch.finfo(torch.float32).min
        scores = scores.float().masked_fill(~m, neg)
        attn = torch.softmax(scores, dim=-1).masked_fill(~m, 0.0).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, t, c)
        return self.linear_out(out)


class PositionwiseFeedForward(nn.Module):
    def __init__(self, d: int, hidden: int, activation: str = "swish"):
        super().__init__()
        self.activation = activation
        self.w_1 = nn.Linear(d, hidden)
        self.w_2 = nn.Linear(hidden, d)

    def forward(self, x):
        h = self.w_1(x)
        h = F.silu(h) if self.activation == "swish" else F.relu(h)
        return self.w_2(h)


class ConvolutionModule(nn.Module):
    """Pointwise-GLU, depthwise conv, LayerNorm, swish, pointwise."""

    def __init__(self, channels: int, kernel_size: int = 15,
                 causal: bool = False):
        super().__init__()
        self.kernel_size = kernel_size
        self.causal = causal
        c = channels
        self.pointwise_conv1 = nn.Linear(c, 2 * c)
        self.depthwise_conv = nn.Conv1d(c, c, kernel_size, groups=c)
        self.norm = nn.LayerNorm(c, eps=1e-6)
        self.pointwise_conv2 = nn.Linear(c, c)

    def forward(self, x, pad_mask):
        x = x * pad_mask[..., None]
        h = F.glu(self.pointwise_conv1(x), dim=-1)
        k = self.kernel_size
        pad = (k - 1, 0) if self.causal else ((k - 1) // 2, (k - 1) // 2)
        h = self.depthwise_conv(F.pad(h.transpose(1, 2), pad)).transpose(1, 2)
        h = F.silu(self.norm(h))
        return self.pointwise_conv2(h) * pad_mask[..., None]


class ConformerEncoderLayer(nn.Module):
    """Pre-norm conformer layer; with macaron and conv off, a plain
    pre-norm transformer layer with rel-pos attention (the flow encoder's
    configuration)."""

    def __init__(self, n_head: int, linear_units: int, macaron: bool = False,
                 use_cnn: bool = False, cnn_kernel: int = 15,
                 key_bias: bool = True, d_model: int = 512):
        super().__init__()
        self.macaron = macaron
        self.use_cnn = use_cnn
        if macaron:
            self.norm_ff_macaron = nn.LayerNorm(d_model, eps=1e-12)
            self.feed_forward_macaron = PositionwiseFeedForward(
                d_model, linear_units)
        self.norm_mha = nn.LayerNorm(d_model, eps=1e-12)
        self.self_attn = RelPositionAttention(n_head, d_model, key_bias)
        if use_cnn:
            self.norm_conv = nn.LayerNorm(d_model, eps=1e-12)
            self.conv_module = ConvolutionModule(d_model, cnn_kernel)
            self.norm_final = nn.LayerNorm(d_model, eps=1e-12)
        self.norm_ff = nn.LayerNorm(d_model, eps=1e-12)
        self.feed_forward = PositionwiseFeedForward(d_model, linear_units)

    def forward(self, x, attn_mask, pos_emb, pad_mask):
        ff_scale = 0.5 if self.macaron else 1.0
        if self.macaron:
            x = x + ff_scale * self.feed_forward_macaron(
                self.norm_ff_macaron(x))
        x = x + self.self_attn(self.norm_mha(x), attn_mask, pos_emb)
        if self.use_cnn:
            x = x + self.conv_module(self.norm_conv(x), pad_mask)
        x = x + ff_scale * self.feed_forward(self.norm_ff(x))
        if self.use_cnn:
            x = self.norm_final(x)
        return x
