"""Qwen2 decoder body, plain: a frozen copy of the port's Qwen2 with no
cache and no kernel, every sequence run whole.

Parameter names and shapes are the port's, so one state dict loads into
both. With `quantized` the projections are W8A8 (`QuantDense`): int8
kernels with per-output-channel scales, activations quantized per row
to int8 (amax / 127, round half to even, clamped), the int8 x int8
product exact (taken in float64, whose 53-bit mantissa holds every sum
of 4,864 products of 127 x 127). Attention is causal with a key-pad
mask, the scores and softmax in float32.

`lower` computes one precision step below what the configuration
states, for the control that a comparison has to fail: the W8A8
activations at int4 (amax / 7) and every other matrix product's inputs
rounded to float8 e4m3 (per-row scaled).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from speechbench.reference import rope as rope_ops


@dataclass(frozen=True)
class Qwen2Config:
    vocab_size: int = 151936
    hidden_size: int = 896
    n_layers: int = 24
    n_heads: int = 14
    n_kv_heads: int = 2
    head_dim: int = 64
    intermediate_size: int = 4864
    rope_theta: float = 1e6
    rms_eps: float = 1e-6
    quantized: bool = False
    act_quant: bool = True
    lower: bool = False


FP8_MAX = 448.0  # the largest float8 e4m3 value


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 at a per-row scale, back in x's dtype."""
    scale = torch.clamp(x.abs().amax(dim=-1, keepdim=True), min=1e-12) \
        / FP8_MAX
    return ((x / scale).to(torch.float8_e4m3fn).to(x.dtype)) * scale


def quantize_rows(x: torch.Tensor, levels: int = 127):
    """(M, K) -> (integers (M, K) as x's dtype, scale (M, 1)): symmetric
    per row, amax / levels, round half to even, clamped to +-levels."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    x_scale = torch.clamp(amax, min=1e-8) / torch.full_like(amax,
                                                             float(levels))
    xq = torch.clamp(torch.round(x / x_scale), -levels, levels)
    return xq, x_scale


class QuantDense(nn.Module):
    """W8A8 Dense, kernel `kernel_q` int8 (out, in), per-output-channel
    `scale`, optional bias."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, act_quant: bool = True,
                 lower: bool = False):
        super().__init__()
        self.act_quant = act_quant
        self.lower = lower
        self.kernel_q = nn.Parameter(
            torch.zeros((out_features, in_features), dtype=torch.int8),
            requires_grad=False)
        self.scale = nn.Parameter(torch.ones(out_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(self, x):
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1]).float()
        w = self.kernel_q.double()
        if self.act_quant:
            xq, x_scale = quantize_rows(x2, 7 if self.lower else 127)
            acc = (xq.double() @ w.t()).float()
            y = acc * x_scale * self.scale.float()
        else:
            y = (x2.double() @ w.t()).float() * self.scale.float()
        if self.bias is not None:
            y = y + self.bias.float()
        return y.view(*lead, -1)


class Linear(nn.Linear):
    """nn.Linear in float32; with `lower` its inputs rounded to fp8."""

    def __init__(self, d_in, d_out, bias=True, lower=False):
        super().__init__(d_in, d_out, bias=bias)
        self.lower = lower

    def forward(self, x):
        w = self.weight.float()
        x = x.float()
        if self.lower:
            x, w = fp8_round(x), fp8_round(w)
        return F.linear(x, w, None if self.bias is None else self.bias.float())


def _dense(cfg: Qwen2Config, d_in: int, d_out: int, bias: bool) -> nn.Module:
    if cfg.quantized:
        return QuantDense(d_in, d_out, bias, cfg.act_quant, cfg.lower)
    return Linear(d_in, d_out, bias, cfg.lower)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        x = x.float()
        var = x.square().mean(dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.eps) * self.weight.float()


class Qwen2Attention(nn.Module):
    def __init__(self, cfg: Qwen2Config):
        super().__init__()
        self.cfg = cfg
        c, h, kvh, d = cfg.hidden_size, cfg.n_heads, cfg.n_kv_heads, \
            cfg.head_dim
        self.q_proj = _dense(cfg, c, h * d, True)
        self.k_proj = _dense(cfg, c, kvh * d, True)
        self.v_proj = _dense(cfg, c, kvh * d, True)
        self.o_proj = _dense(cfg, h * d, c, False)

    def forward(self, x, positions, bias):
        """x (B, T, C); positions (B, T); bias (B, 1, T, T) additive."""
        c = self.cfg
        b, t, _ = x.shape
        d = c.head_dim
        q = self.q_proj(x).view(b, t, -1, d)
        k = self.k_proj(x).view(b, t, -1, d)
        v = self.v_proj(x).view(b, t, -1, d)
        cos, sin = rope_ops.rope_cos_sin(0, d, c.rope_theta,
                                         positions=positions.reshape(-1))
        cos, sin = cos.view(b, t, 1, d), sin.view(b, t, 1, d)
        q = q * cos + rope_ops.rotate_half(q) * sin
        k = k * cos + rope_ops.rotate_half(k) * sin
        rep = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
        if c.lower:
            q, k, v = fp8_round(q), fp8_round(k), fp8_round(v)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
        w = torch.softmax(scores + bias, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, t, -1)
        return self.o_proj(o)


class Qwen2MLP(nn.Module):
    def __init__(self, cfg: Qwen2Config):
        super().__init__()
        c, i = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = _dense(cfg, c, i, False)
        self.up_proj = _dense(cfg, c, i, False)
        self.down_proj = _dense(cfg, i, c, False)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Qwen2Layer(nn.Module):
    def __init__(self, cfg: Qwen2Config):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_eps)
        self.self_attn = Qwen2Attention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_eps)
        self.mlp = Qwen2MLP(cfg)

    def forward(self, x, positions, bias):
        x = x + self.self_attn(self.input_layernorm(x), positions, bias)
        return x + self.mlp(self.post_attention_layernorm(x))


class Qwen2Model(nn.Module):
    def __init__(self, cfg: Qwen2Config = Qwen2Config()):
        super().__init__()
        self.cfg = cfg
        self.layers = []
        for i in range(cfg.n_layers):
            layer = Qwen2Layer(cfg)
            self.add_module(f"layers_{i}", layer)
            self.layers.append(layer)
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_eps)

    def forward(self, inputs_embeds, lengths):
        """inputs_embeds (B, T, C) at positions 0..T-1, lengths (B,) the
        true lengths (keys past them masked). Returns the normed hidden
        states (B, T, C), float32."""
        b, t, _ = inputs_embeds.shape
        dev = inputs_embeds.device
        pos = torch.arange(t, device=dev)
        ok = (pos[None, :] <= pos[:, None])[None] \
            & (pos[None, None, :] < lengths.to(dev)[:, None, None])
        bias = torch.where(ok, 0.0, -1e10)[:, None].float()
        x = inputs_embeds.float()
        positions = pos[None].expand(b, t)
        for layer in self.layers:
            x = layer(x, positions, bias)
        return self.norm(x)
