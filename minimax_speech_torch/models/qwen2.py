"""Qwen2 decoder-only backbone (the stage-1 LM body).

Port of minimax_speech_tpu/models/qwen2.py, inference path in fp32 or
bf16. The KV cache is a preallocated (n_layers, B, max_len, n_kv,
head_dim) pair written in place at a slot offset; RoPE is applied at
write time with each token's true position, so storage slots and
positions decouple and padded prompts need no re-packing.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from minimax_speech_torch.ops import rope as rope_ops


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
    quantized: bool = False  # W8A8 projections: not ported yet

    def __post_init__(self):
        if self.quantized:
            raise NotImplementedError(
                "quantized (W8A8) Qwen2 projections are not ported yet")


class RMSNorm(nn.Module):
    """Scale by the reciprocal RMS, taken in float32."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def init_weights(self, generator):
        self.weight.data.fill_(1.0)

    def forward(self, x):
        var = x.float().square().mean(dim=-1, keepdim=True)
        x = x * torch.rsqrt(var + self.eps).to(x.dtype)
        return x * self.weight


class Qwen2Attention(nn.Module):
    def __init__(self, cfg: Qwen2Config):
        super().__init__()
        self.cfg = cfg
        c, h, kvh, d = cfg.hidden_size, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.q_proj = nn.Linear(c, h * d)
        self.k_proj = nn.Linear(c, kvh * d)
        self.v_proj = nn.Linear(c, kvh * d)
        self.o_proj = nn.Linear(h * d, c, bias=False)

    def forward(self, x, positions, attn_bias, cache=None, cache_offset=0):
        """x: (B, T, C); positions: (B, T) true token positions;
        attn_bias: (B, 1, T, K) additive, float32; cache: optional (k, v)
        each (B, max_len, n_kv, d) for this layer, written in place at
        slots [cache_offset, cache_offset + T)."""
        c = self.cfg
        b, t, _ = x.shape
        h, kvh, d = c.n_heads, c.n_kv_heads, c.head_dim
        q = self.q_proj(x).view(b, t, h, d)
        k = self.k_proj(x).view(b, t, kvh, d)
        v = self.v_proj(x).view(b, t, kvh, d)

        cos, sin = rope_ops.rope_cos_sin(
            0, d, c.rope_theta, positions=positions.reshape(-1).float(),
            dtype=x.dtype)
        cos = cos.view(b, t, 1, d)
        sin = sin.view(b, t, 1, d)
        q = q * cos + rope_ops.rotate_half(q) * sin
        k = k * cos + rope_ops.rotate_half(k) * sin

        if cache is not None:
            ck, cv = cache
            ck[:, cache_offset: cache_offset + t] = k
            cv[:, cache_offset: cache_offset + t] = v
            keys, values = ck, cv
        else:
            keys, values = k, v

        rep = h // kvh
        keys = keys.repeat_interleave(rep, dim=2)
        values = values.repeat_interleave(rep, dim=2)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, keys) / math.sqrt(d)
        w = torch.softmax(scores.float() + attn_bias, dim=-1).to(x.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", w, values).reshape(b, t, h * d)
        return self.o_proj(o)


class Qwen2MLP(nn.Module):
    def __init__(self, cfg: Qwen2Config):
        super().__init__()
        c, i = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = nn.Linear(c, i, bias=False)
        self.up_proj = nn.Linear(c, i, bias=False)
        self.down_proj = nn.Linear(i, c, bias=False)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Qwen2Layer(nn.Module):
    def __init__(self, cfg: Qwen2Config):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_eps)
        self.self_attn = Qwen2Attention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_eps)
        self.mlp = Qwen2MLP(cfg)

    def forward(self, x, positions, attn_bias, cache=None, cache_offset=0):
        x = x + self.self_attn(self.input_layernorm(x), positions, attn_bias,
                               cache, cache_offset)
        return x + self.mlp(self.post_attention_layernorm(x))


class Qwen2Model(nn.Module):
    """Backbone over input embeddings (the TTS LM feeds mixed
    text/speech/special embeddings, never raw token ids)."""

    def __init__(self, cfg: Qwen2Config = Qwen2Config()):
        super().__init__()
        self.cfg = cfg
        self.layers = []
        for i in range(cfg.n_layers):
            layer = Qwen2Layer(cfg)
            self.add_module(f"layers_{i}", layer)
            self.layers.append(layer)
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_eps)

    def forward(self, inputs_embeds, positions, attn_bias, cache=None,
                cache_offset=0):
        """cache: optional (k, v) each (n_layers, B, max_len, n_kv, d),
        updated in place. Returns the normed hidden states (B, T, C)."""
        x = inputs_embeds
        for i, layer in enumerate(self.layers):
            layer_cache = None if cache is None else (cache[0][i], cache[1][i])
            x = layer(x, positions, attn_bias, layer_cache, cache_offset)
        return self.norm(x)


def make_cache(cfg: Qwen2Config, batch: int, max_len: int,
               dtype=torch.float32, device=None):
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def causal_bias(pad_mask: torch.Tensor) -> torch.Tensor:
    """(B, T) bool -> (B, 1, T, T) additive causal + key-pad bias."""
    t = pad_mask.shape[1]
    causal = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                   device=pad_mask.device))
    m = causal[None] & pad_mask[:, None, :]
    return torch.where(m, 0.0, -1e10)[:, None].float()


def cache_bias(valid: torch.Tensor) -> torch.Tensor:
    """(B, K) cache-slot validity -> (B, 1, 1, K) additive bias."""
    return torch.where(valid, 0.0, -1e10)[:, None, None, :].float()
