"""Qwen2 decoder-only backbone (the stage-1 LM body).

Port of minimax_speech_tpu/models/qwen2.py in fp32 or bf16, with the
W8A8 projections of `QuantDense` when `quantized` is set. Inference:
the KV cache is a preallocated (n_layers, B, max_len, n_kv, head_dim)
pair written in place at a slot offset; RoPE is applied at write time
with each token's true position, so storage slots and positions
decouple and padded prompts need no re-packing. Training (no cache,
`lengths` given, no bias): every attention call goes through K2
(kernels/splash.py), causal with segment padding, at any T; on the CPU
through K2's plain version. Valid rows see what the JAX package's XLA
route shows them; pad rows see only pads, which no loss reads. With
`remat`, each layer of the training path runs under
torch.utils.checkpoint, keeping its input only ("none") or also its
projections' outputs ("dots"); the decode path (a cache) ignores it.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from minimax_speech_torch.kernels import splash
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
    quantized: bool = False  # int8 projection kernels (QuantDense)
    act_quant: bool = True   # + per-row int8 activations (W8A8)
    remat: bool = False      # per-layer checkpointing on the training path
    # what a checkpointed layer keeps for the backward: "none" only its
    # input (the whole layer is recomputed), "dots" also the outputs of
    # its seven projections (REMAT_POLICIES)
    remat_policy: str = "dots"


REMAT_POLICIES = ("none", "dots")
# the products without batch dims, as the projections lower to them: what
# jax.checkpoint_policies.dots_with_no_batch_dims_saveable keeps
_NO_BATCH_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def dots_policy(ctx, op, *args, **kwargs):
    """The "dots" remat policy for torch.utils.checkpoint's selective
    checkpointing: keep the projections' products, recompute everything
    else (the batched products, norms, RoPE, SiLU and K2, whose kernels
    launch outside aten and so are never cached)."""
    if op in _NO_BATCH_PRODUCTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


INT_MM_MIN_ROWS = 17  # torch._int_mm on CUDA takes more than 16 rows
INT_MM_PAD_ROWS = 32
PROJ_NAMES = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
              "down_proj")


def int8_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (N, K)^T int8 -> (M, N) int32, exact. On CUDA, cuBLAS
    through `torch._int_mm` on `w.t()`, the column-major (K, N) operand it
    takes; it refuses M <= 16 (the decode has M = 1), so the rows are
    zero-padded to 32 and the result cut. On the CPU an int32 matmul, also
    exact (127 * 127 * 4864 < 2^31)."""
    if a.device.type == "cpu":
        return torch.matmul(a.to(torch.int32), w.t().to(torch.int32))
    m = a.shape[0]
    if m < INT_MM_MIN_ROWS:
        a = F.pad(a, (0, 0, 0, INT_MM_PAD_ROWS - m))
    return torch._int_mm(a, w.t())[:m]


def quantize_rows(x: torch.Tensor):
    """(M, K) -> (int8 (M, K), scale (M, 1) in x's dtype): symmetric per
    row, amax / 127, round half to even, clamped to +-127 before the cast
    (with bf16 input the row's largest element can round to 128). The
    divisor 127 is a tensor: CUDA divides by a Python scalar as a product
    with its reciprocal, which can differ from the quotient by one ulp."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    x_scale = torch.clamp(amax, min=1e-8) / torch.full_like(amax, 127.0)
    xq = torch.clamp(torch.round(x / x_scale), -127, 127).to(torch.int8)
    return xq, x_scale


class QuantDense(nn.Module):
    """int8 Dense: kernel `kernel_q` stored int8 as (out, in), the layout
    `int8_mm` streams, with per-output-channel scales. act_quant: dynamic
    per-row symmetric int8 activations and an int8 x int8 product
    accumulated in int32, with the JAX package's arithmetic (amax and the
    scale in x's dtype, round half to even, clamp to +-127 before the
    cast). Else weight-only: x times the kernel in x's dtype, summed in
    float32."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, act_quant: bool = True):
        super().__init__()
        self.act_quant = act_quant
        self.kernel_q = nn.Parameter(
            torch.zeros((out_features, in_features), dtype=torch.int8),
            requires_grad=False)
        self.scale = nn.Parameter(torch.ones(out_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def init_weights(self, generator):
        """Random int8 kernels in [-127, 127] and unit scales, as bench.py
        gives the JAX package's quantized LM."""
        w = self.kernel_q
        w.copy_(torch.randint(-127, 128, w.shape, generator=generator,
                              device=w.device, dtype=torch.int16))
        self.scale.data.fill_(1.0)
        if self.bias is not None:
            self.bias.data.zero_()

    def forward(self, x):
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        if self.act_quant:
            xq, x_scale = quantize_rows(x2)
            y = (int8_mm(xq, self.kernel_q).float() * x_scale.float()
                 * self.scale).to(x.dtype)
        else:
            y = torch.matmul(x2.float(), self.kernel_q.t().float())
            y = (y * self.scale).to(x.dtype)
        if self.bias is not None:
            y = y + self.bias
        return y.view(*lead, -1)


def _dense(cfg: Qwen2Config, d_in: int, d_out: int, bias: bool) -> nn.Module:
    if cfg.quantized:
        return QuantDense(d_in, d_out, bias, cfg.act_quant)
    return nn.Linear(d_in, d_out, bias=bias)


def quantize_lm_params(params: dict, scope: str = "llm") -> dict:
    """A flax variables tree with float Qwen2 projection kernels under
    params[scope] -> the tree of the quantized modules: each kernel (in,
    out) becomes `kernel_q` int8 and `scale` (out,) float32, per output
    channel; norms, embeddings and biases stay. The JAX package's
    arithmetic, in numpy."""
    def quantize_kernel(w):
        w = np.asarray(w, np.float32)
        s = np.maximum(np.max(np.abs(w), axis=0) / 127.0, 1e-12)
        q = np.clip(np.round(w / s), -127, 127).astype(np.int8)
        return q, s.astype(np.float32)

    def rec(node):
        if not isinstance(node, dict):
            return node
        out = {}
        for k, v in node.items():
            if k in PROJ_NAMES and isinstance(v, dict) and "kernel" in v:
                q, s = quantize_kernel(v["kernel"])
                out[k] = {"kernel_q": q, "scale": s}
                if "bias" in v:
                    out[k]["bias"] = v["bias"]
            else:
                out[k] = rec(v)
        return out

    new = dict(params)
    new[scope] = rec(params[scope])
    return new


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
        self.q_proj = _dense(cfg, c, h * d, True)
        self.k_proj = _dense(cfg, c, kvh * d, True)
        self.v_proj = _dense(cfg, c, kvh * d, True)
        self.o_proj = _dense(cfg, h * d, c, False)

    def forward(self, x, positions, attn_bias, cache=None, cache_offset=0,
                lengths=None):
        """x: (B, T, C); positions: (B, T) true token positions;
        attn_bias: (B, 1, T, K) additive, float32; cache: optional (k, v)
        each (B, max_len, n_kv, d) for this layer, written in place at
        slots [cache_offset, cache_offset + T), or, when cache_offset is a
        (B,) tensor and T is 1, each row at its own slot. JAX clamps an
        offset past the cache; on CUDA an index past it is a device-side
        assert, so callers check their offsets on the host. With attn_bias
        None, `lengths` (B,) selects the training attention (K2)."""
        c = self.cfg
        b, t, _ = x.shape
        d = c.head_dim
        # the heads this rank holds: all, or its tensor-parallel share
        # (whole q heads and the kv heads they read)
        q = self.q_proj(x).view(b, t, -1, d)
        k = self.k_proj(x).view(b, t, -1, d)
        v = self.v_proj(x).view(b, t, -1, d)
        h, kvh = q.shape[2], k.shape[2]

        cos, sin = rope_ops.rope_cos_sin(
            0, d, c.rope_theta, positions=positions.reshape(-1).float(),
            dtype=x.dtype)
        cos = cos.view(b, t, 1, d)
        sin = sin.view(b, t, 1, d)
        q = q * cos + rope_ops.rotate_half(q) * sin
        k = k * cos + rope_ops.rotate_half(k) * sin

        if cache is not None:
            ck, cv = cache
            if torch.is_tensor(cache_offset) and cache_offset.dim() == 1:
                if t != 1:
                    raise ValueError(f"per-row cache offsets take T=1, got {t}")
                rows = torch.arange(b, device=ck.device)
                ck[rows, cache_offset] = k[:, 0]
                cv[rows, cache_offset] = v[:, 0]
            else:
                ck[:, cache_offset: cache_offset + t] = k
                cv[:, cache_offset: cache_offset + t] = v
            keys, values = ck, cv
        else:
            keys, values = k, v

        rep = h // kvh
        keys = keys.repeat_interleave(rep, dim=2)
        values = values.repeat_interleave(rep, dim=2)
        if attn_bias is None:
            o = splash.splash_causal_attention(
                q.transpose(1, 2), keys.transpose(1, 2),
                values.transpose(1, 2), lengths, scale=1.0 / math.sqrt(d))
            return self.o_proj(o.transpose(1, 2).reshape(b, t, h * d))
        scores = torch.einsum("bqhd,bkhd->bhqk", q, keys) / math.sqrt(d)
        w = torch.softmax(scores.float() + attn_bias, dim=-1).to(x.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", w, values).reshape(b, t, h * d)
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

    def forward(self, x, positions, attn_bias, cache=None, cache_offset=0,
                lengths=None):
        x = x + self.self_attn(self.input_layernorm(x), positions, attn_bias,
                               cache, cache_offset, lengths)
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
                cache_offset=0, lengths=None):
        """cache: optional (k, v) each (n_layers, B, max_len, n_kv, d),
        updated in place. attn_bias None selects the training path: no
        cache, `lengths` (B,) the true lengths, causal attention through
        K2. Returns the normed hidden states (B, T, C)."""
        if attn_bias is None and (lengths is None or cache is not None):
            raise ValueError("need attn_bias, or lengths without a cache")
        run = self._remat_layer() if cache is None else None
        x = inputs_embeds
        for i, layer in enumerate(self.layers):
            layer_cache = None if cache is None else (cache[0][i], cache[1][i])
            args = (x, positions, attn_bias, layer_cache, cache_offset,
                    lengths)
            x = layer(*args) if run is None else run(layer, *args)
        return self.norm(x)

    def _remat_layer(self):
        """With cfg.remat, the call that runs a layer under
        torch.utils.checkpoint (non-reentrant), keeping what
        cfg.remat_policy says; None without remat or without grad, where
        nothing is saved."""
        c = self.cfg
        if not c.remat:
            return None
        if c.remat_policy not in REMAT_POLICIES:
            # a typo silently running another policy would void any A/B
            raise ValueError(f"remat_policy={c.remat_policy!r} not in "
                             f"{REMAT_POLICIES}")
        if not torch.is_grad_enabled():
            return None
        kw = {}
        if c.remat_policy == "dots":
            kw["context_fn"] = functools.partial(
                create_selective_checkpoint_contexts, dots_policy)
        return functools.partial(checkpoint, use_reentrant=False, **kw)


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


def params_from_hf_state(state: dict, cfg: Qwen2Config):
    """An HF Qwen2ForCausalLM state dict (numpy arrays, keys with or
    without the "model." prefix) -> (the Qwen2 body's flax variables
    {"params": ...}, the embedding table, the lm_head weight or None),
    the trees the JAX package's params_from_hf_state gives."""
    def dw(w):
        return np.transpose(w, (1, 0))

    def get(k):
        return state.get("model." + k, state.get(k))

    p: dict = {}
    for i in range(cfg.n_layers):
        pre = f"layers.{i}."
        p[f"layers_{i}"] = {
            "input_layernorm": {"weight": get(pre + "input_layernorm.weight")},
            "post_attention_layernorm": {
                "weight": get(pre + "post_attention_layernorm.weight")},
            "self_attn": {
                "q_proj": {"kernel": dw(get(pre + "self_attn.q_proj.weight")),
                           "bias": get(pre + "self_attn.q_proj.bias")},
                "k_proj": {"kernel": dw(get(pre + "self_attn.k_proj.weight")),
                           "bias": get(pre + "self_attn.k_proj.bias")},
                "v_proj": {"kernel": dw(get(pre + "self_attn.v_proj.weight")),
                           "bias": get(pre + "self_attn.v_proj.bias")},
                "o_proj": {"kernel": dw(get(pre + "self_attn.o_proj.weight"))},
            },
            "mlp": {
                "gate_proj": {"kernel": dw(get(pre + "mlp.gate_proj.weight"))},
                "up_proj": {"kernel": dw(get(pre + "mlp.up_proj.weight"))},
                "down_proj": {"kernel": dw(get(pre + "mlp.down_proj.weight"))},
            },
        }
    p["norm"] = {"weight": get("norm.weight")}
    return {"params": p}, get("embed_tokens.weight"), state.get(
        "lm_head.weight")
