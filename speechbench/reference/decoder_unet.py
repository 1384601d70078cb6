"""Causal conditional UNet, the CFM velocity estimator: a frozen copy
of the port's, every attention by plain masked torch ops (the key-pad
mask, with `streaming` the static chunk mask), in float32."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from speechbench.reference.attention import reference_attention
from speechbench.reference import masks as mask_ops


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


class StreamState:
    """The chunked-streaming state one UNet call reads and writes, keyed by
    layer name: every causal conv keeps a 2-frame input tail and every
    transformer block a `window`-frame K/V tail (2, B, window, H, D).
    mode "collect" (a full pass over the prompt) stores the tails at the
    prompt's valid length `plen` into `out`; mode "chunk" (one chunk
    against the cache) reads `cache` and stores the advanced tails into
    `out`."""

    def __init__(self, mode: str, plen: int = 0, cache: dict | None = None,
                 window: int = 100):
        self.mode, self.plen = mode, plen
        self.cache, self.window = cache, window
        self.out: dict = {}

    def conv_input(self, xin, key: str):
        """The causal conv's input for masked frames `xin` (B, T, C): the
        cached tail or two zero frames in front."""
        if self.mode == "chunk":
            self.out[key] = xin[:, -2:]
            return torch.cat([self.cache[key].to(xin.dtype), xin], dim=1)
        self.out[key] = mask_ops.tail(xin, 2, self.plen)
        return F.pad(xin, (0, 0, 2, 0))


def causal_conv(conv: nn.Conv1d, xin, state: StreamState | None, key: str):
    """Stride-1 causal conv (k = 3) over channel-last masked frames."""
    h = F.pad(xin, (0, 0, 2, 0)) if state is None \
        else state.conv_input(xin, key)
    return conv(h.transpose(1, 2)).transpose(1, 2)


class CausalBlock1D(nn.Module):
    """Causal conv (k = 3) -> LayerNorm -> Mish, masked in and out."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.conv = nn.Conv1d(dim_in, dim_out, 3)
        self.norm = nn.LayerNorm(dim_out, eps=1e-6)

    def forward(self, x, mask, state=None, key: str = ""):
        h = causal_conv(self.conv, x * mask[..., None], state, key)
        return mish(self.norm(h)) * mask[..., None]


class CausalResnetBlock1D(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, time_dim: int):
        super().__init__()
        self.block1 = CausalBlock1D(dim_in, dim_out)
        self.mlp = nn.Linear(time_dim, dim_out)
        self.block2 = CausalBlock1D(dim_out, dim_out)
        self.res_conv = nn.Linear(dim_in, dim_out)

    def forward(self, x, mask, t_emb, state=None, key: str = ""):
        h = self.block1(x, mask, state, f"{key}.block1") \
            + self.mlp(mish(t_emb))[:, None, :]
        h = self.block2(h, mask, state, f"{key}.block2")
        return h + self.res_conv(x * mask[..., None])


@dataclass
class Attention:
    """How a transformer block attends: with `bias` (an additive
    (B or 1, 1, Tq, Tk) float32 tensor) by plain torch ops, else through
    K1 (no grad) or K2 (under grad) with key lengths `kv_len` (B,) and
    the kernels' chunk mask."""
    kv_len: torch.Tensor | None = None
    chunk: int = 0
    left_chunks: int = -1
    bias: torch.Tensor | None = None


def biased_attention(q, k, v, bias):
    """softmax(q k^T / sqrt(d) + bias) v over (B, T, H, D) tensors, the
    scores in float32."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(q.shape[-1])
    w = torch.softmax(scores.float() + bias, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


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

    def forward(self, x, attn: Attention, state: StreamState | None = None,
                name: str = ""):
        b, t, _ = x.shape
        h = self.norm1(x)
        # the heads this rank holds: all, or its tensor-parallel share
        q, k, v = (proj(h).view(b, t, -1, self.head_dim)
                   for proj in (self.to_q, self.to_k, self.to_v))
        if state is not None and state.mode == "chunk":
            cached = state.cache[name].to(k.dtype)
            k = torch.cat([cached[0], k], dim=1)
            v = torch.cat([cached[1], v], dim=1)
            state.out[name] = torch.stack([k, v])[:, :, -cached.shape[2]:]
        elif state is not None:
            state.out[name] = torch.stack(
                [mask_ops.tail(k, state.window, state.plen),
                 mask_ops.tail(v, state.window, state.plen)])
        if attn.bias is not None:
            o = biased_attention(q, k, v, attn.bias)
        else:
            def heads(y):  # (B, T, H, D) -> (B, H, T, D)
                return y.transpose(1, 2)

            o = reference_attention(heads(q), heads(k), heads(v), attn.kv_len,
                                    attn.chunk, attn.left_chunks).transpose(1, 2)
        x = x + self.to_out(o.reshape(b, t, -1))
        h = F.gelu(self.ff_in(self.norm3(x)))
        return x + self.ff_out(h)


class CausalConditionalDecoder(nn.Module):
    """in_dim: the channels of the packed input (x, mu, spks, cond) when
    they are not cfg.in_channels, the timestep embedding's width (Matcha
    packs zero spks and cond beside its 2 x 80)."""

    def __init__(self, cfg: DecoderUNetConfig = DecoderUNetConfig(),
                 in_dim: int | None = None):
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

        dim = in_dim or cfg.in_channels
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

    def _run_stage(self, stage, name, h, mask, t_emb, attn, state):
        res, tfs, _ = stage
        h = res(h, mask, t_emb, state, f"{name}_resnet")
        for j, blk in enumerate(tfs):
            h = blk(h, attn, state, f"{name}_tf_{j}")
        return h

    def _attention(self, mask, tlen: int, streaming: bool, chunked: bool,
                   cache_offset: int, q_valid, window: int, unit_align):
        cfg = self.cfg
        dev = mask.device
        if chunked:
            # keys = [window tail | current chunk]
            j = torch.arange(window + tlen, device=dev)[None, :]
            key_ok = torch.where(j < window, (cache_offset - window + j) >= 0,
                                 (j - window) < q_valid)
            q_ok = (torch.arange(tlen, device=dev) < q_valid)[:, None]
            return Attention(bias=mask_ops.mask_to_bias(
                (key_ok & q_ok)[None, None]))
        boolmask = mask > 0
        if streaming and unit_align is not None:
            attn = boolmask[:, None, :] & mask_ops.unit_chunk_mask(
                tlen, unit_align, cfg.static_chunk_size, window, device=dev)
            return Attention(bias=mask_ops.mask_to_bias(attn[:, None]))
        # the key-pad mask [& the static chunk mask]: K1's and K2's function
        return Attention(
            kv_len=boolmask.sum(dim=1, dtype=torch.int32),
            chunk=cfg.static_chunk_size if streaming else 0,
            left_chunks=cfg.num_left_chunks)

    def forward(self, x, mask, mu, t, spks=None, cond=None,
                streaming: bool = False, collect_len: int | None = None,
                cache: dict | None = None, cache_offset: int = 0,
                q_valid: int | None = None, window: int = 100,
                unit_align: int | None = None):
        """x, mu, cond: (B, T, 80); mask: (B, T) float prefix mask; t: (B,);
        spks: (B, 80). Returns the velocity (B, T, 80).

        streaming: the static chunk mask (chunk `static_chunk_size`, left
        `num_left_chunks`) through K1 or K2; with unit_align (the prompt
        length in frames) the prompt-anchored unit grid limited to
        `window` left frames instead, by plain masked attention (the
        full-sequence twin of the chunked path). collect_len: the
        prompt's valid length; the full pass also returns the streaming
        state (velocity, state dict). cache: one chunk starting at
        absolute frame cache_offset, q_valid frames valid, against the
        state dict of the previous call (window-frame K/V tails, attended
        by plain torch ops); returns (velocity, new state dict)."""
        b, tlen, _ = x.shape
        collect = collect_len is not None
        chunked = cache is not None
        t_emb = self.time_mlp(sinusoidal_pos_emb(t, self.cfg.in_channels)
                              .to(x.dtype))
        feats = [x, mu]
        if spks is not None:
            feats.append(spks[:, None, :].expand(b, tlen, spks.shape[-1]))
        if cond is not None:
            feats.append(cond)
        h = torch.cat(feats, dim=-1)
        attn = self._attention(mask, tlen, streaming, chunked, cache_offset,
                               q_valid, window, unit_align)
        state = None
        if chunked:
            state = StreamState("chunk", cache=cache, window=window)
        elif collect:
            state = StreamState("collect", plen=collect_len, window=window)

        def stage_conv(stage, name, h):
            return causal_conv(stage[2], h * mask[..., None], state,
                               f"{name}_conv")

        skips = []
        for i, stage in enumerate(self.down):
            h = self._run_stage(stage, f"down_{i}", h, mask, t_emb, attn,
                                state)
            skips.append(h)
            h = stage_conv(stage, f"down_{i}", h)
        for i, stage in enumerate(self.mid):
            h = self._run_stage(stage, f"mid_{i}", h, mask, t_emb, attn,
                                state)
        for i, stage in enumerate(self.up):
            h = torch.cat([h, skips.pop()], dim=-1)
            h = self._run_stage(stage, f"up_{i}", h, mask, t_emb, attn,
                                state)
            h = stage_conv(stage, f"up_{i}", h)
        h = self.final_block(h, mask, state, "final_block")
        out = self.final_proj(h * mask[..., None]) * mask[..., None]
        return out if state is None else (out, state.out)
