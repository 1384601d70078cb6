"""Upsampling conformer encoder of the stage-2 flow model.

Port of minimax_speech_tpu/models/upsample_encoder.py: token embedding
(25 Hz) -> pre-lookahead conv (3 tokens of future context) -> conformer
blocks -> nearest 2x upsample + conv -> conformer blocks (50 Hz).

Full sequence (`forward`): full attention, or with `streaming` static
chunk masks (25 tokens, 50 frames after the upsample), or with
`chunk_align` the prompt-anchored unit grid (ops/masks.unit_chunk_mask)
that the chunked path computes. Chunked streaming (`prefill`,
`chunk_step`): each conformer layer keeps a preallocated KV cache and
the pre-lookahead and upsample convs keep short input tails, so a hop
costs O(chunk); the state is the dict of `make_encoder_cache`, whose KV
caches the calls write in place.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from minimax_speech_torch.models import conformer as cf
from minimax_speech_torch.ops import masks as mask_ops


@dataclass(frozen=True)
class UpsampleEncoderConfig:
    input_size: int = 512
    output_size: int = 512
    attention_heads: int = 8
    linear_units: int = 2048
    num_blocks: int = 6
    num_up_blocks: int = 4
    static_chunk_size: int = 25
    pre_lookahead_len: int = 3
    up_stride: int = 2
    key_bias: bool = True


def conv_nwc(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """Apply a Conv1d to channel-last (B, T, C) input."""
    return conv(x.transpose(1, 2)).transpose(1, 2)


class PreLookaheadLayer(nn.Module):
    """conv (k = L+1) peeking L frames ahead, leaky ReLU, causal conv
    (k = 3), residual."""

    def __init__(self, channels: int, pre_lookahead_len: int = 3):
        super().__init__()
        self.pre_lookahead_len = pre_lookahead_len
        self.conv1 = nn.Conv1d(channels, channels, pre_lookahead_len + 1)
        self.conv2 = nn.Conv1d(channels, channels, 3)

    def forward(self, x, context=None):
        """x: (B, T, C); context: (B, L, C) real future frames, or None
        for zero right padding."""
        if context is not None:
            h = torch.cat([x, context], dim=1)
        else:
            h = F.pad(x, (0, 0, 0, self.pre_lookahead_len))
        h = F.leaky_relu(conv_nwc(self.conv1, h), negative_slope=0.01)
        h = conv_nwc(self.conv2, F.pad(h, (0, 0, 2, 0)))
        return h + x

    def chunk(self, x, conv2_cache, has_context: bool):
        """Streaming chunk. x: (B, cq + L, C), the chunk then L real future
        frames, when has_context; else (B, cq, C) with zero right padding.
        conv2_cache: (B, 2, C), the previous conv1 outputs. Returns (out
        (B, cq, C), this chunk's conv1 outputs (B, cq, C))."""
        L = self.pre_lookahead_len
        if has_context:
            h = conv_nwc(self.conv1, x)
            x = x[:, : x.shape[1] - L]
        else:
            h = conv_nwc(self.conv1, F.pad(x, (0, 0, 0, L)))
        h = F.leaky_relu(h, negative_slope=0.01)
        out = conv_nwc(self.conv2, torch.cat([conv2_cache, h], dim=1))
        return out + x, h


class Upsample1D(nn.Module):
    """Nearest repeat by `stride`, then a left-padded conv (k = 2s+1)."""

    def __init__(self, channels: int, stride: int = 2):
        super().__init__()
        self.stride = stride
        self.conv = nn.Conv1d(channels, channels, stride * 2 + 1)

    def forward(self, x):
        h = torch.repeat_interleave(x, self.stride, dim=1)
        return conv_nwc(self.conv, F.pad(h, (0, 0, self.stride * 2, 0)))

    def chunk(self, x, cache):
        """x: (B, cq, C); cache: (B, 2*stride, C), the previous repeated
        frames. Returns (out (B, cq*stride, C), the repeated frames)."""
        h = torch.repeat_interleave(x, self.stride, dim=1)
        return conv_nwc(self.conv, torch.cat([cache, h], dim=1)), h


class InputEmbed(nn.Module):
    """Dense + LayerNorm (eps 1e-5), then x * sqrt(d)."""

    def __init__(self, input_size: int, output_size: int):
        super().__init__()
        self.output_size = output_size
        self.linear = nn.Linear(input_size, output_size)
        self.norm = nn.LayerNorm(output_size, eps=1e-5)

    def forward(self, x):
        return self.norm(self.linear(x)) * math.sqrt(self.output_size)


def make_encoder_cache(cfg: UpsampleEncoderConfig, batch: int,
                       max_tokens: int, device=None) -> dict:
    """Streaming state: a preallocated (2, B, M, H, D) KV cache per
    conformer layer (M = max_tokens before the upsample, stride x after)
    and the two conv tails."""
    h, d = cfg.attention_heads, cfg.output_size // cfg.attention_heads
    s = cfg.up_stride

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    return {"kv1": [zeros(2, batch, max_tokens, h, d)
                    for _ in range(cfg.num_blocks)],
            "kv2": [zeros(2, batch, max_tokens * s, h, d)
                    for _ in range(cfg.num_up_blocks)],
            "pre_c2": zeros(batch, 2, cfg.output_size),
            "up_c": zeros(batch, 2 * s, cfg.output_size)}


class UpsampleConformerEncoder(nn.Module):
    def __init__(self, cfg: UpsampleEncoderConfig = UpsampleEncoderConfig()):
        super().__init__()
        self.cfg = cfg
        c = cfg.output_size
        self.embed = InputEmbed(cfg.input_size, c)
        self.pre_lookahead_layer = PreLookaheadLayer(c, cfg.pre_lookahead_len)
        self.encoders = self._layers("encoders", cfg.num_blocks)
        self.up_layer = Upsample1D(c, cfg.up_stride)
        self.up_embed = InputEmbed(c, c)
        self.up_encoders = self._layers("up_encoders", cfg.num_up_blocks)
        self.after_norm = nn.LayerNorm(c, eps=1e-5)

    def _layers(self, name: str, n: int):
        cfg = self.cfg
        layers = []
        for i in range(n):
            layer = cf.ConformerEncoderLayer(
                cfg.attention_heads, cfg.linear_units, key_bias=cfg.key_bias,
                d_model=cfg.output_size)
            self.add_module(f"{name}_{i}", layer)
            layers.append(layer)
        return layers

    def forward(self, xs, xs_lens, context=None, streaming: bool = False,
                chunk_align: int | None = None):
        """xs: (B, T, input_size); xs_lens: (B,); context: (B, L,
        input_size) real future frames for the pre-lookahead conv, or
        None. streaming: static chunk masks; with chunk_align (the prompt
        length in tokens) the prompt-anchored unit grid instead. Returns
        ((B, T*stride, output_size), out_lens)."""
        cfg = self.cfg
        s = cfg.up_stride
        t = xs.shape[1]
        pad = mask_ops.make_non_pad_mask(xs_lens, t)
        # zero the padding after the embed: its LayerNorm un-zeroes it, and
        # the pre-lookahead conv reads frames ahead
        xs = self.embed(xs) * pad[..., None].to(xs.dtype)
        if context is not None:
            context = self.embed(context)
        chunk = cfg.static_chunk_size if streaming else 0

        def attn_mask(pad_mask, n, align, size):
            if streaming and chunk_align is not None:
                return pad_mask[:, None, :] & mask_ops.unit_chunk_mask(
                    n, align, size, device=pad_mask.device)
            return mask_ops.add_optional_chunk_mask(pad_mask, size)

        mask1 = attn_mask(pad, t, chunk_align, chunk)
        pos_emb = cf.espnet_rel_pos_emb(t, cfg.output_size, xs.dtype,
                                        xs.device)
        xs = self.pre_lookahead_layer(xs, context)
        for layer in self.encoders:
            xs = layer(xs, mask1, pos_emb, pad.to(xs.dtype))

        xs = self.up_layer(xs)
        up_lens = xs_lens * s
        t2 = xs.shape[1]
        pad2 = mask_ops.make_non_pad_mask(up_lens, t2)
        xs = self.up_embed(xs)
        mask2 = attn_mask(pad2, t2, None if chunk_align is None
                          else chunk_align * s, chunk * s)
        pos_emb2 = cf.espnet_rel_pos_emb(t2, cfg.output_size, xs.dtype,
                                         xs.device)
        for layer in self.up_encoders:
            xs = layer(xs, mask2, pos_emb2, pad2.to(xs.dtype))
        return self.after_norm(xs), up_lens

    # -- chunked streaming -------------------------------------------------
    def _run_chunk(self, xs, cache: dict, offset: int, q_valid: int,
                   has_context: bool, prefill: bool,
                   embed_valid: int | None = None):
        """The body of prefill and chunk_step. xs: embedded tokens (B, cq
        [+ L], input_size); frames at and past `embed_valid` are zeroed
        after the input embed, as the full path masks its padding."""
        cfg = self.cfg
        s = cfg.up_stride
        xs = self.embed(xs)
        if embed_valid is not None:
            keep = torch.arange(xs.shape[1], device=xs.device) < embed_valid
            xs = xs * keep[None, :, None].to(xs.dtype)

        xs, h1 = self.pre_lookahead_layer.chunk(xs, cache["pre_c2"],
                                                has_context)
        cq = xs.shape[1]
        pre_c2 = (mask_ops.tail(h1, 2, q_valid) if prefill
                  else h1[:, cq - 2: cq])

        pos1 = cf.espnet_rel_pos_emb(cache["kv1"][0].shape[2],
                                     cfg.output_size, xs.dtype, xs.device)
        key_len = offset + q_valid
        kv1 = []
        for layer, kvc in zip(self.encoders, cache["kv1"]):
            xs, kvc = layer.chunk(xs, kvc, offset, key_len, pos1, q_valid)
            kv1.append(kvc)

        xs, hrep = self.up_layer.chunk(xs, cache["up_c"])
        up_c = (mask_ops.tail(hrep, 2 * s, q_valid * s) if prefill
                else hrep[:, cq * s - 2 * s: cq * s])

        xs = self.up_embed(xs)
        pos2 = cf.espnet_rel_pos_emb(cache["kv2"][0].shape[2],
                                     cfg.output_size, xs.dtype, xs.device)
        kv2 = []
        for layer, kvc in zip(self.up_encoders, cache["kv2"]):
            xs, kvc = layer.chunk(xs, kvc, offset * s, key_len * s, pos2,
                                  q_valid * s)
            kv2.append(kvc)
        return self.after_norm(xs), {"kv1": kv1, "kv2": kv2,
                                     "pre_c2": pre_c2, "up_c": up_c}

    def prefill(self, xs_buf, plen: int, cache: dict):
        """The prompt unit. xs_buf: (B, P, input_size) embedded tokens:
        the prompt at [0, plen), the next chunk's first L tokens at
        [plen, plen + L), the rest zeros. Returns ((B, 2P, C), valid
        through 2*plen, and the streaming state)."""
        return self._run_chunk(xs_buf, cache, 0, plen, has_context=False,
                               prefill=True,
                               embed_valid=plen + self.cfg.pre_lookahead_len)

    def chunk_step(self, xs_chunk, cache: dict, offset: int, q_valid: int,
                   context=None):
        """One hop. xs_chunk: (B, cq, input_size) embedded tokens starting
        at absolute token `offset`, zero past q_valid; context: (B, L,
        input_size) the real next tokens, or None for the final chunk.
        Returns ((B, cq*stride, C), the streaming state)."""
        if context is not None:
            return self._run_chunk(torch.cat([xs_chunk, context], dim=1),
                                   cache, offset, q_valid, has_context=True,
                                   prefill=False)
        return self._run_chunk(xs_chunk, cache, offset, q_valid,
                               has_context=False, prefill=False,
                               embed_valid=q_valid)
