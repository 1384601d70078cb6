"""Upsampling conformer encoder of the flow, full sequence: a frozen copy
of the port's (token embedding, pre-lookahead conv, conformer blocks,
nearest 2x upsample + conv, conformer blocks; with `streaming` static
chunk masks), without its chunked streaming path."""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from speechbench.reference import conformer as cf
from speechbench.reference import masks as mask_ops


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


class Upsample1D(nn.Module):
    """Nearest repeat by `stride`, then a left-padded conv (k = 2s+1)."""

    def __init__(self, channels: int, stride: int = 2):
        super().__init__()
        self.stride = stride
        self.conv = nn.Conv1d(channels, channels, stride * 2 + 1)

    def forward(self, x):
        h = torch.repeat_interleave(x, self.stride, dim=1)
        return conv_nwc(self.conv, F.pad(h, (0, 0, self.stride * 2, 0)))


class InputEmbed(nn.Module):
    """Dense + LayerNorm (eps 1e-5), then x * sqrt(d)."""

    def __init__(self, input_size: int, output_size: int):
        super().__init__()
        self.output_size = output_size
        self.linear = nn.Linear(input_size, output_size)
        self.norm = nn.LayerNorm(output_size, eps=1e-5)

    def forward(self, x):
        return self.norm(self.linear(x)) * math.sqrt(self.output_size)


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
