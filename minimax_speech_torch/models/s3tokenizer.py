"""S3 FSQ speech tokenizer V2: Whisper-style encoder + finite scalar
quantizer, one window of up to 30 s.

Port of S3TokenizerV2 of minimax_speech_tpu/models/s3tokenizer.py:
log-mel (B, T, 128) at 100 Hz -> two stride-2 convs (-> 25 Hz) ->
residual attention blocks with RoPE and an FSMN memory conv on the
value path -> Dense to 8 -> FSQ codes in [0, 6561). Long-audio windowing
(quantize_long) and V1 are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from minimax_speech_torch.ops import fsq as fsq_ops
from minimax_speech_torch.ops import masks as mask_ops
from minimax_speech_torch.ops import rope as rope_ops


@dataclass(frozen=True)
class S3TokenizerConfig:
    n_mels: int = 128
    n_state: int = 1280
    n_head: int = 20
    n_layer: int = 6
    stride: int = 2          # first conv stride; total subsample = stride*2
    fsmn_kernel: int = 31
    codebook_size: int = fsq_ops.CODEBOOK_SIZE
    max_position: int = 2048


class FSMNAttention(nn.Module):
    """Self-attention plus an FSMN depthwise-conv memory on V."""

    def __init__(self, n_state: int, n_head: int, fsmn_kernel: int = 31):
        super().__init__()
        self.n_head = n_head
        self.fsmn_kernel = fsmn_kernel
        c = n_state
        self.query = nn.Linear(c, c)
        self.key = nn.Linear(c, c, bias=False)
        self.value = nn.Linear(c, c)
        self.fsmn_block = nn.Conv1d(c, c, fsmn_kernel, groups=c, bias=False)
        self.out = nn.Linear(c, c)

    def forward(self, x, attn_bias, pad_mask, cos, sin):
        b, t, c = x.shape
        d = c // self.n_head
        q = self.query(x)
        k = self.key(x)
        v = self.value(x)
        qh, kh = rope_ops.apply_rope(q.view(b, t, self.n_head, d),
                                     k.view(b, t, self.n_head, d),
                                     cos[:t], sin[:t])
        vh = v.view(b, t, self.n_head, d)

        v_masked = v * pad_mask[..., None]
        p = (self.fsmn_kernel - 1) // 2  # "SAME" for an odd kernel
        mem = self.fsmn_block(F.pad(v_masked.transpose(1, 2), (p, p)))
        mem = (mem.transpose(1, 2) + v_masked) * pad_mask[..., None]

        scale = d ** -0.25
        scores = torch.einsum("bqhd,bkhd->bhqk", qh * scale, kh * scale)
        w = torch.softmax((scores + attn_bias).float(), dim=-1).to(x.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", w, vh).reshape(b, t, c)
        return self.out(o) + mem


class ResidualAttentionBlock(nn.Module):
    def __init__(self, n_state: int, n_head: int, fsmn_kernel: int = 31):
        super().__init__()
        self.attn_ln = nn.LayerNorm(n_state, eps=1e-6)
        self.attn = FSMNAttention(n_state, n_head, fsmn_kernel)
        self.mlp_ln = nn.LayerNorm(n_state, eps=1e-6)
        self.mlp1 = nn.Linear(n_state, 4 * n_state)
        self.mlp2 = nn.Linear(4 * n_state, n_state)

    def forward(self, x, attn_bias, pad_mask, cos, sin):
        x = x + self.attn(self.attn_ln(x), attn_bias, pad_mask, cos, sin)
        return x + self.mlp2(F.gelu(self.mlp1(self.mlp_ln(x))))


class AudioEncoderV2(nn.Module):
    def __init__(self, cfg: S3TokenizerConfig):
        super().__init__()
        self.cfg = cfg
        self.conv1 = nn.Conv1d(cfg.n_mels, cfg.n_state, 3, stride=cfg.stride,
                               padding=1)
        self.conv2 = nn.Conv1d(cfg.n_state, cfg.n_state, 3, stride=2,
                               padding=1)
        self.blocks = []
        for i in range(cfg.n_layer):
            blk = ResidualAttentionBlock(cfg.n_state, cfg.n_head,
                                         cfg.fsmn_kernel)
            self.add_module(f"blocks_{i}", blk)
            self.blocks.append(blk)

    def forward(self, mel, mel_len):
        """mel: (B, T, n_mels) -> (hidden (B, T/4, n_state), lengths)."""
        cfg = self.cfg
        m = mask_ops.make_non_pad_mask(mel_len, mel.shape[1]).to(mel.dtype)
        x = F.gelu(self.conv1((mel * m[..., None]).transpose(1, 2)))
        out_len = torch.div(mel_len - 1, cfg.stride, rounding_mode="floor") + 1
        m = mask_ops.make_non_pad_mask(out_len, x.shape[-1]).to(x.dtype)
        x = F.gelu(self.conv2(x * m[:, None, :])).transpose(1, 2)
        out_len = torch.div(out_len - 1, 2, rounding_mode="floor") + 1

        pad_mask = mask_ops.make_non_pad_mask(out_len, x.shape[1])
        attn_bias = mask_ops.mask_to_bias(pad_mask[:, None, None, :])
        cos, sin = rope_ops.rope_cos_sin(cfg.max_position,
                                         cfg.n_state // cfg.n_head,
                                         dtype=x.dtype, device=x.device)
        pm = pad_mask.to(x.dtype)
        for blk in self.blocks:
            x = blk(x, attn_bias, pm, cos, sin)
        return x, out_len


class S3TokenizerV2(nn.Module):
    """Encoder + FSQ -> discrete 25 Hz speech tokens."""

    def __init__(self, cfg: S3TokenizerConfig = S3TokenizerConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = AudioEncoderV2(cfg)
        self.project_down = nn.Linear(cfg.n_state, 8)

    def forward(self, mel, mel_len):
        """mel: (B, T, n_mels); mel_len: (B,). Returns (codes (B, T/4)
        int32, code lengths (B,))."""
        hidden, code_len = self.encoder(mel, mel_len)
        return fsq_ops.fsq_encode(self.project_down(hidden)), code_len
