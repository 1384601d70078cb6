"""S3 speech tokenizers: V2 (Whisper-style encoder + finite scalar
quantizer) and V1 (Whisper encoder + Euclidean codebook), and the
windowing of audio longer than 30 s.

Port of minimax_speech_tpu/models/s3tokenizer.py:
  * S3TokenizerV2: log-mel (B, T, 128) at 100 Hz -> two convs (stride
    2 each -> 25 Hz) -> residual attention blocks with RoPE and an FSMN
    memory conv on the value path -> Dense to 8 -> FSQ codes in
    [0, 6561);
  * S3TokenizerV1: two convs (the first of stride 2 for 25 Hz, 1 for
    50 Hz) -> sinusoidal positions -> plain Whisper attention blocks ->
    the nearest of 4096 codebook vectors;
  * quantize_long: a mel of any length cut into windows of 3000 frames
    with 4 s overlap, every window padded to 3000 and encoded in one
    batched call, the tokens merged with half the overlap dropped on
    each side of a junction;
and the converter of an upstream V2 state dict.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
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


def sinusoid_table(length: int, channels: int) -> np.ndarray:
    """Whisper's (length, channels) sinusoids, float32."""
    log_inc = np.log(10000) / (channels // 2 - 1)
    inv = np.exp(-log_inc * np.arange(channels // 2))
    ang = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(ang), np.cos(ang)], 1).astype(np.float32)


class PlainAttention(nn.Module):
    """Whisper attention: no RoPE, no FSMN, no key bias; q and k each
    scaled by d^-1/4, softmax in float32."""

    def __init__(self, n_state: int, n_head: int):
        super().__init__()
        self.n_head = n_head
        self.query = nn.Linear(n_state, n_state)
        self.key = nn.Linear(n_state, n_state, bias=False)
        self.value = nn.Linear(n_state, n_state)
        self.out = nn.Linear(n_state, n_state)

    def forward(self, x, attn_bias):
        b, t, c = x.shape
        d = c // self.n_head
        q, k, v = (f(x).view(b, t, self.n_head, d)
                   for f in (self.query, self.key, self.value))
        scale = d ** -0.25
        scores = torch.einsum("bqhd,bkhd->bhqk", q * scale, k * scale)
        w = torch.softmax((scores + attn_bias).float(), dim=-1).to(x.dtype)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, t,
                                                                      c))


class V1Block(nn.Module):
    def __init__(self, n_state: int, n_head: int):
        super().__init__()
        self.attn_ln = nn.LayerNorm(n_state, eps=1e-6)
        self.attn = PlainAttention(n_state, n_head)
        self.mlp_ln = nn.LayerNorm(n_state, eps=1e-6)
        self.mlp1 = nn.Linear(n_state, 4 * n_state)
        self.mlp2 = nn.Linear(4 * n_state, n_state)

    def forward(self, x, attn_bias):
        x = x + self.attn(self.attn_ln(x), attn_bias)
        return x + self.mlp2(F.gelu(self.mlp1(self.mlp_ln(x))))


class S3TokenizerV1(nn.Module):
    """Whisper encoder + Euclidean codebook: stride 2 gives 25 Hz codes
    (speech_tokenizer_v1_25hz), 1 gives 50 Hz."""

    def __init__(self, cfg: S3TokenizerConfig = S3TokenizerConfig(
            codebook_size=4096), stride: int = 2):
        super().__init__()
        self.cfg, self.stride = cfg, stride
        self.conv1 = nn.Conv1d(cfg.n_mels, cfg.n_state, 3, stride=stride,
                               padding=1)
        self.conv2 = nn.Conv1d(cfg.n_state, cfg.n_state, 3, stride=2,
                               padding=1)
        self.blocks = []
        for i in range(cfg.n_layer):
            blk = V1Block(cfg.n_state, cfg.n_head)
            self.add_module(f"blocks_{i}", blk)
            self.blocks.append(blk)
        self.codebook = nn.Parameter(torch.zeros(cfg.codebook_size,
                                                 cfg.n_state))

    def init_weights(self, generator):
        self.codebook.data.normal_(0.0, 1.0, generator=generator)

    def encode(self, mel, mel_len):
        """mel: (B, T, n_mels); mel_len: (B,). Returns (the encoder's
        output (B, T', n_state), its lengths (B,))."""
        m = mask_ops.make_non_pad_mask(mel_len, mel.shape[1]).to(mel.dtype)
        x = F.gelu(self.conv1((mel * m[..., None]).transpose(1, 2)))
        out_len = torch.div(mel_len - 1, self.stride,
                            rounding_mode="floor") + 1
        m = mask_ops.make_non_pad_mask(out_len, x.shape[-1]).to(x.dtype)
        x = F.gelu(self.conv2(x * m[:, None, :])).transpose(1, 2)
        out_len = torch.div(out_len - 1, 2, rounding_mode="floor") + 1
        x = x + torch.as_tensor(sinusoid_table(x.shape[1], self.cfg.n_state),
                                dtype=x.dtype, device=x.device)
        pad = mask_ops.make_non_pad_mask(out_len, x.shape[1])
        bias = mask_ops.mask_to_bias(pad[:, None, None, :])
        for blk in self.blocks:
            x = blk(x, bias)
        return x, out_len

    def forward(self, mel, mel_len):
        """Returns (codes (B, T') int32, code lengths (B,))."""
        x, out_len = self.encode(mel, mel_len)
        return nearest_code(x, self.codebook), out_len


def nearest_code(x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """argmax over the codebook of -(|x|^2 - 2 x.e + |e|^2): (B, T) int32."""
    dist = (-x.square().sum(-1, keepdim=True)
            + 2 * torch.einsum("btd,cd->btc", x, codebook)
            - codebook.square().sum(-1)[None, None, :])
    return dist.argmax(dim=-1).to(torch.int32)


WINDOW_FRAMES = 3000      # 30 s of 100 Hz mel frames
OVERLAP_FRAMES = 400      # 4 s
STRIDE_FRAMES = WINDOW_FRAMES - OVERLAP_FRAMES
TOKEN_RATE = 25
OVERLAP_DROP_TOKENS = (4 // 2) * TOKEN_RATE  # 50 tokens per merged side


def split_windows(mel: np.ndarray, mel_len: int) -> list:
    """(T, n_mels) -> windows of up to 3000 frames, every 2600."""
    wins, start = [], 0
    while start < mel_len:
        end = min(start + WINDOW_FRAMES, mel_len)
        wins.append(mel[start:end])
        if end >= mel_len:
            break
        start += STRIDE_FRAMES
    return wins


def merge_window_tokens(segments: list) -> list:
    """The windows' tokens joined, OVERLAP_DROP_TOKENS dropped on each
    side of every junction."""
    merged: list = []
    for i, toks in enumerate(segments):
        lo = 0 if i == 0 else OVERLAP_DROP_TOKENS
        hi = len(toks) if i == len(segments) - 1 \
            else len(toks) - OVERLAP_DROP_TOKENS
        merged.extend(toks[lo:hi])
    return merged


@torch.no_grad()
def quantize_long(model: nn.Module, mel: np.ndarray, mel_len: int) -> list:
    """Tokens (a list of ints) of a mel (T, n_mels) of any length through
    `model` (S3TokenizerV1 or V2): its windows padded to WINDOW_FRAMES and
    encoded in one batched call on the model's device."""
    if mel.shape[0] < mel_len:
        raise ValueError(f"mel has {mel.shape[0]} frames < mel_len={mel_len}")
    wins = split_windows(mel, mel_len)
    batch = np.zeros((len(wins), WINDOW_FRAMES, mel.shape[1]), mel.dtype)
    for i, w in enumerate(wins):
        batch[i, : w.shape[0]] = w
    dev = next(model.parameters()).device
    codes, code_len = model(
        torch.as_tensor(batch, device=dev),
        torch.tensor([w.shape[0] for w in wins], dtype=torch.int32,
                     device=dev))
    codes, code_len = codes.cpu().numpy(), code_len.cpu().numpy()
    segments = [codes[i, : code_len[i]].tolist() for i in range(len(wins))]
    return segments[0] if len(segments) == 1 else \
        merge_window_tokens(segments)


def params_from_torch_state(state: dict) -> dict:
    """An upstream S3TokenizerV2 state dict (numpy arrays: encoder.conv1,
    encoder.blocks.{i}.attn.query ..., quantizer._codebook.project_down)
    -> the flax variables {"params": ...} that params_io loads, as the
    JAX package's params_from_torch_state maps them. Conv1d weights
    (out, in, k) become (k, in, out), Linear (out, in) becomes (in, out)."""
    def conv_w(w):
        return np.transpose(w, (2, 1, 0))

    def dense_w(w):
        return np.transpose(w, (1, 0))

    enc: dict = {
        "conv1": {"kernel": conv_w(state["encoder.conv1.weight"]),
                  "bias": state["encoder.conv1.bias"]},
        "conv2": {"kernel": conv_w(state["encoder.conv2.weight"]),
                  "bias": state["encoder.conv2.bias"]}}
    n_layer = 1 + max(int(k.split(".")[2]) for k in state
                      if k.startswith("encoder.blocks."))
    for i in range(n_layer):
        pre = f"encoder.blocks.{i}."
        enc[f"blocks_{i}"] = {
            "attn_ln": {"scale": state[pre + "attn_ln.weight"],
                        "bias": state[pre + "attn_ln.bias"]},
            "mlp_ln": {"scale": state[pre + "mlp_ln.weight"],
                       "bias": state[pre + "mlp_ln.bias"]},
            "mlp1": {"kernel": dense_w(state[pre + "mlp.0.weight"]),
                     "bias": state[pre + "mlp.0.bias"]},
            "mlp2": {"kernel": dense_w(state[pre + "mlp.2.weight"]),
                     "bias": state[pre + "mlp.2.bias"]},
            "attn": {
                "query": {"kernel": dense_w(state[pre + "attn.query.weight"]),
                          "bias": state[pre + "attn.query.bias"]},
                "key": {"kernel": dense_w(state[pre + "attn.key.weight"])},
                "value": {"kernel": dense_w(state[pre + "attn.value.weight"]),
                          "bias": state[pre + "attn.value.bias"]},
                "out": {"kernel": dense_w(state[pre + "attn.out.weight"]),
                        "bias": state[pre + "attn.out.bias"]},
                # depthwise Conv1d weight (C, 1, k) -> (k, 1, C)
                "fsmn_block": {"kernel": conv_w(
                    state[pre + "attn.fsmn_block.weight"])},
            },
        }
    return {"params": {"encoder": enc, "project_down": {
        "kernel": dense_w(state["quantizer._codebook.project_down.weight"]),
        "bias": state["quantizer._codebook.project_down.bias"]}}}
