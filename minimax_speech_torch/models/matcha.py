"""Matcha-TTS: text encoder, monotonic alignment search, durations, CFM.

Port of minimax_speech_tpu/models/matcha.py:
  * TextEncoder: scaled embedding -> conv prenet -> transformer layers
    (rotary attention on half of each head's dims) -> the mu projection,
    and a duration predictor on the detached features;
  * training (`MatchaTTS.forward`): MAS (ops/monotonic_align.py) aligns
    text to mels under the Gaussian prior; losses = duration MSE + prior
    NLL + CFM reconstruction;
  * synthesis (`matcha_synthesise`): predicted durations expand mu_x to
    the frame rate over a fixed max_frames, and the CFM decodes.

The decoder is the causal UNet of models/decoder_unet.py at Matcha's
geometry; it attends with the frame mask as key lengths through K1
without grad (synthesis) and K2 under grad (the training step). The text
encoder's rotary attention carries a (B, 1, T, T) pad bias, plain torch
ops as it is XLA attention in the JAX package. Channel-last (B, T, C).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from minimax_speech_torch.models import cfm as cfm_lib
from minimax_speech_torch.models.decoder_unet import (CausalConditionalDecoder,
                                                      DecoderUNetConfig)
from minimax_speech_torch.ops import masks as mask_ops
from minimax_speech_torch.ops import monotonic_align as ma
from minimax_speech_torch.ops import rope as rope_ops
from minimax_speech_torch.utils.device import check_on, resolve_device


@dataclass(frozen=True)
class MatchaConfig:
    n_vocab: int = 178
    n_feats: int = 80
    hidden: int = 192
    n_heads: int = 2
    n_layers: int = 6
    filter_channels: Optional[int] = None  # FFN width; None -> 4*hidden
    enc_kernel: int = 3
    prenet_kernel: int = 5
    dp_kernel: int = 3
    dp_filters: int = 256
    rope_base: float = 10000.0
    unet: DecoderUNetConfig = field(default_factory=lambda: DecoderUNetConfig(
        in_channels=160, out_channels=80, channels=(256,),
        attention_head_dim=64, n_blocks=1, num_mid_blocks=2, num_heads=4))
    cfm: cfm_lib.CFMConfig = field(default_factory=lambda: cfm_lib.CFMConfig(
        use_immiscible=False, use_contrastive_fm=False,
        training_cfg_rate=0.0, inference_cfg_rate=0.0))
    n_timesteps: int = 10


class ChanLayerNorm(nn.Module):
    """glow-tts LayerNorm over channels, eps 1e-4 (parameters gamma,
    beta)."""

    def __init__(self, channels: int, eps: float = 1e-4):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def init_weights(self, generator):
        self.gamma.data.fill_(1.0)
        self.beta.data.zero_()

    def forward(self, x):
        m = x.mean(dim=-1, keepdim=True)
        v = (x - m).square().mean(dim=-1, keepdim=True)
        return (x - m) * torch.rsqrt(v + self.eps) * self.gamma + self.beta


class ZeroLinear(nn.Linear):
    """A Linear initialised to zero (the prenet's residual projection)."""

    def init_weights(self, generator):
        self.weight.data.zero_()
        self.bias.data.zero_()


def _conv_same(dim_in: int, dim_out: int, k: int) -> nn.Conv1d:
    return nn.Conv1d(dim_in, dim_out, k, padding=k // 2)


def _conv(conv: nn.Conv1d, x):
    """A (B, C, T) conv over channel-last frames."""
    return conv(x.transpose(1, 2)).transpose(1, 2)


class ConvReluNorm(nn.Module):
    """Residual conv prenet: n_layers of conv -> ChanLayerNorm -> ReLU,
    then a zero-initialised projection."""

    def __init__(self, hidden: int, kernel: int = 5, n_layers: int = 3):
        super().__init__()
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(f"conv_{i}", _conv_same(hidden, hidden, kernel))
            self.add_module(f"norm_{i}", ChanLayerNorm(hidden))
        self.proj = ZeroLinear(hidden, hidden)

    def forward(self, x, mask):
        h = x
        for i in range(self.n_layers):
            h = _conv(getattr(self, f"conv_{i}"), h * mask)
            h = F.relu(getattr(self, f"norm_{i}")(h))
        return (x + self.proj(h)) * mask


class RotaryAttention(nn.Module):
    """Self-attention with rotary embeddings on the first half of each
    head's dims (the rest passes through), softmax in float32 with an
    additive bias."""

    def __init__(self, channels: int, heads: int, rope_base: float = 10000.0):
        super().__init__()
        self.heads, self.rope_base = heads, rope_base
        for nm in ("q", "k", "v", "o"):
            self.add_module(f"conv_{nm}", nn.Linear(channels, channels))

    def forward(self, x, bias):
        b, t, c = x.shape
        hd = c // self.heads
        q, k, v = (getattr(self, f"conv_{nm}")(x).view(b, t, self.heads, hd)
                   for nm in ("q", "k", "v"))
        d_rope = int(hd * 0.5)
        cos, sin = rope_ops.rope_cos_sin(t, d_rope, self.rope_base,
                                         dtype=x.dtype, device=x.device)
        qr, kr = rope_ops.apply_rope(q[..., :d_rope], k[..., :d_rope], cos,
                                     sin)
        q = torch.cat([qr, q[..., d_rope:]], dim=-1)
        k = torch.cat([kr, k[..., d_rope:]], dim=-1)
        w = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(hd)
        w = torch.softmax(w.float() + bias, dim=-1).to(x.dtype)
        a = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, t, c)
        return self.conv_o(a)


class FFN(nn.Module):
    """conv -> ReLU -> conv, masked between."""

    def __init__(self, channels: int, filters: int, kernel: int):
        super().__init__()
        self.conv_1 = _conv_same(channels, filters, kernel)
        self.conv_2 = _conv_same(filters, channels, kernel)

    def forward(self, x, mask):
        h = F.relu(_conv(self.conv_1, x * mask))
        return _conv(self.conv_2, h * mask) * mask


class DurationPredictor(nn.Module):
    """(conv -> ReLU -> ChanLayerNorm) x 2 -> a 1-channel projection: the
    log durations (B, T)."""

    def __init__(self, channels: int, filters: int, kernel: int):
        super().__init__()
        self.conv_1 = _conv_same(channels, filters, kernel)
        self.norm_1 = ChanLayerNorm(filters)
        self.conv_2 = _conv_same(filters, filters, kernel)
        self.norm_2 = ChanLayerNorm(filters)
        self.proj = nn.Linear(filters, 1)

    def forward(self, x, mask):
        m = mask[..., None]
        h = self.norm_1(F.relu(_conv(self.conv_1, x * m)))
        h = self.norm_2(F.relu(_conv(self.conv_2, h * m)))
        return self.proj(h * m)[..., 0] * mask


class TextEncoder(nn.Module):
    """The glow-tts/Matcha text encoder: -> (mu_x (B, T, n_feats), logw
    (B, T), the text mask (B, T) float)."""

    def __init__(self, cfg: MatchaConfig):
        super().__init__()
        self.cfg = c = cfg
        self.emb = nn.Embedding(c.n_vocab, c.hidden)
        self.prenet = ConvReluNorm(c.hidden, c.prenet_kernel)
        filters = c.filter_channels or 4 * c.hidden
        for i in range(c.n_layers):
            self.add_module(f"attn_{i}", RotaryAttention(c.hidden, c.n_heads,
                                                         c.rope_base))
            self.add_module(f"norm1_{i}", ChanLayerNorm(c.hidden))
            self.add_module(f"ffn_{i}", FFN(c.hidden, filters, c.enc_kernel))
            self.add_module(f"norm2_{i}", ChanLayerNorm(c.hidden))
        self.proj_m = nn.Linear(c.hidden, c.n_feats)
        self.dp = DurationPredictor(c.hidden, c.dp_filters, c.dp_kernel)

    def forward(self, tokens, token_len):
        c = self.cfg
        h = self.emb(tokens) * np.sqrt(c.hidden)
        mask = mask_ops.make_non_pad_mask(token_len, tokens.shape[1]).to(
            h.dtype)
        m3 = mask[..., None]
        h = self.prenet(h, m3)
        # the reference's masked_fill(-1e4) as an additive (B, 1, T, T) bias
        pair = mask[:, None, :, None] * mask[:, None, None, :]
        bias = torch.where(pair > 0, 0.0, -1e4)
        for i in range(c.n_layers):
            h = h * m3
            y = getattr(self, f"attn_{i}")(h, bias)
            h = getattr(self, f"norm1_{i}")(h + y)
            y = getattr(self, f"ffn_{i}")(h, m3)
            h = getattr(self, f"norm2_{i}")(h + y)
        h = h * m3
        mu_x = self.proj_m(h) * m3
        return mu_x, self.dp(h.detach(), mask), mask


class MatchaTTS(nn.Module):
    def __init__(self, cfg: MatchaConfig = MatchaConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = TextEncoder(cfg)
        # x, mu and the zero spks and cond, packed: 4 x n_feats channels
        self.decoder = CausalConditionalDecoder(cfg.unet,
                                                in_dim=4 * cfg.n_feats)

    def estimate(self, x, mask, mu, t, spks, cond, streaming: bool = False):
        return self.decoder(x, mask, mu, t, spks, cond, streaming=streaming)

    def forward(self, tokens, token_len, mels, mel_len,
                draws: cfm_lib.CFMDraws):
        """The training losses (dur_loss, prior_loss, cfm_loss). tokens
        (B, Tx); mels (B, Ty, n_feats); draws: the CFM's
        (cfm_lib.make_draws)."""
        c = self.cfg
        mu_x, logw, x_mask = self.encoder(tokens, token_len)
        tf = mels.shape[1]
        y_mask = mask_ops.make_non_pad_mask(mel_len, tf).to(mels.dtype)

        # MAS on the Gaussian prior's log-likelihood
        const = -0.5 * np.log(2 * np.pi) * c.n_feats
        logp = (-0.5 * (mels.square().sum(-1)[:, None, :]
                        - 2 * torch.einsum("bxd,byd->bxy", mu_x, mels)
                        + mu_x.square().sum(-1)[:, :, None]) + const)
        attn_mask = (x_mask[:, :, None] * y_mask[:, None, :]) > 0
        path = ma.maximum_path(logp.detach(), attn_mask).to(mu_x.dtype)

        dur = path.sum(dim=-1)
        logw_gt = torch.log(1e-8 + dur) * x_mask
        dur_loss = (logw - logw_gt).square().sum() / torch.clamp(
            x_mask.sum(), min=1.0)

        mu_y = torch.einsum("bxy,bxd->byd", path, mu_x)
        prior = 0.5 * ((mels - mu_y).square() + np.log(2 * np.pi)) \
            * y_mask[..., None]
        prior_loss = prior.sum() / torch.clamp(y_mask.sum() * c.n_feats,
                                               min=1.0)

        spks = mels.new_zeros((mels.shape[0], c.n_feats))
        cfm_loss = cfm_lib.compute_loss(self.estimate, mels, y_mask, mu_y,
                                        spks, torch.zeros_like(mels), c.cfm,
                                        draws)
        return dur_loss, prior_loss, cfm_loss

    def synthesise_mu(self, tokens, token_len, length_scale: float = 1.0,
                      max_frames: int = 1000):
        """Durations -> the frame-aligned mu (B, max_frames, n_feats) and
        the frame lengths (B,), with no host read."""
        mu_x, logw, x_mask = self.encoder(tokens, token_len)
        dur = torch.ceil(torch.exp(logw) * x_mask * length_scale).long()
        ends = torch.cumsum(dur, dim=-1)
        starts = ends - dur
        frames = torch.arange(max_frames, device=tokens.device)
        # frame f takes text position x where start <= f < end
        inside = ((frames[None, None, :] >= starts[:, :, None])
                  & (frames[None, None, :] < ends[:, :, None]))
        mu_y = torch.einsum("bxf,bxd->bfd", inside.to(mu_x.dtype), mu_x)
        last = torch.clamp(token_len - 1, min=0)
        y_len = torch.clamp(
            ends[torch.arange(tokens.shape[0], device=tokens.device), last],
            max=max_frames)
        return mu_y, y_len


@torch.no_grad()
def matcha_synthesise(model: MatchaTTS, tokens, token_len,
                      generator: Optional[torch.Generator] = None, z=None,
                      n_timesteps: Optional[int] = None,
                      length_scale: float = 1.0, max_frames: int = 1000,
                      temperature: float = 0.667, device=None):
    """Text ids (B, Tx) -> (mel (B, max_frames, n_feats), frame lengths
    (B,)). The solve starts from temperature x z, z standard normal
    (B, max_frames, n_feats): the given one, or drawn from `generator`
    (on the model's device). Runs on `device` (default cuda; the model
    must live there)."""
    c = model.cfg
    dev = resolve_device(device)
    check_on(model, dev, "the Matcha model")
    tokens = torch.as_tensor(tokens, device=dev).long()
    token_len = torch.as_tensor(token_len, device=dev).long()
    mu_y, y_len = model.synthesise_mu(tokens, token_len, length_scale,
                                      max_frames)
    mask = mask_ops.make_non_pad_mask(y_len, max_frames).to(mu_y.dtype)
    if z is None:
        z = torch.randn(mu_y.shape, generator=generator, device=dev)
    z = torch.as_tensor(z, device=dev, dtype=mu_y.dtype) * temperature
    spks = mu_y.new_zeros((mu_y.shape[0], c.n_feats))
    mel = cfm_lib.solve_euler(model.estimate, z, mu_y, mask, spks,
                              torch.zeros_like(mu_y),
                              n_timesteps or c.n_timesteps, c.cfm)
    return mel, y_len
