"""Legacy CosyVoice1 mel flow: MaskedDiffWithXvec.

Port of minimax_speech_tpu/models/legacy_flow.py, the non-causal
predecessor of models/flow.py: token embedding -> plain (full-attention)
conformer encoder -> Linear to 80 -> InterpolateRegulator (a linear
resample to the 22050/256 Hz mel grid) -> the non-causal conditional
UNet, with real down- and upsampling when len(channels) > 1, solved by
the OT-CFM of models/cfm.py. Channel-last (B, T, C).

The UNet's transformer blocks are the causal UNet's
(decoder_unet.UNetTransformerBlock); each stage attends with its frame
mask as key lengths, through K1 without grad and K2 under grad, as the
causal UNet does. The masks are prefix masks at every stage (the mask
halves by m[:, ::2] at each down stage, and a prefix stays a prefix), so
key lengths state the JAX package's -1e9 key bias exactly. The strided
conv and the transposed conv are torch's Conv1d(stride=2, padding=1) and
ConvTranspose1d(k=4, s=2, padding=1), the functions the JAX package
computes through ops/safe_conv, a workaround for a TPU autodiff fault.

Training (`MaskedDiffWithXvec.forward`) takes its random draws as one
flow.FlowDraws value (`make_legacy_draws` makes it from a
torch.Generator): use_cond for JAX's k_keep draw (uniform < cond_prob),
frac for its k_idx draw, and the CFM's draws.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from minimax_speech_torch.models import cfm
from minimax_speech_torch.models import conformer as cf
from minimax_speech_torch.models.decoder_unet import (Attention,
                                                      TimestepEmbedding,
                                                      UNetTransformerBlock,
                                                      mish,
                                                      sinusoidal_pos_emb)
from minimax_speech_torch.models.flow import FlowDraws
from minimax_speech_torch.ops import interpolate as interp
from minimax_speech_torch.ops import masks as mask_ops
from minimax_speech_torch.utils.device import check_on, resolve_device


@dataclass(frozen=True)
class LegacyUNetConfig:
    """Non-causal ConditionalDecoder geometry; in_channels packs x, mu,
    spks and cond (4 x 80)."""
    in_channels: int = 320
    out_channels: int = 80
    channels: Tuple[int, ...] = (256, 256)
    attention_head_dim: int = 64
    n_blocks: int = 4
    num_mid_blocks: int = 12
    num_heads: int = 8


@dataclass(frozen=True)
class LegacyEncoderConfig:
    """The plain (non-upsampling) conformer text encoder."""
    input_size: int = 512
    output_size: int = 512
    attention_heads: int = 8
    linear_units: int = 2048
    num_blocks: int = 6
    key_bias: bool = True


@dataclass(frozen=True)
class LegacyFlowConfig:
    input_size: int = 512
    output_size: int = 80
    spk_embed_dim: int = 192
    vocab_size: int = 4096
    input_frame_rate: int = 50
    mel_rate: float = 22050.0 / 256.0
    n_timesteps: int = 10
    # half the samples get a random prefix (< 30%) of the target mel as
    # prompt conditioning
    cond_prob: float = 0.5
    cond_max_frac: float = 0.3
    regulator_ratios: Tuple[int, ...] = (1,)   # conv stages in regulator
    encoder: LegacyEncoderConfig = field(default_factory=LegacyEncoderConfig)
    unet: LegacyUNetConfig = field(default_factory=LegacyUNetConfig)
    cfm: cfm.CFMConfig = field(default_factory=lambda: cfm.CFMConfig(
        use_contrastive_fm=False, use_immiscible=True, immiscible_k=8,
        training_cfg_rate=0.2, inference_cfg_rate=0.7))


def _channels_first(module, x):
    """A (B, C, T) module over channel-last (B, T, C) frames."""
    return module(x.transpose(1, 2)).transpose(1, 2)


class Block1D(nn.Module):
    """conv (k 3, same) -> GroupNorm(8) -> Mish, masked in and out."""

    def __init__(self, dim_in: int, dim_out: int, groups: int = 8):
        super().__init__()
        self.conv = nn.Conv1d(dim_in, dim_out, 3, padding=1)
        self.norm = nn.GroupNorm(groups, dim_out, eps=1e-5)

    def forward(self, x, mask):
        h = self.norm(self.conv((x * mask[..., None]).transpose(1, 2)))
        return mish(h).transpose(1, 2) * mask[..., None]


class ResnetBlock1D(nn.Module):
    """block1 + timestep shift + block2 + a 1x1 residual."""

    def __init__(self, dim_in: int, dim_out: int, time_dim: int):
        super().__init__()
        self.block1 = Block1D(dim_in, dim_out)
        self.mlp = nn.Linear(time_dim, dim_out)
        self.block2 = Block1D(dim_out, dim_out)
        self.res_conv = nn.Linear(dim_in, dim_out)

    def forward(self, x, mask, t_emb):
        h = self.block1(x, mask) + self.mlp(mish(t_emb))[:, None, :]
        h = self.block2(h, mask)
        return h + self.res_conv(x * mask[..., None])


class ConditionalDecoder(nn.Module):
    """The non-causal UNet velocity estimator: T halves at each down stage
    but the last, and doubles back on the way up; full attention over
    each stage's valid frames."""

    def __init__(self, cfg: LegacyUNetConfig = LegacyUNetConfig()):
        super().__init__()
        self.cfg = cfg
        time_dim = cfg.channels[0] * 4
        self.time_mlp = TimestepEmbedding(cfg.in_channels, time_dim)
        n_down = len(cfg.channels)

        def stage(name: str, dim_in: int, dim: int):
            self.add_module(f"{name}_resnet",
                            ResnetBlock1D(dim_in, dim, time_dim))
            for j in range(cfg.n_blocks):
                self.add_module(f"{name}_tf_{j}", UNetTransformerBlock(
                    dim, cfg.num_heads, cfg.attention_head_dim))

        dim = cfg.in_channels
        for i, ch in enumerate(cfg.channels):
            stage(f"down_{i}", dim, ch)
            self.add_module(f"down_{i}_conv", nn.Conv1d(
                ch, ch, 3, stride=2 if i != n_down - 1 else 1, padding=1))
            dim = ch
        for i in range(cfg.num_mid_blocks):
            stage(f"mid_{i}", dim, cfg.channels[-1])
        up = tuple(reversed(cfg.channels)) + (cfg.channels[0],)
        skips = list(cfg.channels)
        for i in range(len(up) - 1):
            ch = up[i + 1]
            stage(f"up_{i}", dim + skips.pop(), ch)
            self.add_module(f"up_{i}_conv", nn.ConvTranspose1d(
                ch, ch, 4, 2, padding=1) if i != len(up) - 2
                else nn.Conv1d(ch, ch, 3, padding=1))
            dim = ch
        self.final_block = Block1D(dim, dim)
        self.final_proj = nn.Linear(dim, cfg.out_channels)

    def _stage(self, name: str, h, m, t_emb):
        h = getattr(self, f"{name}_resnet")(h, m, t_emb)
        attn = Attention(kv_len=(m > 0).sum(dim=1, dtype=torch.int32))
        for j in range(self.cfg.n_blocks):
            h = getattr(self, f"{name}_tf_{j}")(h, attn)
        return h

    def forward(self, x, mask, mu, t, spks=None, cond=None):
        """x, mu, cond: (B, T, 80); mask: (B, T) float prefix mask; t: (B,);
        spks: (B, 80). Returns the velocity (B, T, 80)."""
        cfg = self.cfg
        b, tlen, _ = x.shape
        t_emb = self.time_mlp(sinusoidal_pos_emb(t, cfg.in_channels)
                              .to(x.dtype))
        feats = [x, mu]
        if spks is not None:
            feats.append(spks[:, None, :].expand(b, tlen, spks.shape[-1]))
        if cond is not None:
            feats.append(cond)
        h = torch.cat(feats, dim=-1)

        skips, masks = [], [mask]
        n_down = len(cfg.channels)
        for i in range(n_down):
            m = masks[-1]
            h = self._stage(f"down_{i}", h, m, t_emb)
            skips.append(h)
            h = _channels_first(getattr(self, f"down_{i}_conv"),
                                h * m[..., None])
            masks.append(m[:, ::2] if i != n_down - 1 else m)
        masks = masks[:-1]
        m = masks[-1]
        for i in range(cfg.num_mid_blocks):
            h = self._stage(f"mid_{i}", h, m, t_emb)
        for i in range(n_down):
            m = masks.pop()
            skip = skips.pop()
            h = torch.cat([h[:, :skip.shape[1]], skip], dim=-1)
            h = self._stage(f"up_{i}", h, m, t_emb)
            h = _channels_first(getattr(self, f"up_{i}_conv"),
                                h * m[..., None])
        h = self.final_block(h, m)
        return self.final_proj(h * m[..., None]) * mask[..., None]


class InterpolateRegulator(nn.Module):
    """A linear resample to the mel grid, then n_stages of conv ->
    GroupNorm(1) -> Mish and a 1x1 projection."""

    def __init__(self, channels: int, n_stages: int = 1,
                 out_channels: Optional[int] = None):
        super().__init__()
        self.n_stages = n_stages
        for i in range(n_stages):
            self.add_module(f"conv_{i}",
                            nn.Conv1d(channels, channels, 3, padding=1))
            self.add_module(f"norm_{i}", nn.GroupNorm(1, channels, eps=1e-5))
        self.out_proj = nn.Linear(channels, out_channels or channels)

    def forward(self, x, out_len: int, out_mask):
        """x: (B, T, C) -> (B, out_len, C'), masked by out_mask (B,
        out_len)."""
        h = interp.interpolate_linear(x.transpose(1, 2), out_len)
        for i in range(self.n_stages):
            h = getattr(self, f"conv_{i}")(h)
            h = mish(getattr(self, f"norm_{i}")(h))
        return self.out_proj(h.transpose(1, 2)) * out_mask[..., None]


class PlainConformerEncoder(nn.Module):
    """The CosyVoice1 flow's text encoder: a linear input embedding, full
    (pad-masked) rel-pos attention layers and a final LayerNorm."""

    def __init__(self, cfg: LegacyEncoderConfig = LegacyEncoderConfig()):
        super().__init__()
        self.cfg = cfg
        self.embed_linear = nn.Linear(cfg.input_size, cfg.output_size)
        self.embed_norm = nn.LayerNorm(cfg.output_size, eps=1e-5)
        for i in range(cfg.num_blocks):
            self.add_module(f"layers_{i}", cf.ConformerEncoderLayer(
                cfg.attention_heads, cfg.linear_units,
                key_bias=cfg.key_bias, d_model=cfg.output_size))
        self.after_norm = nn.LayerNorm(cfg.output_size, eps=1e-5)

    def forward(self, xs, xs_lens):
        cfg = self.cfg
        t = xs.shape[1]
        pad = mask_ops.make_non_pad_mask(xs_lens, t)
        padf = pad.to(xs.dtype)
        xs = self.embed_norm(self.embed_linear(xs)) * np.sqrt(cfg.output_size)
        xs = xs * padf[..., None]
        attn_mask = mask_ops.add_optional_chunk_mask(pad, 0)
        pos_emb = cf.espnet_rel_pos_emb(t, cfg.output_size, xs.dtype,
                                        xs.device)
        for i in range(cfg.num_blocks):
            xs = getattr(self, f"layers_{i}")(xs, attn_mask, pos_emb, padf)
        return self.after_norm(xs), pad


def make_legacy_draws(cfg: LegacyFlowConfig, b: int, t_feat: int,
                      generator: torch.Generator) -> FlowDraws:
    """The draws of one training loss for b targets of t_feat frames, on
    the generator's device."""
    dev = generator.device
    return FlowDraws(
        use_cond=torch.rand(b, generator=generator, device=dev)
        < cfg.cond_prob,
        frac=torch.rand(b, generator=generator, device=dev),
        cfm=cfm.make_draws(cfg.cfm, b, t_feat, cfg.output_size, generator))


class MaskedDiffWithXvec(nn.Module):
    """The legacy mel-target flow. forward is the training loss,
    prepare_inference everything before the ODE solve. The x-vector is
    L2-normalised, then projected to 80."""

    def __init__(self, cfg: LegacyFlowConfig = LegacyFlowConfig()):
        super().__init__()
        self.cfg = c = cfg
        self.input_embedding = nn.Embedding(c.vocab_size, c.input_size)
        self.spk_embed_affine_layer = nn.Linear(c.spk_embed_dim,
                                                c.output_size)
        self.encoder = PlainConformerEncoder(c.encoder)
        self.encoder_proj = nn.Linear(c.encoder.output_size, c.output_size)
        self.length_regulator = InterpolateRegulator(
            c.output_size, len(c.regulator_ratios), c.output_size)
        self.estimator = ConditionalDecoder(c.unet)

    def estimate(self, x, mask, mu, t, spks, cond, streaming: bool = False):
        """The velocity; the legacy decoder has no streaming mode, so
        `streaming` (cfm.compute_loss passes it) is ignored."""
        return self.estimator(x, mask, mu, t, spks, cond)

    def _embed_tokens(self, token, token_len):
        m = mask_ops.make_non_pad_mask(token_len, token.shape[1])
        emb = self.input_embedding(torch.clamp(token, min=0))
        return emb * m[..., None].to(emb.dtype)

    def _spk(self, embedding):
        emb = embedding / (torch.linalg.norm(embedding, dim=-1, keepdim=True)
                           + 1e-8)
        return self.spk_embed_affine_layer(emb)

    def _encode(self, token, token_len):
        h, _ = self.encoder(self._embed_tokens(token, token_len), token_len)
        return self.encoder_proj(h)

    def forward(self, token, token_len, feat, feat_len, embedding,
                draws: FlowDraws) -> torch.Tensor:
        """The training loss. token: (B, Tt); feat: (B, Tf, 80) target
        mels; embedding: (B, spk_embed_dim) raw x-vectors."""
        c = self.cfg
        tf = feat.shape[1]
        spks = self._spk(embedding)
        fmask = mask_ops.make_non_pad_mask(feat_len, tf).to(feat.dtype)
        h = self.length_regulator(self._encode(token, token_len), tf, fmask)
        # a random prefix (< cond_max_frac) of the target for the samples
        # that keep one
        idx = (draws.frac * c.cond_max_frac * feat_len.float()).to(
            torch.int32)
        pos = torch.arange(tf, device=feat.device)[None]
        keep = (pos < idx[:, None]) & draws.use_cond[:, None]
        conds = feat * keep[..., None].to(feat.dtype)
        return cfm.compute_loss(self.estimate, feat, fmask, h, spks, conds,
                                c.cfm, draws.cfm)

    def prepare_inference(self, token, token_len, prompt_token,
                          prompt_token_len, prompt_feat, embedding):
        """(mu, mask, spks, conds) over the prompt's mel frames and
        int(Tt / input_frame_rate * mel_rate) new ones; the lengths come
        from the shapes."""
        c = self.cfg
        spks = self._spk(embedding)
        h = self._encode(torch.cat([prompt_token, token], dim=1),
                         prompt_token_len + token_len)
        b = h.shape[0]
        mel_len1 = prompt_feat.shape[1]
        mel_len2 = int(token.shape[1] / c.input_frame_rate * c.mel_rate)
        total = mel_len1 + mel_len2
        fmask = torch.ones((b, total), dtype=h.dtype, device=h.device)
        h = self.length_regulator(h, total, fmask)
        conds = F.pad(prompt_feat.to(h.dtype), (0, 0, 0, mel_len2))
        return h, fmask, spks, conds


@torch.no_grad()
def legacy_flow_inference(model: MaskedDiffWithXvec, token, token_len,
                          prompt_token, prompt_token_len, prompt_feat,
                          embedding, noise, n_timesteps: Optional[int] = None,
                          device=None) -> torch.Tensor:
    """Prompt-conditioned mel generation: (B, mel_len2, 80), the frames
    after the prompt. noise: (1 or B, >= total frames, 80), the start of
    the solve. Runs on `device` (default cuda; the model must live
    there)."""
    c = model.cfg
    dev = resolve_device(device)
    check_on(model, dev, "the legacy flow")
    token, token_len, prompt_token, prompt_token_len = (
        torch.as_tensor(a, device=dev).long()
        for a in (token, token_len, prompt_token, prompt_token_len))
    prompt_feat, embedding, noise = (
        torch.as_tensor(a, device=dev).float()
        for a in (prompt_feat, embedding, noise))
    mu, mask, spks, conds = model.prepare_inference(
        token, token_len, prompt_token, prompt_token_len, prompt_feat,
        embedding)
    b, total, _ = mu.shape
    z = noise[:, :total].expand(b, total, c.output_size).to(mu.dtype)
    mel = cfm.solve_euler(model.estimate, z, mu, mask, spks, conds,
                          n_timesteps or c.n_timesteps, c.cfm)
    return mel[:, prompt_feat.shape[1]:]
