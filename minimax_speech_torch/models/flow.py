"""Stage-2 flow model, inference: FSQ tokens -> DAC-VAE latents.

Port of the inference half of minimax_speech_tpu/models/flow.py: token
embedding -> UpsampleConformerEncoder (2x to the latent rate) -> Dense
to 80 -> 10-step CFG Euler with the causal UNet estimator. The prompt
latents condition the solve through `cond`; speaker conditioning is the
projected 192-d embedding.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch import nn

from minimax_speech_torch.models import cfm
from minimax_speech_torch.models.decoder_unet import (CausalConditionalDecoder,
                                                      DecoderUNetConfig)
from minimax_speech_torch.models.speaker_encoder import (
    LearnableSpeakerEncoder, SpeakerEncoderConfig)
from minimax_speech_torch.models.upsample_encoder import (
    UpsampleConformerEncoder, UpsampleEncoderConfig)
from minimax_speech_torch.ops import masks as mask_ops
from minimax_speech_torch.utils.device import check_on, resolve_device


@dataclass(frozen=True)
class FlowConfig:
    input_size: int = 512
    output_size: int = 80
    spk_embed_dim: int = 192
    vocab_size: int = 6561
    input_frame_rate: int = 25
    token_latent_ratio: int = 2
    pre_lookahead_len: int = 3
    use_speaker_encoder: bool = True
    freeze_speaker_encoder: bool = True
    n_timesteps: int = 10
    # per-channel latent standardization (empty = identity); the flow
    # solves in the standardized space, every surface stays in raw latents
    latent_mean: tuple = ()
    latent_std: tuple = ()
    encoder: UpsampleEncoderConfig = field(
        default_factory=UpsampleEncoderConfig)
    unet: DecoderUNetConfig = field(default_factory=DecoderUNetConfig)
    cfm: cfm.CFMConfig = field(default_factory=cfm.CFMConfig)
    speaker: SpeakerEncoderConfig = field(default_factory=SpeakerEncoderConfig)


def _stats(cfg: FlowConfig, x: torch.Tensor):
    mean = torch.tensor(cfg.latent_mean or (0.0,) * cfg.output_size,
                        dtype=x.dtype, device=x.device)
    std = torch.tensor(cfg.latent_std or (1.0,) * cfg.output_size,
                       dtype=x.dtype, device=x.device)
    return mean, std


def latent_normalize(cfg: FlowConfig, x: torch.Tensor) -> torch.Tensor:
    """Raw latent space -> the standardized space the CFM solves in."""
    if not cfg.latent_mean and not cfg.latent_std:
        return x
    mean, std = _stats(cfg, x)
    return (x - mean) / std


def latent_denormalize(cfg: FlowConfig, x: torch.Tensor) -> torch.Tensor:
    if not cfg.latent_mean and not cfg.latent_std:
        return x
    mean, std = _stats(cfg, x)
    return x * std + mean


class FlowModel(nn.Module):
    def __init__(self, cfg: FlowConfig = FlowConfig()):
        super().__init__()
        self.cfg = cfg
        c = cfg
        self.input_embedding = nn.Embedding(c.vocab_size, c.input_size)
        self.spk_embed_affine_layer = nn.Linear(c.spk_embed_dim,
                                                c.output_size)
        self.encoder = UpsampleConformerEncoder(c.encoder)
        self.encoder_proj = nn.Linear(c.encoder.output_size, c.output_size)
        self.estimator = CausalConditionalDecoder(c.unet)
        if c.use_speaker_encoder:
            self.speaker_encoder = LearnableSpeakerEncoder(c.speaker)

    def embed_speaker(self, reference_mel, reference_mask=None):
        """(B, T, 80) reference mel -> (B, 192) unit-norm embedding."""
        return self.speaker_encoder(reference_mel, reference_mask)

    def encode_tokens(self, token, token_len):
        """tokens (B, T) -> ((B, 2T, 80) projected encoder output, lens)."""
        t = token.shape[1]
        m = mask_ops.make_non_pad_mask(token_len, t).float()
        h = self.input_embedding(torch.clamp(token, min=0)) * m[..., None]
        h, h_len = self.encoder(h, token_len)
        return self.encoder_proj(h), h_len

    def estimate(self, x, mask, mu, t, spks, cond):
        return self.estimator(x, mask, mu, t, spks, cond)

    def prepare_inference(self, token, token_len, prompt_feat, embedding,
                          prompt_feat_len=None):
        """Everything before the ODE solve: encoder output `mu`, projected
        speaker embedding, prompt conditioning `conds`, frame mask.
        token: (B, Tt) prompt+target tokens; prompt_feat: (B, Tp, 80);
        prompt_feat_len: (B,) true prompt lengths, or None for all Tp."""
        c = self.cfg
        spks = self.spk_embed_affine_layer(embedding)
        prompt_feat = latent_normalize(c, prompt_feat)
        mu, h_len = self.encode_tokens(token, token_len)
        b, tf, _ = mu.shape
        mel_len1 = prompt_feat.shape[1]
        mask = mask_ops.make_non_pad_mask(h_len, tf).to(mu.dtype)
        if prompt_feat_len is not None:
            pm = mask_ops.make_non_pad_mask(prompt_feat_len, mel_len1)
            prompt_feat = prompt_feat * pm[..., None].to(mu.dtype)
        conds = torch.zeros((b, tf, c.output_size), dtype=mu.dtype,
                            device=mu.device)
        conds[:, :mel_len1] = prompt_feat
        return mu, mask, spks, conds


@torch.no_grad()
def flow_inference_batched(model: FlowModel, token, token_len, prompt_feat,
                           prompt_feat_len, embedding, noise,
                           device=None) -> torch.Tensor:
    """Latents for the whole frame sequence (B, 2*Tt, 80) given ragged
    prompts; callers cut each row's generated region
    [prompt_feat_len[i], token_len[i] * ratio). noise: (1 or B, >= 2*Tt,
    80), the fixed table."""
    dev = resolve_device(device)
    check_on(model, dev, "the flow model")
    c = model.cfg
    token = torch.as_tensor(token, device=dev).long()
    token_len = torch.as_tensor(token_len, device=dev).long()
    prompt_feat = torch.as_tensor(prompt_feat, device=dev)
    prompt_feat_len = torch.as_tensor(prompt_feat_len, device=dev).long()
    embedding = torch.as_tensor(embedding, device=dev)
    noise = torch.as_tensor(noise, device=dev)
    mu, mask, spks, conds = model.prepare_inference(
        token, token_len, prompt_feat, embedding, prompt_feat_len)
    tf = mu.shape[1]
    z = noise[:, :tf].expand(mu.shape[0], tf, c.output_size).to(mu.dtype)
    feat = cfm.solve_euler(model.estimate, z, mu, mask, spks, conds,
                           c.n_timesteps, c.cfm)
    return latent_denormalize(c, feat)
