"""Stage-2 flow model for inference: a frozen copy of the port's
FlowModel (token embedding -> UpsampleConformerEncoder -> Dense to 80 ->
10-step CFG Euler with the causal UNet) and its batched entry
`flow_inference_batched`, in float32 with plain attention."""
from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch import nn

from speechbench.reference import cfm
from speechbench.reference.decoder_unet import (CausalConditionalDecoder,
                                                      DecoderUNetConfig)
from speechbench.reference.speaker_encoder import (
    LearnableSpeakerEncoder, SpeakerEncoderConfig)
from speechbench.reference.upsample_encoder import (
    UpsampleConformerEncoder, UpsampleEncoderConfig)
from speechbench.reference import masks as mask_ops


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

    def embed_tokens(self, token):
        return self.input_embedding(torch.clamp(token, min=0))

    def encode_tokens(self, token, token_len, context=None,
                      streaming: bool = False, chunk_align=None):
        """tokens (B, T) -> ((B, 2T, 80) projected encoder output, lens)."""
        h = self.embed_tokens(token)
        m = mask_ops.make_non_pad_mask(token_len, token.shape[1])
        h = h * m[..., None].to(h.dtype)
        h, h_len = self.encoder(h, token_len, context=context,
                                streaming=streaming, chunk_align=chunk_align)
        return self.encoder_proj(h), h_len

    def estimate(self, x, mask, mu, t, spks, cond, streaming: bool = False,
                 **kw):
        return self.estimator(x, mask, mu, t, spks, cond,
                              streaming=streaming, **kw)

    def project_speaker(self, embedding):
        """(B, 192) -> (B, 80) speaker conditioning for the estimator."""
        return self.spk_embed_affine_layer(embedding)

    def prepare_inference(self, token, token_len, prompt_feat, embedding,
                          streaming: bool = False, finalize: bool = True,
                          prompt_feat_len=None, chunk_align=None):
        """Everything before the ODE solve: encoder output `mu`, projected
        speaker embedding, prompt conditioning `conds`, frame mask.
        token: (B, Tt) prompt+target tokens; prompt_feat: (B, Tp, 80);
        prompt_feat_len: (B,) true prompt lengths, or None for all Tp.
        streaming: the encoder's chunk masks (chunk_align: on the unit
        grid); finalize False: the last pre_lookahead_len tokens are not
        encoded but feed the pre-lookahead conv as context."""
        c = self.cfg
        spks = self.spk_embed_affine_layer(embedding)
        prompt_feat = latent_normalize(c, prompt_feat)
        if finalize:
            mu, h_len = self.encode_tokens(token, token_len,
                                           streaming=streaming,
                                           chunk_align=chunk_align)
        else:
            look = c.pre_lookahead_len
            body = token[:, :-look]
            m = mask_ops.make_non_pad_mask(token_len - look,
                                           body.shape[1]).float()
            h = self.embed_tokens(body) * m[..., None]
            h, h_len = self.encoder(h, token_len - look,
                                    context=self.embed_tokens(token[:, -look:]),
                                    streaming=streaming)
            mu = self.encoder_proj(h)
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
                           streaming: bool = False,
                           device=None) -> torch.Tensor:
    """Latents for the whole frame sequence (B, 2*Tt, 80) given ragged
    prompts; callers cut each row's generated region
    [prompt_feat_len[i], token_len[i] * ratio). noise: (1 or B, >= 2*Tt,
    80), the fixed table. streaming: chunk masks in the encoder and the
    UNet (K1's chunk mode), as the batched streaming servers run it."""
    c = model.cfg
    token, token_len, prompt_feat, embedding, noise = _on_device(
        model, device, token, token_len, prompt_feat, embedding, noise)
    prompt_feat_len = torch.as_tensor(prompt_feat_len,
                                      device=token.device).long()
    mu, mask, spks, conds = model.prepare_inference(
        token, token_len, prompt_feat, embedding, streaming=streaming,
        prompt_feat_len=prompt_feat_len)
    feat = cfm.solve_euler(model.estimate, _start_noise(model, noise, mu),
                           mu, mask, spks, conds, c.n_timesteps, c.cfm,
                           streaming=streaming)
    return latent_denormalize(c, feat)


def _start_noise(model: FlowModel, noise, mu):
    """The first T frames of the fixed noise table, one per row."""
    tf = mu.shape[1]
    return noise[:, :tf].expand(mu.shape[0], tf, model.cfg.output_size) \
        .to(mu.dtype)


def _on_device(model: FlowModel, device, token, token_len, prompt_feat,
               embedding, noise):
    """The inputs on `device`, the float ones in the flow's dtype."""
    dt = model.spk_embed_affine_layer.weight.dtype
    return (torch.as_tensor(token, device=device).long(),
            torch.as_tensor(token_len, device=device).long(),
            torch.as_tensor(prompt_feat, device=device).to(dt),
            torch.as_tensor(embedding, device=device).to(dt),
            torch.as_tensor(noise, device=device).to(dt))
