"""Stage-2 flow model: FSQ tokens -> DAC-VAE latents.

Port of minimax_speech_tpu/models/flow.py: token embedding ->
UpsampleConformerEncoder (2x to the latent rate) -> Dense to 80 -> CFM
with the causal UNet estimator; speaker conditioning is the projected
192-d embedding.

Training (`FlowModel.forward`): the (contrastive, immiscible) OT-CFM
loss on the standardized target latents, with half the samples
conditioned on a random prefix (up to 30%) of their target. Its random
draws come in as one `FlowDraws` value (`make_flow_draws` makes it from
a torch.Generator on the model's device), in the order JAX splits its
key, so a test can feed both packages the same numbers.

Inference: 10-step CFG Euler, the prompt latents conditioning the solve
through `cond`. Three entry points: `flow_inference_batched` (the fused
path), `flow_inference` (one utterance, full or streaming with the
lookahead tokens held back as context) and `flow_inference_unit_grid`
(the full-sequence twin of the chunked streaming path,
infer/stream_flow.py); the chunked path itself drives
`stream_encode_prefill` / `stream_encode_chunk` and the UNet's collect
and chunk modes.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch import nn

from minimax_speech_torch.models import cfm
from minimax_speech_torch.models.decoder_unet import (CausalConditionalDecoder,
                                                      DecoderUNetConfig)
from minimax_speech_torch.models.speaker_encoder import (
    LearnableSpeakerEncoder, SpeakerEncoderConfig, l2_normalize)
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


@dataclass
class FlowDraws:
    """The random numbers of one training loss, as JAX's FlowModel splits
    its key into (k_on, k_idx, k_cfm): use_cond (B,) bool, whether a
    sample sees a prefix of its target; frac (B,) uniform in [0, 1), the
    prefix as a share of 30% of feat_len; cfm, compute_loss's draws."""
    use_cond: torch.Tensor
    frac: torch.Tensor
    cfm: cfm.CFMDraws

    def rows(self, start: int, n: int) -> "FlowDraws":
        """The draws of rows [start, start + n) of the global batch (a
        data-parallel rank's share; the derangement stays global)."""
        return FlowDraws(self.use_cond[start:start + n],
                         self.frac[start:start + n],
                         self.cfm.rows(start, n))


def make_flow_draws(cfg: FlowConfig, b: int, t_feat: int,
                    generator: torch.Generator) -> FlowDraws:
    """FlowDraws for a batch of b targets of t_feat frames, on the
    generator's device."""
    dev = generator.device
    return FlowDraws(
        use_cond=torch.rand(b, generator=generator, device=dev) < 0.5,
        frac=torch.rand(b, generator=generator, device=dev),
        cfm=cfm.make_draws(cfg.cfm, b, t_feat, cfg.output_size, generator))


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
        """(B, T, 80) reference mel -> (B, 192) unit-norm embedding; a
        multi-crop (B, N, T, 80) batch embeds each crop, then averages
        and re-normalizes."""
        if reference_mel.dim() == 4:
            b, n, t, d = reference_mel.shape
            mask = None if reference_mask is None \
                else reference_mask.reshape(b * n, t)
            e = self.speaker_encoder(reference_mel.reshape(b * n, t, d), mask)
            return l2_normalize(e.reshape(b, n, -1).mean(dim=1))
        return self.speaker_encoder(reference_mel, reference_mask)

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

    # -- chunked streaming (O(chunk) per hop; infer/stream_flow.py) --------
    def stream_encode_prefill(self, token_buf, plen: int, cache: dict):
        """The prompt unit. token_buf: (B, P) with the prompt at [0, plen)
        and the next chunk's first pre_lookahead_len tokens after it.
        Returns (mu (B, 2P, 80), valid through 2*plen, and the encoder
        state)."""
        out, cache = self.encoder.prefill(self.embed_tokens(token_buf), plen,
                                          cache)
        return self.encoder_proj(out), cache

    def stream_encode_chunk(self, tokens, cache: dict, offset: int,
                            q_valid: int, ctx=None):
        """One hop: tokens (B, cq) from absolute token `offset`; ctx (B, L)
        the next chunk's first L tokens, None for the final chunk.
        Returns (mu (B, 2cq, 80), the encoder state)."""
        ctx_h = None if ctx is None else self.embed_tokens(ctx)
        out, cache = self.encoder.chunk_step(self.embed_tokens(tokens), cache,
                                             offset, q_valid, context=ctx_h)
        return self.encoder_proj(out), cache

    def project_speaker(self, embedding):
        """(B, 192) -> (B, 80) speaker conditioning for the estimator."""
        return self.spk_embed_affine_layer(embedding)

    def forward(self, token, token_len, feat, feat_len, embedding,
                draws: FlowDraws, streaming: bool = False,
                group=None) -> torch.Tensor:
        """The training loss. token: (B, Tt) FSQ tokens; feat: (B, 2*Tt,
        80) raw target latents; embedding: (B, 192) normalized speaker
        embedding. streaming: chunk masks in the encoder and the UNet.
        group: the data-parallel group the global batch is split over
        (draws.rows gave this rank's draws); the loss is then this rank's
        share of the global batch's (cfm.compute_loss)."""
        c = self.cfg
        spks = self.spk_embed_affine_layer(embedding)
        feat = latent_normalize(c, feat)
        mu, h_len = self.encode_tokens(token, token_len, streaming=streaming)
        tf = feat.shape[1]
        mask = mask_ops.make_non_pad_mask(h_len, tf).to(feat.dtype)
        # a random prefix (up to 30%) of the target as conditioning, for
        # half the samples
        idx = (draws.frac * 0.3 * feat_len.float()).to(torch.int32)
        pos = torch.arange(tf, device=feat.device)[None]
        cond_mask = (pos < idx[:, None]) & draws.use_cond[:, None]
        conds = feat * cond_mask[..., None].to(feat.dtype)
        return cfm.compute_loss(self.estimate, feat, mask, mu, spks, conds,
                                c.cfm, draws.cfm, streaming=streaming,
                                group=group)

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
    dev = resolve_device(device)
    check_on(model, dev, "the flow model")
    return (torch.as_tensor(token, device=dev).long(),
            torch.as_tensor(token_len, device=dev).long(),
            torch.as_tensor(prompt_feat, device=dev),
            torch.as_tensor(embedding, device=dev),
            torch.as_tensor(noise, device=dev))


@torch.no_grad()
def flow_inference(model: FlowModel, token, token_len, prompt_feat,
                   embedding, noise, streaming: bool = False,
                   finalize: bool = True, device=None) -> torch.Tensor:
    """Latents for one batch of utterances given a latent prompt (B, Tp,
    80): (B, 2*Tt - Tp, 80), the frames after the prompt (with finalize
    False, 2*(Tt - pre_lookahead_len) - Tp). streaming: chunk masks in
    the encoder and the UNet (K1's chunk mode)."""
    c = model.cfg
    token, token_len, prompt_feat, embedding, noise = _on_device(
        model, device, token, token_len, prompt_feat, embedding, noise)
    mu, mask, spks, conds = model.prepare_inference(
        token, token_len, prompt_feat, embedding, streaming, finalize)
    feat = cfm.solve_euler(model.estimate, _start_noise(model, noise, mu),
                           mu, mask, spks, conds, c.n_timesteps, c.cfm,
                           streaming=streaming)
    return latent_denormalize(c, feat[:, prompt_feat.shape[1]:])


@torch.no_grad()
def flow_inference_unit_grid(model: FlowModel, token, token_len,
                             prompt_feat, prompt_len: int, embedding, noise,
                             window: int = 100, device=None) -> torch.Tensor:
    """The full-sequence pass on the prompt-anchored unit grid with a
    `window`-frame UNet attention window: what the chunked streaming path
    computes hop by hop, in one pass, to verify it. prompt_len: the prompt
    in tokens (prompt_feat its 2x frames, maybe padded). Returns every
    frame (B, 2*Tt, 80)."""
    c = model.cfg
    token, token_len, prompt_feat, embedding, noise = _on_device(
        model, device, token, token_len, prompt_feat, embedding, noise)
    mu, mask, spks, conds = model.prepare_inference(
        token, token_len, prompt_feat, embedding, streaming=True,
        chunk_align=prompt_len)
    feat = cfm.solve_euler(model.estimate, _start_noise(model, noise, mu),
                           mu, mask, spks, conds, c.n_timesteps, c.cfm,
                           streaming=True, window=window,
                           unit_align=prompt_len * c.token_latent_ratio)
    return latent_denormalize(c, feat)
