"""Stage-1 TTS LM: text tokens (+ speaker conditioning) -> FSQ speech tokens.

Port of the inference half of minimax_speech_tpu/models/llm.py: the
plan embedding (a host-built integer plan of source type + token id per
position, materialized with three gathers and a select), speaker
conditioning, prefill into a preallocated KV cache, and the RAS decode
loop of `generate` with pregenerated noise.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from minimax_speech_torch.models import qwen2
from minimax_speech_torch.models.speaker_encoder import (
    LearnableSpeakerEncoder, SpeakerEncoderConfig)
from minimax_speech_torch.ops import masks as mask_ops
from minimax_speech_torch.ops import sampling as sampling_ops
from minimax_speech_torch.utils.device import check_on, resolve_device

# plan source types
SRC_PAD, SRC_SPECIAL, SRC_TEXT, SRC_SPEECH, SRC_SPK = 0, 1, 2, 3, 4
SOS_EOS_ID, TASK_ID = 0, 1
# the JAX package folds this into its key for the nucleus noise table
GUMBEL_FOLD = 0x67756d62


@dataclass(frozen=True)
class LMConfig:
    llm_input_size: int = 896
    llm_output_size: int = 896
    speech_token_size: int = 6561
    lsm_weight: float = 0.0
    length_normalized_loss: bool = True
    mix_ratio: Tuple[int, int] = (5, 15)
    spk_embed_dim: int = 192
    use_speaker_encoder: bool = True
    qwen: qwen2.Qwen2Config = field(default_factory=qwen2.Qwen2Config)
    speaker: SpeakerEncoderConfig = field(default_factory=SpeakerEncoderConfig)
    top_p: float = 0.8
    top_k: int = 25
    ras_win: int = 10
    ras_tau: float = 0.1

    @property
    def eos_token(self) -> int:
        return self.speech_token_size

    @property
    def vocab(self) -> int:
        """Speech-side output size: codes + eos + pad/blank + fill."""
        return self.speech_token_size + 3


class SpeechLM(nn.Module):
    def __init__(self, cfg: LMConfig = LMConfig()):
        super().__init__()
        self.cfg = cfg
        c = cfg
        self.llm_embedding = nn.Embedding(2, c.llm_input_size)
        self.speech_embedding = nn.Embedding(c.vocab, c.llm_input_size)
        self.text_embedding = nn.Embedding(c.qwen.vocab_size, c.llm_input_size)
        self.llm = qwen2.Qwen2Model(c.qwen)
        self.llm_decoder = nn.Linear(c.llm_output_size, c.vocab)
        self.spk_embed_affine_layer = nn.Linear(c.spk_embed_dim,
                                                c.llm_input_size)
        if c.use_speaker_encoder:
            self.speaker_encoder = LearnableSpeakerEncoder(c.speaker)

    def embed_plan(self, src_type, tok_id, spk_emb):
        """src_type/tok_id: (B, L) ints; spk_emb: (B, C) projected speaker
        embedding. Returns (B, L, C). Each table is gathered at the
        clamped ids and used only where the source type selects it."""
        text_e = self.text_embedding(
            torch.clamp(tok_id, 0, self.cfg.qwen.vocab_size - 1))
        speech_e = self.speech_embedding(
            torch.clamp(tok_id, 0, self.cfg.speech_token_size + 2))
        special_e = self.llm_embedding(torch.clamp(tok_id, 0, 1))
        st = src_type[..., None]
        emb = torch.where(st == SRC_TEXT, text_e, torch.zeros_like(text_e))
        emb = torch.where(st == SRC_SPEECH, speech_e, emb)
        emb = torch.where(st == SRC_SPECIAL, special_e, emb)
        return torch.where(st == SRC_SPK, spk_emb[:, None, :].to(emb.dtype),
                           emb)

    def embed_speaker(self, reference_mel, reference_mask=None):
        """(B, T, 80) reference mel -> (B, C) projected embedding."""
        return self.spk_embed_affine_layer(
            self.speaker_encoder(reference_mel, reference_mask))

    def prefill(self, emb, pad, positions, cache):
        """Run the prompt through the LM, filling cache slots [0, P).
        Returns the hidden states (B, P, C)."""
        bias = qwen2.causal_bias(pad)
        k, p = cache[0].shape[2], emb.shape[1]
        if k > p:
            extra = torch.full((pad.shape[0], 1, p, k - p), -1e10,
                               device=emb.device)
            bias = torch.cat([bias, extra], dim=-1)
        return self.llm(emb, positions, bias, cache, 0)

    def decode_step(self, emb_1, pos, valid, cache, slot: int):
        """One step: emb_1 (B, 1, C) at true positions pos (B,), written
        to cache slot `slot`. `valid` (B, K) is updated in place.
        Returns logits (B, V)."""
        valid[:, slot] = True
        hidden = self.llm(emb_1, pos[:, None], qwen2.cache_bias(valid), cache,
                          slot)
        return self.llm_decoder(hidden[:, -1])

    def embed_speech_token(self, tok):
        return self.speech_embedding(tok)


def build_inference_plan(text_tokens: np.ndarray, prompt_speech: np.ndarray,
                         use_spk: bool = True,
                         pad_to: Optional[int] = None):
    """Prompt plan [sos][spk?][text][task][prompt_speech] as numpy
    (src_type (1, L), tok_id (1, L), prompt_len (1,))."""
    src = [SRC_SPECIAL] + ([SRC_SPK] if use_spk else []) \
        + [SRC_TEXT] * len(text_tokens) + [SRC_SPECIAL] \
        + [SRC_SPEECH] * len(prompt_speech)
    tok = [SOS_EOS_ID] + ([0] if use_spk else []) \
        + list(map(int, text_tokens)) + [TASK_ID] \
        + list(map(int, prompt_speech))
    n = len(src)
    L = pad_to or n
    src_type = np.zeros((1, L), np.int32)
    tok_id = np.zeros((1, L), np.int32)
    src_type[0, :n] = src
    tok_id[0, :n] = tok
    return src_type, tok_id, np.array([n], np.int32)


def decode_noise(cfg: LMConfig, max_steps: int, batch: int,
                 generator: torch.Generator | None = None, device=None):
    """Noise tables for `generate`: the nucleus table (max_steps, B,
    top_k) and the repetition-fallback table (max_steps, B, V)."""
    return (sampling_ops.gumbel((max_steps, batch, cfg.top_k), generator,
                                device),
            sampling_ops.gumbel((max_steps, batch, cfg.vocab), generator,
                                device))


@torch.no_grad()
def generate(model: SpeechLM, src_type, tok_id, prompt_len, spk_emb,
             min_len, max_len, max_steps: int = 512,
             gumbel_top: torch.Tensor | None = None,
             gumbel_fallback: torch.Tensor | None = None,
             generator: torch.Generator | None = None, device=None):
    """RAS decode. Returns (tokens (B, max_steps) int32 padded with -1,
    num_tokens (B,) int32).

    src_type/tok_id: (B, P) padded prompt plan; prompt_len: (B,) true
    lengths; min_len/max_len: (B,) decode bounds. EOS is masked while
    fewer than min_len tokens are out; ids above eos always. The noise
    is `gumbel_top` (max_steps, B, top_k) for the nucleus draw and
    `gumbel_fallback` (max_steps, B, V) for the full-distribution draw
    that repetition triggers; either missing is drawn from `generator`.
    Each step makes one host sync, for the stop test."""
    dev = resolve_device(device)
    check_on(model, dev, "the LM")
    cfg = model.cfg
    eos = cfg.eos_token

    def as_int(x):
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                               device=dev).to(torch.int64)

    src_type, tok_id = as_int(src_type), as_int(tok_id)
    prompt_len, min_len, max_len = (as_int(prompt_len), as_int(min_len),
                                    as_int(max_len))
    b, p = src_type.shape
    if gumbel_top is None or gumbel_fallback is None:
        g_top, g_fb = decode_noise(cfg, max_steps, b, generator, dev)
        gumbel_top = g_top if gumbel_top is None else gumbel_top
        gumbel_fallback = g_fb if gumbel_fallback is None else gumbel_fallback
    gumbel_top = torch.as_tensor(gumbel_top, device=dev).float()
    gumbel_fallback = torch.as_tensor(gumbel_fallback, device=dev).float()

    emb = model.embed_plan(src_type, tok_id, spk_emb.to(dev))
    cache = qwen2.make_cache(cfg.qwen, b, p + max_steps, emb.dtype, dev)
    pad = mask_ops.make_non_pad_mask(prompt_len, p)
    positions = torch.arange(p, device=dev)[None].expand(b, p)
    hidden = model.prefill(emb, pad, positions, cache)
    last_hidden = hidden[torch.arange(b, device=dev), prompt_len - 1]
    logits = model.llm_decoder(last_hidden)
    valid = torch.cat([pad, torch.zeros((b, max_steps), dtype=torch.bool,
                                        device=dev)], dim=1)

    ids = torch.arange(cfg.vocab, device=dev)[None]
    out = torch.full((b, max_steps), -1, dtype=torch.int32, device=dev)
    recent = torch.full((b, cfg.ras_win), -1, dtype=torch.int32, device=dev)
    count = torch.zeros((b,), dtype=torch.int64, device=dev)
    finished = torch.zeros((b,), dtype=torch.bool, device=dev)
    step = 0
    while step < max_steps and not bool(finished.all()):
        logp = torch.log_softmax(logits.float(), dim=-1)
        logp = logp.masked_fill(ids > eos, float("-inf"))
        logp = logp.masked_fill((ids == eos) & (count < min_len)[:, None],
                                float("-inf"))
        toks = sampling_ops.ras_sample_batch_pregen(
            gumbel_top[step], gumbel_fallback[step], logp, recent, cfg.top_p,
            cfg.top_k, cfg.ras_win, cfg.ras_tau)
        now_eos = (toks == eos) | (count >= max_len)
        finished = finished | now_eos
        emit = ~finished
        out[:, step] = torch.where(emit, toks, torch.full_like(toks, -1))
        recent = torch.where(emit[:, None],
                             torch.cat([recent[:, 1:], toks[:, None]], dim=1),
                             recent)
        pos = prompt_len + count  # true position of the token being fed
        count = count + emit.to(count.dtype)
        emb1 = model.embed_speech_token(
            torch.clamp(toks, 0, eos - 1).long())[:, None, :]
        logits = model.decode_step(emb1, pos, valid, cache, p + step)
        step += 1
    return out, count.to(torch.int32)
