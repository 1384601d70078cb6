"""Stage-1 TTS LM: text tokens (+ speaker conditioning) -> FSQ speech tokens.

Port of minimax_speech_tpu/models/llm.py: the plan embedding (a
host-built integer plan of source type + token id per position,
materialized with three gathers and a select), speaker conditioning
(multi-crop averaged, or an external x-vector), the training forward
(label-smoothed CE and accuracy over the plan's targets) with the host
plan builder `build_lm_plan`, the targets' summed log-probability for
DPO (`sequence_logp`), prefill into a preallocated KV cache, and
the RAS decode loop of `generate` with pregenerated noise; for serving,
decode steps with a cache slot per row (`decode_step_rows`) and block
appends mid-decode (`extend`), and the sampling step the serving
decoders share (`sample_step`, `NoiseFn`).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from minimax_speech_torch.models import qwen2
from minimax_speech_torch.models.speaker_encoder import (
    LearnableSpeakerEncoder, SpeakerEncoderConfig, l2_normalize)
from minimax_speech_torch.ops import masks as mask_ops
from minimax_speech_torch.ops import sampling as sampling_ops
from minimax_speech_torch.utils import losses, params_io
from minimax_speech_torch.utils.device import check_on, resolve_device

IGNORE_ID = losses.IGNORE_ID

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
    def fill_token(self) -> int:
        return self.speech_token_size + 2

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
        """(B, T, 80), or multi-crop (B, N, T, 80), reference mel ->
        (B, C) projected embedding; crops are averaged, then
        L2-normalized."""
        if reference_mel.dim() == 4:
            b, n, t, d = reference_mel.shape
            mask = None if reference_mask is None \
                else reference_mask.reshape(b * n, t)
            e = self.speaker_encoder(reference_mel.reshape(b * n, t, d),
                                     mask).reshape(b, n, -1).mean(dim=1)
            e = l2_normalize(e)
        else:
            e = self.speaker_encoder(reference_mel, reference_mask)
        return self.spk_embed_affine_layer(e)

    def project_xvector(self, embedding):
        """External (B, 192) x-vector -> (B, C)."""
        return self.spk_embed_affine_layer(l2_normalize(embedding))

    def forward(self, src_type, tok_id, target, seq_len, spk_emb,
                group=None):
        """Training forward from plan tensors: src_type/tok_id/target
        (B, L), seq_len (B,), spk_emb (B, C). Returns (loss, accuracy);
        with `group`, the data-parallel group the global batch is split
        over, this rank's shares of the global batch's (utils/losses.py)."""
        emb = self.embed_plan(src_type, tok_id, spk_emb)
        b, t = src_type.shape
        positions = torch.arange(t, device=emb.device)[None].expand(b, t)
        hidden = self.llm(emb, positions, None, lengths=seq_len)
        logits = self.llm_decoder(hidden)
        loss = losses.label_smoothing_ce(logits, target, self.cfg.lsm_weight,
                                         self.cfg.length_normalized_loss,
                                         group=group)
        return loss, losses.accuracy(logits, target, group=group)

    def sequence_logp(self, src_type, tok_id, target, seq_len, spk_emb):
        """The training forward's summed log-probability of each plan's
        targets (B,), for DPO: log-softmax over the speech vocabulary in
        float32, summed where target != IGNORE_ID."""
        emb = self.embed_plan(src_type, tok_id, spk_emb)
        b, t = src_type.shape
        positions = torch.arange(t, device=emb.device)[None].expand(b, t)
        hidden = self.llm(emb, positions, None, lengths=seq_len)
        logp = torch.log_softmax(self.llm_decoder(hidden).float(), dim=-1)
        valid = target != IGNORE_ID
        tgt = torch.where(valid, target, torch.zeros_like(target)).long()
        tok_logp = torch.gather(logp, -1, tgt[..., None])[..., 0]
        return (tok_logp * valid).sum(dim=-1)

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

    def decode_step_rows(self, emb_1, pos, valid, cache, slots, active):
        """One step with a cache slot per row (continuous batching: lanes
        that joined at different times sit at different positions).
        emb_1 (B, 1, C); pos, slots (B,); active (B,) bool: only active
        rows mark their slot valid, so a parked lane's context never
        grows. `valid` (B, K) is updated in place. Returns logits (B, V)."""
        rows = torch.arange(emb_1.shape[0], device=valid.device)
        valid[rows, slots] = valid[rows, slots] | active
        hidden = self.llm(emb_1, pos[:, None], qwen2.cache_bias(valid), cache,
                          slots)
        return self.llm_decoder(hidden[:, -1])

    def embed_speech_token(self, tok):
        return self.speech_embedding(tok)

    def embed_text_token(self, tok):
        return self.text_embedding(tok)

    def extend(self, emb, pos, n_true, valid, cache, slot):
        """Append the block `emb` (B, n, C) at true positions pos (B, n) to
        the cache at slots [slot, slot + n): the bistream path appends text
        and speech chunks mid-decode. Only each row's first n_true (B,)
        tokens are real; the padded tail stays invalid. The block sees the
        valid context and itself causally. slot: an int, or with n == 1 a
        (B,) tensor (a slot that lives on the device). `valid` (B, K) is
        updated in place. Returns the logits at the last true row (B, V)."""
        b, n, _ = emb.shape
        k = valid.shape[1]
        dev = valid.device
        if torch.is_tensor(slot):
            start = slot.to(dev).reshape(-1, 1)              # (B, 1)
            offset = slot.to(dev).reshape(-1)
        else:
            if slot + n > k:
                raise ValueError(f"extend of {n} at slot {slot} overflows the "
                                 f"cache of {k} slots")
            start = torch.full((b, 1), slot, device=dev)
            offset = slot
        n_true = torch.as_tensor(n_true, device=dev).long().reshape(-1, 1)
        k_idx = torch.arange(k, device=dev)[None]            # (1, K)
        valid |= (k_idx >= start) & (k_idx < start + n_true)
        rel = (k_idx - start)[:, None, :]                    # (B, 1, K)
        q_idx = torch.arange(n, device=dev)[None, :, None]   # (1, n, 1)
        self_region = (rel >= 0) & (rel < n)
        allowed = (valid[:, None, :] & ~self_region) | (
            self_region & (rel <= q_idx) & (rel < n_true[:, :, None]))
        bias = torch.where(allowed, 0.0, -1e10)[:, None].float()
        hidden = self.llm(emb, pos, bias, cache, offset)
        last = hidden[torch.arange(b, device=dev),
                      torch.clamp(n_true[:, 0] - 1, min=0)]
        return self.llm_decoder(last)


def quantize_lm(lm: SpeechLM, act_quant: bool = True) -> SpeechLM:
    """A float SpeechLM -> a new quantized one (`QuantDense` projections,
    W8A8 with act_quant, else weight-only) on the same device, its int8
    kernels from qwen2.quantize_lm_params; every other leaf is copied."""
    qcfg = replace(lm.cfg, qwen=replace(lm.cfg.qwen, quantized=True,
                                        act_quant=act_quant))
    tree = params_io.to_flax_params(lm)["params"]
    out = SpeechLM(qcfg).to(next(lm.parameters()).device)
    return params_io.load_flax_params(out, qwen2.quantize_lm_params(tree))


def build_lm_plan(text_tokens, speech_tokens, mix_ratio=(5, 15),
                  use_spk: bool = True, bistream_flags=None,
                  pad_to: Optional[int] = None, eos: int = 6561,
                  fill: int = 6563):
    """Fixed-shape training plans for a batch, on the host: dict of numpy
    src_type, tok_id, target (B, L) and seq_len (B,). Unistream rows are
    [sos][spk?][text][task][speech] with targets [speech][eos]; a row
    whose bistream flag is set, and whose speech/text ratio exceeds
    mix_ratio[1]/mix_ratio[0], interleaves mix_ratio[0] text tokens with
    mix_ratio[1] speech tokens, each full chunk's last target `fill`."""
    n_text, n_speech = mix_ratio
    rows = []
    for i in range(len(text_tokens)):
        tt = list(map(int, text_tokens[i]))
        st = list(map(int, speech_tokens[i]))
        bistream = bistream_flags is not None and bool(bistream_flags[i]) \
            and len(st) / max(len(tt), 1) > n_speech / n_text
        src, tok, tgt = [SRC_SPECIAL], [SOS_EOS_ID], [IGNORE_ID]
        if use_spk:
            src.append(SRC_SPK)
            tok.append(0)
            tgt.append(IGNORE_ID)
        if bistream:
            for j in range(int(np.ceil((len(tt) + 1) / n_text))):
                tc = tt[j * n_text:(j + 1) * n_text]
                sc = st[j * n_speech:(j + 1) * n_speech]
                if len(tc) == n_text:
                    src += [SRC_TEXT] * n_text + [SRC_SPEECH] * len(sc)
                    tok += tc + sc
                    tgt += [IGNORE_ID] * (n_text - 1) + sc + [fill]
                else:
                    rest = st[j * n_speech:]
                    src += [SRC_TEXT] * len(tc) + [SRC_SPECIAL] \
                        + [SRC_SPEECH] * len(rest)
                    tok += tc + [TASK_ID] + rest
                    tgt += [IGNORE_ID] * len(tc) + rest + [eos]
        else:
            src += [SRC_TEXT] * len(tt) + [SRC_SPECIAL] \
                + [SRC_SPEECH] * len(st)
            tok += tt + [TASK_ID] + st
            tgt += [IGNORE_ID] * len(tt) + st + [eos]
        rows.append((src, tok, tgt))
    seq_len = np.array([len(r[0]) for r in rows], np.int32)
    n = pad_to or int(seq_len.max())
    src_type = np.zeros((len(rows), n), np.int32)
    tok_id = np.zeros((len(rows), n), np.int32)
    target = np.full((len(rows), n), IGNORE_ID, np.int32)
    for i, (src, tok, tgt) in enumerate(rows):
        src_type[i, : len(src)] = src
        tok_id[i, : len(tok)] = tok
        target[i, : len(tgt)] = tgt
    return dict(src_type=src_type, tok_id=tok_id, target=target,
                seq_len=seq_len)


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


# The decode noise of a burst-driven decoder (the serving classes):
# noise(burst, first_step, n) -> the two tables of decode_noise for n
# steps, (n, B, top_k) and (n, B, V). `burst` counts the decoder's bursts
# from 0 and `first_step` is the decoder's step index at the burst's
# first step, so a caller can rebuild any keyed noise scheme.
NoiseFn = Callable[[int, int, int], Tuple[torch.Tensor, torch.Tensor]]


def generator_noise(cfg: LMConfig, batch: int,
                    generator: torch.Generator | None = None,
                    device=None) -> NoiseFn:
    """A NoiseFn that draws fresh tables from `generator`."""
    return lambda burst, first_step, n: decode_noise(cfg, n, batch, generator,
                                                     device)


def sample_step(cfg: LMConfig, logits, count, min_len, recent, g_top, g_fb):
    """One RAS draw per row from the decoder's logits (B, V): ids above
    eos always masked, eos masked while count < min_len (B,). g_top
    (B, top_k), g_fb (B, V). Returns (B,) int32."""
    eos = cfg.eos_token
    ids = torch.arange(logits.shape[-1], device=logits.device)[None]
    logp = torch.log_softmax(logits.float(), dim=-1)
    logp = logp.masked_fill(ids > eos, float("-inf"))
    logp = logp.masked_fill((ids == eos) & (count < min_len)[:, None],
                            float("-inf"))
    return sampling_ops.ras_sample_batch_pregen(
        g_top, g_fb, logp, recent, cfg.top_p, cfg.top_k, cfg.ras_win,
        cfg.ras_tau)


def push_recent_rows(recent, toks, emit):
    """The RAS window (B, W) of each emitting row shifted left with its
    new token appended; the other rows unchanged."""
    return torch.where(emit[:, None],
                       torch.cat([recent[:, 1:], toks[:, None]], dim=1),
                       recent)


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

    out = torch.full((b, max_steps), -1, dtype=torch.int32, device=dev)
    recent = torch.full((b, cfg.ras_win), -1, dtype=torch.int32, device=dev)
    count = torch.zeros((b,), dtype=torch.int64, device=dev)
    finished = torch.zeros((b,), dtype=torch.bool, device=dev)
    step = 0
    while step < max_steps and not bool(finished.all()):
        toks = sample_step(cfg, logits, count, min_len, recent,
                           gumbel_top[step], gumbel_fallback[step])
        now_eos = (toks == eos) | (count >= max_len)
        finished = finished | now_eos
        emit = ~finished
        out[:, step] = torch.where(emit, toks, torch.full_like(toks, -1))
        recent = push_recent_rows(recent, toks, emit)
        pos = prompt_len + count  # true position of the token being fed
        count = count + emit.to(count.dtype)
        emb1 = model.embed_speech_token(
            torch.clamp(toks, 0, eos - 1).long())[:, None, :]
        logits = model.decode_step(emb1, pos, valid, cache, p + step)
        step += 1
    return out, count.to(torch.int32)
