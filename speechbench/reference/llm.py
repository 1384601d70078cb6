"""Stage-1 TTS LM, plain: a frozen copy of the port's SpeechLM (the plan
embedding, speaker conditioning, the training loss) over the plain
Qwen2 body, and the host plan builders. `plan_logits` runs a whole
plan once: the reference of the served decode, which the port runs as
a prefill and then one cached step per token."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from speechbench.reference import qwen2
from speechbench.reference.speaker_encoder import (
    LearnableSpeakerEncoder, SpeakerEncoderConfig, l2_normalize)
from speechbench.reference import losses

IGNORE_ID = losses.IGNORE_ID

# plan source types
SRC_PAD, SRC_SPECIAL, SRC_TEXT, SRC_SPEECH, SRC_SPK = 0, 1, 2, 3, 4
SOS_EOS_ID, TASK_ID = 0, 1


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
        self.llm_decoder = qwen2.Linear(c.llm_output_size, c.vocab,
                                        lower=c.qwen.lower)
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

    def forward(self, src_type, tok_id, target, seq_len, spk_emb):
        """The training loss from plan tensors: src_type/tok_id/target
        (B, L), seq_len (B,), spk_emb (B, C)."""
        logits = self.plan_logits(src_type, tok_id, seq_len, spk_emb)
        return losses.label_smoothing_ce(logits, target, self.cfg.lsm_weight,
                                         self.cfg.length_normalized_loss)

    def plan_logits(self, src_type, tok_id, seq_len, spk_emb):
        """Logits (B, L, V), float32, of whole plans (B, L) with true
        lengths seq_len (B,)."""
        emb = self.embed_plan(src_type, tok_id, spk_emb)
        return self.llm_decoder(self.llm(emb, seq_len))


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
