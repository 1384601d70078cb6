"""Batched serving: several requests synthesized together on one device.

Port of minimax_speech_tpu/infer/serving.py. The requests' prompt plans
are padded to one bucket and decoded together by `llm.generate` (per-row
prompt lengths, length bounds and EOS), then the flow and the codec run
batched with ragged prompt masks, all in `TTSPipeline.fused_batch`. The
batch is padded to a power of two by repeating the last request, so a
window of any size runs one of a few batch shapes.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from minimax_speech_torch.infer.pipeline import (SAMPLES_PER_FRAME,
                                                 TTSPipeline, next_bucket)
from minimax_speech_torch.models import llm as llm_mod


@dataclass
class Request:
    text_tokens: np.ndarray
    prompt_text_tokens: np.ndarray
    prompt_speech_tokens: np.ndarray
    prompt_feat: np.ndarray          # (Tp_i, 80)
    lm_spk: np.ndarray               # (C,)
    flow_emb: np.ndarray             # (192,)


def request_from_info(tts, text: str, info: dict) -> Request:
    """A Request for `text` in the voice of a speaker-cache entry
    (infer/api.py `TTS.spk2info`)."""
    toks = tts.frontend.extract_text_tokens(
        tts.frontend.text_normalize(text, split=False)[0])
    return Request(
        text_tokens=toks,
        prompt_text_tokens=np.asarray(info["prompt_text_tokens"], np.int32),
        prompt_speech_tokens=np.asarray(info["prompt_tokens"], np.int32),
        prompt_feat=np.asarray(info["prompt_feat"], np.float32),
        lm_spk=np.asarray(info["lm_spk"], np.float32).reshape(-1),
        flow_emb=np.asarray(info["flow_emb"], np.float32).reshape(-1))


def length_bounds(cfg, requests: Sequence[Request]):
    """Per-request (min_len, max_len) from the text length, as numpy."""
    n_text = np.array([len(r.text_tokens) for r in requests])
    min_len = (n_text * cfg.min_token_text_ratio).astype(np.int64)
    max_len = np.minimum((n_text * cfg.max_token_text_ratio).astype(np.int64),
                         cfg.max_speech_tokens)
    return min_len, max_len


def batch_plans(cfg, requests: Sequence[Request]):
    """The requests' prompt plans padded to one bucket: src_type, tok_id
    (B, P) and the true lengths (B,), as numpy."""
    plans = [llm_mod.build_inference_plan(
        np.concatenate([r.prompt_text_tokens, r.text_tokens]),
        r.prompt_speech_tokens, use_spk=cfg.lm.use_speaker_encoder)
        for r in requests]
    p_max = next_bucket(max(pl[0].shape[1] for pl in plans))
    src = np.zeros((len(plans), p_max), np.int64)
    tok = np.zeros((len(plans), p_max), np.int64)
    plen = np.zeros((len(plans),), np.int64)
    for i, (s, t, n) in enumerate(plans):
        src[i, : s.shape[1]] = s[0]
        tok[i, : t.shape[1]] = t[0]
        plen[i] = n[0]
    return src, tok, plen


def padded_prompt_feats(requests: Sequence[Request], n_feat: int,
                        buckets=(16, 32, 64, 128, 256)):
    """The prompt features padded to one bucket (B, Tp, n_feat) and their
    true lengths (B,), as numpy."""
    pf = np.zeros((len(requests), next_bucket(
        max(r.prompt_feat.shape[0] for r in requests), buckets=buckets),
        n_feat), np.float32)
    pfl = np.zeros((len(requests),), np.int64)
    for i, r in enumerate(requests):
        pf[i, : r.prompt_feat.shape[0]] = r.prompt_feat
        pfl[i] = r.prompt_feat.shape[0]
    return pf, pfl


class BatchSynthesizer:
    def __init__(self, pipeline: TTSPipeline):
        self.p = pipeline

    def synthesize_batch(self, requests: Sequence[Request],
                         generator: torch.Generator | None = None,
                         gumbel_top=None, gumbel_fallback=None,
                         return_timings: bool = False):
        """Run the requests in one batched decode, padded to a power of
        two. The noise is llm.generate's tables for the padded batch
        (max_speech_tokens, B_padded, ...), else drawn from `generator`.
        Returns a list of float32 waveforms (PCM / 32767), one per
        request."""
        cfg = self.p.cfg
        n_real = len(requests)
        requests = list(requests)
        while len(requests) & (len(requests) - 1):
            requests.append(requests[-1])
        t0 = time.perf_counter()
        src, tok, plen = batch_plans(cfg, requests)
        min_len, max_len = length_bounds(cfg, requests)
        ptoks = np.zeros((len(requests), next_bucket(
            max(len(r.prompt_speech_tokens) for r in requests),
            buckets=(16, 32, 64, 128, 256))), np.int64)
        for i, r in enumerate(requests):
            ptoks[i, : len(r.prompt_speech_tokens)] = r.prompt_speech_tokens
        ptl = np.array([len(r.prompt_speech_tokens) for r in requests])
        pf, pfl = padded_prompt_feats(requests, cfg.flow.output_size)
        pcm, count, lm_s = self.p.fused_batch(
            src, tok, plen, np.stack([r.lm_spk for r in requests]), min_len,
            max_len, ptoks, ptl, pf, pfl,
            np.stack([r.flow_emb for r in requests]), generator=generator,
            gumbel_top=gumbel_top, gumbel_fallback=gumbel_fallback)
        t1 = time.perf_counter()
        # each row already starts at its own generated region
        spt = cfg.token_latent_ratio * SAMPLES_PER_FRAME
        wavs = [pcm[i, : int(count[i]) * spt].astype(np.float32) / 32767.0
                for i in range(n_real)]
        t2 = time.perf_counter()
        if return_timings:
            return wavs, {"e2e_s": t1 - t0, "lm_s": lm_s, "host_s": t2 - t1,
                          "total_s": t2 - t0,
                          "audio_s": sum(len(w) for w in wavs)
                          / cfg.sample_rate,
                          "tokens": [int(c) for c in count[:n_real]],
                          "batch": len(requests)}
        return wavs
