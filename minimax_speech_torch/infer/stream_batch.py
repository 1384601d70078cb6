"""Batched streaming serving: N streaming sessions in lockstep.

Port of minimax_speech_tpu/infer/stream_batch.py, both output modes:
the streaming session's hop contract (infer/session.py: `token_hop`
tokens per chunk, `lookahead` tokens of encoder context, crossfaded
boundaries) with batched decoding (infer/serving.py): one batched
prefill, bursts of batched decode steps, one batched streaming flow and
codec call per hop. Streams finish independently (EOS per row).

A burst runs its steps eagerly and copies its tokens to the host once,
at its end. The noise is an `llm.NoiseFn` indexed by the global step,
drawn from a generator unless given.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from minimax_speech_torch.infer.pipeline import SAMPLES_PER_FRAME, next_bucket
from minimax_speech_torch.infer.serving import (Request, batch_plans,
                                                length_bounds,
                                                padded_prompt_feats)
from minimax_speech_torch.infer.session import fade_in_out
from minimax_speech_torch.models import llm as llm_mod
from minimax_speech_torch.models import qwen2
from minimax_speech_torch.models.flow import flow_inference_batched
from minimax_speech_torch.ops import masks as mask_ops
from minimax_speech_torch.utils.logging import span


@dataclass
class StreamEvent:
    stream: int
    audio: np.ndarray
    tokens: int
    final: bool


@dataclass
class StreamState:
    """Host bookkeeping of one stream's audio."""
    tokens: list = field(default_factory=list)
    emitted_frames: int = 0
    prev_tail: Optional[np.ndarray] = None
    pending: int = 0
    done: bool = False      # the LM finished (EOS / max_len)
    flushed: bool = False   # the final audio went out


class HopCutter:
    """What both batched streaming servers share: the streaming flow and
    codec over the ready streams, and the cut of each stream's new audio
    with its crossfade."""

    HEADROOM = 64  # KV slots past max_steps for fixed-size bursts

    def __init__(self, pipeline, token_hop: int = 25, lookahead: int = 3,
                 overlap_frames: int = 8):
        if token_hop + lookahead > self.HEADROOM:
            raise ValueError(f"token_hop + lookahead = {token_hop + lookahead}"
                             f" exceeds HEADROOM={self.HEADROOM}")
        self.p = pipeline
        self.token_hop = token_hop
        self.lookahead = lookahead
        self.overlap_frames = overlap_frames
        self.overlap_samples = overlap_frames * SAMPLES_PER_FRAME
        self.window = np.hamming(2 * self.overlap_samples)

    @torch.no_grad()
    def flow_audio(self, seqs, pf, pfl, femb) -> np.ndarray:
        """One streaming flow call (chunk masks, K1's chunk mode) over the
        token sequences `seqs` ([prompt | generated] per stream) padded to
        a bucket, then the pipeline's vocoder; prompt features pf (B, Tp,
        80) with true lengths pfl, speaker embeddings femb (B, 192).
        Returns every stream's whole waveform (B, S), float32, on the
        host. Spans `hop.flow`, `hop.codec` and `hop.copy` (the copy to
        the host) while tracing (utils/logging.py)."""
        with span("hop.flow"):
            tok = np.zeros((len(seqs),
                            next_bucket(max(len(q) for q in seqs))), np.int64)
            for j, q in enumerate(seqs):
                tok[j, : len(q)] = q
            feat = flow_inference_batched(
                self.p.flow, tok, [len(q) for q in seqs], pf, pfl, femb,
                self.p.noise, streaming=True, device=self.p.device)
        with span("hop.codec"):
            wav = self.p.decode(feat)
        with span("hop.copy"):
            return wav.cpu().numpy()

    def cut(self, s: StreamState, wav: np.ndarray,
            prompt_frames: int) -> Optional[np.ndarray]:
        """The stream's audio not yet emitted, from its whole waveform: a
        non-final cut holds the lookahead tokens' frames and the overlap
        back, the final one releases everything. None when there is no
        new audio."""
        ratio = self.p.cfg.token_latent_ratio
        body = len(s.tokens) - (0 if s.done else self.lookahead)
        lo = (prompt_frames + s.emitted_frames) * SAMPLES_PER_FRAME
        hi = (prompt_frames + body * ratio) * SAMPLES_PER_FRAME
        if hi <= lo:
            return None
        wav = wav[lo:hi]
        if s.prev_tail is not None and len(wav) >= self.overlap_samples:
            wav = fade_in_out(wav, s.prev_tail, self.window)
        if s.done:
            s.flushed = True
            return wav
        s.prev_tail = wav[-self.overlap_samples:]
        s.emitted_frames = body * ratio - self.overlap_frames
        s.pending -= self.token_hop
        return wav[: len(wav) - self.overlap_samples]


class BatchStreamingSession(HopCutter):
    @torch.no_grad()
    def _burst(self, st: dict, noise: llm_mod.NoiseFn, burst: int, n: int):
        """n batched sample + decode steps over the streams, in place on
        the decode state `st`; the tokens (B, n), -1 where a stream emitted
        none, and the done flags go to the host once, at the end."""
        m = self.p.lm
        cfg = m.cfg
        eos = cfg.eos_token
        g_top, g_fb = (torch.as_tensor(g, device=self.p.device).float()
                       for g in noise(burst, st["step"], n))
        out = []
        for i in range(n):
            toks = llm_mod.sample_step(cfg, st["logits"], st["counts"],
                                       st["min_len"], st["recent"], g_top[i],
                                       g_fb[i])
            st["done"] |= (toks == eos) | (st["counts"] >= st["max_len"])
            emit = ~st["done"]
            out.append(torch.where(emit, toks, torch.full_like(toks, -1)))
            st["recent"] = llm_mod.push_recent_rows(st["recent"], toks, emit)
            pos = st["plen"] + st["counts"]
            st["counts"] += emit.long()
            emb1 = m.embed_speech_token(
                torch.clamp(toks, 0, eos - 1).long())[:, None, :]
            st["logits"] = m.decode_step(emb1, pos, st["valid"], st["cache"],
                                         st["p"] + st["step"])
            st["step"] += 1
        return torch.stack(out, 1).cpu().numpy(), st["done"].cpu().numpy()

    @torch.no_grad()
    def run(self, requests: Sequence[Request],
            generator: torch.Generator | None = None,
            noise: llm_mod.NoiseFn | None = None) -> Iterator[StreamEvent]:
        """Stream the requests together; yields StreamEvents (float32
        audio), each stream's last with final=True. noise: an
        llm.NoiseFn for the batch, else tables drawn from `generator`."""
        cfg = self.p.cfg
        dev = self.p.device
        m = self.p.lm
        b = len(requests)
        noise = noise or llm_mod.generator_noise(cfg.lm, b, generator, dev)
        src, tok, plen = batch_plans(cfg, requests)
        min_len, max_len = length_bounds(cfg, requests)
        p_max = src.shape[1]
        max_steps = cfg.max_speech_tokens
        emb = m.embed_plan(torch.as_tensor(src, device=dev),
                           torch.as_tensor(tok, device=dev),
                           torch.as_tensor(np.stack([r.lm_spk
                                                     for r in requests]),
                                           device=dev))
        cache = qwen2.make_cache(cfg.lm.qwen, b,
                                 p_max + max_steps + self.HEADROOM, emb.dtype,
                                 dev)
        plen_t = torch.as_tensor(plen, device=dev)
        pad = mask_ops.make_non_pad_mask(plen_t, p_max)
        hidden = m.prefill(emb, pad, torch.arange(p_max, device=dev)[None]
                           .expand(b, p_max), cache)
        st = dict(
            logits=m.llm_decoder(hidden[torch.arange(b, device=dev),
                                        plen_t - 1]),
            cache=cache,
            valid=torch.cat([pad, torch.zeros(
                (b, max_steps + self.HEADROOM), dtype=torch.bool,
                device=dev)], 1),
            recent=torch.full((b, cfg.lm.ras_win), -1, dtype=torch.int32,
                              device=dev),
            counts=torch.zeros((b,), dtype=torch.int64, device=dev),
            done=torch.zeros((b,), dtype=torch.bool, device=dev),
            plen=plen_t, min_len=torch.as_tensor(min_len, device=dev),
            max_len=torch.as_tensor(max_len, device=dev), p=p_max, step=0)
        states = [StreamState() for _ in range(b)]
        pf, pfl = padded_prompt_feats(requests, cfg.flow.output_size)
        femb = np.stack([r.flow_emb for r in requests])

        emitted, burst = 0, 0
        while emitted < max_steps and not all(s.done for s in states):
            # hop + lookahead steps first, then hop steps
            n = self.token_hop + (self.lookahead if burst == 0 else 0)
            toks, done = self._burst(st, noise, burst, n)
            burst += 1
            emitted += n
            for i, s in enumerate(states):
                if s.done:
                    continue
                new = toks[i][toks[i] >= 0]
                s.tokens.extend(int(t) for t in new)
                s.pending += len(new)
                s.done = bool(done[i])
            # hop when every active stream is ready (lockstep)
            active = [s for s in states if not s.done and not s.flushed]
            ready = active and all(
                s.pending >= self.token_hop + self.lookahead for s in active)
            finals = [s for s in states if s.done and not s.flushed
                      and s.tokens]
            if ready or finals:
                yield from self._hop(states, requests, pf, pfl, femb)
        # flush whatever still has audio pending
        for s in states:
            s.done = True
        yield from self._hop(states, requests, pf, pfl, femb)

    def _hop(self, states, requests, pf, pfl, femb) -> Iterator[StreamEvent]:
        idxs = [i for i, s in enumerate(states)
                if s.tokens and not s.flushed
                and (s.done or s.pending >= self.token_hop + self.lookahead)]
        if not idxs:
            return
        wav = self.flow_audio(
            [np.concatenate([requests[i].prompt_speech_tokens,
                             np.asarray(states[i].tokens)]) for i in idxs],
            pf[idxs], pfl[idxs], femb[idxs])
        for j, i in enumerate(idxs):
            s = states[i]
            audio = self.cut(s, wav[j], int(pfl[i]))
            if audio is not None:
                yield StreamEvent(stream=i, audio=audio, tokens=len(s.tokens),
                                  final=s.done)
