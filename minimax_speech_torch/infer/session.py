"""Streaming TTS session: 25-token hop, 3-token lookahead, chunk fades.

Port of minimax_speech_tpu/infer/session.py, both output modes. An
LM token producer feeds a flow + vocoder consumer that emits audio every
`token_hop` tokens, using the flow encoder's pre-lookahead context for
non-final chunks and crossfading chunk boundaries. The producer,
`TokenStream`, decodes in bursts over `SpeechLM.prefill` and
`decode_step`; its noise comes from `llm.decode_noise`-style tables
indexed by the absolute step, so the tokens do not depend on the burst
size and equal `llm.generate`'s for the same tables.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import torch

from minimax_speech_torch.infer.pipeline import SAMPLES_PER_FRAME, next_bucket
from minimax_speech_torch.infer.stream_flow import ChunkedFlowSession
from minimax_speech_torch.models import llm as llm_mod
from minimax_speech_torch.models import qwen2
from minimax_speech_torch.models.flow import flow_inference
from minimax_speech_torch.ops import masks as mask_ops
from minimax_speech_torch.utils.device import check_on, resolve_device


def fade_in_out(fade_in: np.ndarray, fade_out: np.ndarray,
                window: np.ndarray) -> np.ndarray:
    """Crossfade the head of fade_in with the tail of fade_out."""
    n = len(window) // 2
    out = fade_in.copy()
    out[..., :n] = (fade_in[..., :n] * window[:n]
                    + fade_out[..., -n:] * window[n:])
    return out


class TokenStream:
    """Incremental single-stream LM decode that yields tokens in bursts.

    Each burst runs `n` decode steps of `llm.generate`'s loop body; the
    host sees the burst's tokens at its end. A burst always runs its n
    steps (steps past max_len sample into HEADROOM cache slots and are
    dropped), so the state after k steps does not depend on how they were
    split."""

    HEADROOM = 64  # cache slots past max_steps (a fixed-size last burst)

    def __init__(self, model: llm_mod.SpeechLM, max_steps: int = 512,
                 device=None):
        self.device = resolve_device(device)
        check_on(model, self.device, "the LM")
        self.model = model
        self.max_steps = max_steps

    def _as_int(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), device=self.device).long()

    @torch.no_grad()
    def start(self, src_type, tok_id, prompt_len, spk_emb, min_len: int,
              max_len: int, gumbel_top=None, gumbel_fallback=None,
              generator: torch.Generator | None = None) -> None:
        """Prefill the prompt plan (1, P) and set up the decode state. The
        noise: `gumbel_top` (>= max_steps, 1, top_k) and `gumbel_fallback`
        (>= max_steps, 1, V) as `llm.generate` takes them, indexed by the
        absolute step; either missing is drawn from `generator`."""
        cfg = self.model.cfg
        dev = self.device
        src_type, tok_id = self._as_int(src_type), self._as_int(tok_id)
        b, p = src_type.shape
        if b != 1:
            raise ValueError(f"TokenStream decodes one stream, got B={b}")
        rows = self.max_steps + self.HEADROOM
        if gumbel_top is None or gumbel_fallback is None:
            g_top, g_fb = llm_mod.decode_noise(cfg, self.max_steps, 1,
                                               generator, dev)
            gumbel_top = g_top if gumbel_top is None else gumbel_top
            gumbel_fallback = g_fb if gumbel_fallback is None \
                else gumbel_fallback

        def table(g):
            # the rows past max_steps only feed discarded steps
            g = torch.as_tensor(g, device=dev).float()[: self.max_steps]
            return torch.nn.functional.pad(
                g, (0, 0, 0, 0, 0, rows - g.shape[0]))

        self._g_top, self._g_fb = table(gumbel_top), table(gumbel_fallback)
        self._prompt_len = self._as_int(prompt_len).reshape(1)
        emb = self.model.embed_plan(src_type, tok_id,
                                    torch.as_tensor(spk_emb, device=dev))
        self._cache = qwen2.make_cache(cfg.qwen, 1, p + rows, emb.dtype, dev)
        pad = mask_ops.make_non_pad_mask(self._prompt_len, p)
        positions = torch.arange(p, device=dev)[None]
        hidden = self.model.prefill(emb, pad, positions, self._cache)
        self._logits = self.model.llm_decoder(
            hidden[:, int(self._prompt_len[0]) - 1])
        self._valid = torch.cat(
            [pad, torch.zeros((1, rows), dtype=torch.bool, device=dev)], 1)
        self._recent = torch.full((1, cfg.ras_win), -1, dtype=torch.int32,
                                  device=dev)
        self._count = torch.zeros((1,), dtype=torch.int64, device=dev)
        self._finished = torch.zeros((1,), dtype=torch.bool, device=dev)
        self._min_len = self._as_int([min_len])
        self._max_len = self._as_int([max_len])
        self._p = p
        self._step = 0
        self._emitted = 0

    @torch.no_grad()
    def next_burst(self, n: int) -> tuple[np.ndarray, bool]:
        """Decode n more steps, then copy their tokens to the host once.
        Returns (the emitted tokens (<= n,), done)."""
        if n > self.HEADROOM:
            raise ValueError(f"burst of {n} exceeds HEADROOM={self.HEADROOM}")
        if self._emitted >= self.max_steps:
            return np.zeros((0,), np.int32), True
        cfg = self.model.cfg
        eos = cfg.eos_token
        out = []
        for _ in range(n):
            tok = llm_mod.sample_step(cfg, self._logits, self._count,
                                      self._min_len, self._recent,
                                      self._g_top[self._step],
                                      self._g_fb[self._step])
            self._finished |= (tok == eos) | (self._count >= self._max_len)
            emit = ~self._finished
            out.append(torch.where(emit, tok, torch.full_like(tok, -1)))
            self._recent = llm_mod.push_recent_rows(self._recent, tok, emit)
            pos = self._prompt_len + self._count
            self._count += emit.long()
            emb1 = self.model.embed_speech_token(
                torch.clamp(tok, 0, eos - 1).long())[:, None, :]
            self._logits = self.model.decode_step(
                emb1, pos, self._valid, self._cache, self._p + self._step)
            self._step += 1
        toks = torch.cat(out).cpu().numpy()
        finished = bool(self._finished[0])
        toks = toks[toks >= 0][: self.max_steps - self._emitted]
        self._emitted += len(toks)
        return toks.astype(np.int32), \
            finished or self._emitted >= self.max_steps

    def generate(self, src_type, tok_id, prompt_len, spk_emb, min_len: int,
                 max_len: int, burst_size: int = 28, **noise
                 ) -> Iterator[int]:
        """Token iterator over bursts of `burst_size` (noise: start's
        gumbel_top / gumbel_fallback / generator)."""
        self.start(src_type, tok_id, prompt_len, spk_emb, min_len, max_len,
                   **noise)
        while True:
            toks, done = self.next_burst(burst_size)
            yield from (int(t) for t in toks)
            if done:
                return


@dataclass
class StreamChunk:
    audio: np.ndarray
    tokens: int
    final: bool


class StreamingSession:
    """Audio chunks every token_hop tokens from one pipeline.

    chunked (default): the flow runs hop by hop against persistent caches
    (infer/stream_flow.py). chunked=False: each hop reruns the flow over
    the prompt and every token so far, with chunk masks (the UNet's
    through K1's chunk mode) and the lookahead tokens held back as
    encoder context. In latent mode each hop decodes its new frames; in mel
    mode HiFT decodes the whole mel so far each hop, the source of the
    previous hop spliced in (its cache, dropped on the final hop), so the
    harmonics' phases run on across hops, as the JAX package does. One
    stream at a time per session."""

    def __init__(self, pipeline, token_hop: int = 25, lookahead: int = 3,
                 overlap_frames: int = 8, chunked: bool = True):
        self.p = pipeline
        self.token_hop = token_hop
        self.lookahead = lookahead
        self.overlap_frames = overlap_frames
        self.overlap_samples = overlap_frames * SAMPLES_PER_FRAME
        self.window = np.hamming(2 * self.overlap_samples)
        self.chunked = chunked
        self.stream = TokenStream(pipeline.lm, pipeline.cfg.max_speech_tokens,
                                  pipeline.device)
        self.cfs = None
        if chunked:
            self.cfs = ChunkedFlowSession(
                pipeline.flow, pipeline.noise, token_hop=token_hop,
                lookahead=lookahead,
                max_tokens=512 + pipeline.cfg.max_speech_tokens + 64,
                device=pipeline.device)

    @torch.no_grad()
    def synthesize_stream(self, text_tokens, prompt_text_tokens,
                          prompt_speech_tokens, prompt_feat, lm_spk,
                          flow_emb, generator: torch.Generator | None = None,
                          gumbel_top=None, gumbel_fallback=None
                          ) -> Iterator[StreamChunk]:
        """Yield StreamChunks of float32 audio (PCM / 32767); the last has
        final=True. The decode noise is gumbel_top / gumbel_fallback (see
        llm.generate), else drawn from `generator`."""
        cfg = self.p.cfg
        src, tok, plen = llm_mod.build_inference_plan(
            np.concatenate([prompt_text_tokens, text_tokens]),
            prompt_speech_tokens, use_spk=cfg.lm.use_speaker_encoder)
        n_text = len(text_tokens)
        min_len = int(n_text * cfg.min_token_text_ratio)
        max_len = min(int(n_text * cfg.max_token_text_ratio),
                      cfg.max_speech_tokens)
        self._src_cache = None        # HiFT's source so far (mel mode)
        self._feat_buf = np.zeros((0, cfg.flow.output_size), np.float32)
        self._consumed = 0            # tokens already flowed (chunked mode)
        self._prefilled = False
        tokens: list[int] = []
        emitted_frames = 0            # latent frames already made audio
        prev_tail: Optional[np.ndarray] = None  # held-back overlap audio
        pending = 0                   # tokens since the last boundary
        gen = self.stream.generate(src, tok, plen, lm_spk, min_len, max_len,
                                   generator=generator, gumbel_top=gumbel_top,
                                   gumbel_fallback=gumbel_fallback)
        done = False
        while not done:
            tok_i = next(gen, None)
            if tok_i is None:
                done = True
            else:
                tokens.append(tok_i)
                pending += 1
            if not (pending >= self.token_hop + self.lookahead
                    or (done and tokens)):
                continue
            finalize = done
            if self.chunked:
                feat = self._flow_chunk_cached(tokens, prompt_speech_tokens,
                                               prompt_feat, flow_emb,
                                               finalize)
            else:
                feat = self._flow_chunk(np.asarray(tokens, np.int64),
                                        prompt_speech_tokens, prompt_feat,
                                        flow_emb, finalize)
            chunk = feat[emitted_frames:]
            if chunk.shape[0] == 0:
                if finalize:
                    break
                pending -= self.token_hop
                continue
            if self.p.hift is not None:
                wav = self._hift_prefix(feat, finalize)[
                    emitted_frames * SAMPLES_PER_FRAME:]
            else:
                wav = self._decode_pcm(chunk)
            if prev_tail is not None and len(wav) >= self.overlap_samples:
                wav = fade_in_out(wav, prev_tail, self.window)
            if not finalize:
                prev_tail = wav[-self.overlap_samples:]
                emit = wav[: len(wav) - self.overlap_samples]
                emitted_frames = feat.shape[0] - self.overlap_frames
                pending -= self.token_hop
            else:
                emit = wav
            yield StreamChunk(audio=emit, tokens=len(tokens), final=finalize)
            if finalize:
                break

    def _decode_pcm(self, feat: np.ndarray) -> np.ndarray:
        """(T, 80) latents -> float32 audio at int16 precision."""
        z = torch.as_tensor(feat, device=self.p.device)[None]
        wav = self.p.decode(z)
        pcm = torch.clamp(wav * 32767.0, -32768.0, 32767.0).to(torch.int16)
        return pcm.reshape(-1).cpu().numpy().astype(np.float32) / 32767.0

    def _hift_prefix(self, feat: np.ndarray, finalize: bool) -> np.ndarray:
        """The whole mel so far (T, 80) -> float32 audio (T * 480,) by
        HiFT with the source cache spliced in; keeps the new source as the
        cache, or drops it on the final hop."""
        if self._src_cache is None:
            self._src_cache = torch.zeros((1, 0, 1), device=self.p.device)
        wav, src = self.p.hift(torch.as_tensor(feat, device=self.p.device)
                               [None].float(), cache_source=self._src_cache)
        self._src_cache = None if finalize else src
        return wav.reshape(-1).cpu().numpy()

    def _flow_chunk_cached(self, tokens: list, prompt_tokens, prompt_feat,
                           flow_emb, finalize: bool) -> np.ndarray:
        """Incremental flow: only the new tokens each hop, against the
        persistent caches. Returns the generated region's frames so far."""
        look = self.lookahead
        if not self._prefilled:
            # the prompt's frames forced to ratio x its tokens, as the
            # reference frontend does
            ratio = self.p.cfg.token_latent_ratio
            plen = min(len(prompt_tokens), prompt_feat.shape[0] // ratio)
            self.cfs.prefill(np.asarray(prompt_tokens[:plen], np.int64),
                             np.asarray(prompt_feat[: ratio * plen],
                                        np.float32), flow_emb,
                             np.asarray(tokens[:look], np.int64))
            self._prefilled = True
        if finalize:
            rest = np.asarray(tokens[self._consumed:], np.int64)
            if len(rest):
                self._feat_buf = np.concatenate(
                    [self._feat_buf, self.cfs.final(rest)])
                self._consumed = len(tokens)
        else:
            c = self._consumed
            chunk = np.asarray(tokens[c: c + self.token_hop], np.int64)
            ctx = np.asarray(tokens[c + self.token_hop:
                                    c + self.token_hop + look], np.int64)
            self._feat_buf = np.concatenate(
                [self._feat_buf, self.cfs.step(chunk, ctx)])
            self._consumed = c + self.token_hop
        return self._feat_buf

    def _flow_chunk(self, gen_tokens, prompt_tokens, prompt_feat, flow_emb,
                    finalize: bool) -> np.ndarray:
        """The flow over prompt + generated tokens; a non-final chunk holds
        the last `lookahead` tokens back as encoder context and runs the
        chunk masks."""
        cfg = self.p.cfg
        all_tokens = np.concatenate([prompt_tokens, gen_tokens])
        tl = len(all_tokens)
        # exact length when not final: the context is the real last tokens
        buf = np.zeros((1, next_bucket(tl) if finalize else tl), np.int64)
        buf[0, :tl] = all_tokens
        feat = flow_inference(
            self.p.flow, buf, [tl], np.asarray(prompt_feat, np.float32)[None],
            flow_emb, self.p.noise, streaming=not finalize,
            finalize=finalize, device=self.p.device)
        body = tl - (0 if finalize else self.lookahead)
        n_valid = body * cfg.token_latent_ratio - prompt_feat.shape[0]
        return feat[0, :max(n_valid, 0)].float().cpu().numpy()
