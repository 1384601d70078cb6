"""Continuous batching: requests join and leave the running decode.

Port of minimax_speech_tpu/infer/continuous.py, both output modes. A
fixed pool of decode lanes (slots) shares one preallocated KV cache of
slots x (prompt_buckets[-1] + max_speech_tokens + HEADROOM) positions.
Admission prefills a request alone at its prompt bucket and writes the
block into a free lane of the pool, in place. Every tick runs one burst
of `token_hop` decode steps over all lanes through
`SpeechLM.decode_step_rows`: free and finished lanes are masked, and each
lane writes its own cache slot. Audio hops run per ready lane, not in
lockstep, so a request's latency does not wait on its batch-mates.

`submit` checks each request against the pool's geometry on the host: a
cache write past the pool is a device-side assert on CUDA, where JAX
would clamp it silently. A burst copies its tokens to the host once, at
its end. The noise is an `llm.NoiseFn` over the pool's lanes, indexed by
the burst (`first_step` is 0), drawn from a generator unless given.

With tracing on (utils/logging.py), a tick is span `serve.tick` over
`serve.admit`, `lm.prefill` (`prefill.plan`, `prefill.lm`,
`prefill.write`), `decode.burst` (`decode.sample` and `decode.step` per
step, `decode.sync`) and `serve.hop` (`hop.flow`, `hop.codec`,
`hop.copy`, `hop.cut`); each stream id is stamped `submit` and `grant`,
and by `run` `due` and `first_audio`.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from minimax_speech_torch.infer.pipeline import next_bucket
from minimax_speech_torch.infer.serving import Request, padded_prompt_feats
from minimax_speech_torch.infer.stream_batch import (HopCutter, StreamEvent,
                                                     StreamState)
from minimax_speech_torch.models import llm as llm_mod
from minimax_speech_torch.models import qwen2
from minimax_speech_torch.ops import masks as mask_ops
from minimax_speech_torch.utils.device import module_dtype
from minimax_speech_torch.utils.logging import span, stamp


@dataclass
class _Lane(StreamState):
    """Host bookkeeping of one decode slot."""
    request_id: int = -1
    request: Optional[Request] = None
    free: bool = True


class ContinuousBatcher(HopCutter):
    """Slot-pool continuous batching over the streaming pipeline.

    submit() queues a request and returns its stream id; tick() admits
    queued requests into free lanes, runs one decode burst and returns
    the StreamEvents it produced; run(arrivals) drives a workload of
    staggered arrivals on a simulated clock."""

    def __init__(self, pipeline, slots: int = 4, token_hop: int = 25,
                 lookahead: int = 3, overlap_frames: int = 8,
                 prompt_buckets: tuple = (64, 128, 192, 256),
                 generator: torch.Generator | None = None,
                 noise: llm_mod.NoiseFn | None = None):
        super().__init__(pipeline, token_hop, lookahead, overlap_frames)
        cfg = pipeline.cfg
        dev = pipeline.device
        self.slots = slots
        self.prompt_buckets = tuple(sorted(prompt_buckets))
        self.noise = noise or llm_mod.generator_noise(cfg.lm, slots,
                                                      generator, dev)
        self._bursts = 0
        self._ids = itertools.count()
        self._queue: list[tuple[int, Request]] = []
        self.lanes = [_Lane() for _ in range(slots)]
        self.k_len = (self.prompt_buckets[-1] + cfg.max_speech_tokens
                      + self.HEADROOM)
        # the pool: one KV cache and the decode state of every lane
        self._cache = qwen2.make_cache(cfg.lm.qwen, slots, self.k_len,
                                       module_dtype(pipeline.lm), dev)

        def zeros(dtype, *shape):
            return torch.zeros((slots, *shape), dtype=dtype, device=dev)

        self._valid = zeros(torch.bool, self.k_len)
        self._logits = zeros(torch.float32, cfg.lm.vocab)
        self._recent = torch.full((slots, cfg.lm.ras_win), -1,
                                  dtype=torch.int32, device=dev)
        self._counts = zeros(torch.int64)
        self._done = torch.ones((slots,), dtype=torch.bool, device=dev)
        self._active = zeros(torch.bool)
        self._plen = zeros(torch.int64)
        self._min_len = zeros(torch.int64)
        self._max_len = zeros(torch.int64)

    # -- device work -----------------------------------------------------------
    @torch.no_grad()
    def _prefill_into(self, slot: int, r: Request, rid=None) -> None:
        """Prefill the request (stream id `rid`) alone at its prompt
        bucket, then write its cache block and decode state into lane
        `slot` of the pool."""
        cfg = self.p.cfg
        dev = self.p.device
        m = self.p.lm
        with span("lm.prefill", rid):
            with span("prefill.plan"):
                src, tok, plen = llm_mod.build_inference_plan(
                    np.concatenate([r.prompt_text_tokens, r.text_tokens]),
                    r.prompt_speech_tokens,
                    use_spk=cfg.lm.use_speaker_encoder)
                p = next_bucket(src.shape[1], buckets=self.prompt_buckets)
                src, tok = (torch.as_tensor(np.pad(
                    a, ((0, 0), (0, p - a.shape[1]))), device=dev).long()
                    for a in (src, tok))
                n = int(plen[0])
                spk = torch.as_tensor(r.lm_spk[None], device=dev)
                pad = mask_ops.make_non_pad_mask(
                    torch.tensor([n], device=dev), p)
                pos = torch.arange(p, device=dev)[None]
            with span("prefill.lm"):
                emb = m.embed_plan(src, tok, spk)
                block = qwen2.make_cache(cfg.lm.qwen, 1, p, emb.dtype, dev)
                hidden = m.prefill(emb, pad, pos, block)
            with span("prefill.write"):
                self._cache[0][:, slot, :p] = block[0][:, 0]
                self._cache[1][:, slot, :p] = block[1][:, 0]
                self._valid[slot] = False
                self._valid[slot, :p] = pad[0]
                self._logits[slot] = m.llm_decoder(hidden[0, n - 1]).float()
                self._recent[slot] = -1
                self._counts[slot] = 0
                self._done[slot] = False
                self._active[slot] = True
                self._plen[slot] = n
                n_text = len(r.text_tokens)
                self._min_len[slot] = int(n_text * cfg.min_token_text_ratio)
                self._max_len[slot] = min(
                    int(n_text * cfg.max_token_text_ratio),
                    cfg.max_speech_tokens)

    @torch.no_grad()
    def _burst(self, n: int):
        """n sample + embed + decode steps over every lane, in place on the
        pool; inactive and finished lanes stay in the batch, masked. The
        tokens (slots, n), -1 where a lane emitted none, and the done flags
        go to the host once, at the end."""
        m = self.p.lm
        cfg = m.cfg
        eos = cfg.eos_token
        with span("decode.burst"):
            g_top, g_fb = (torch.as_tensor(g, device=self.p.device).float()
                           for g in self.noise(self._bursts, 0, n))
            self._bursts += 1
            out = []
            for i in range(n):
                with span("decode.sample"):
                    toks = llm_mod.sample_step(
                        cfg, self._logits, self._counts, self._min_len,
                        self._recent, g_top[i], g_fb[i])
                    now_eos = (toks == eos) | (self._counts >= self._max_len)
                    self._done |= now_eos & self._active
                    emit = self._active & ~self._done
                    out.append(torch.where(emit, toks,
                                           torch.full_like(toks, -1)))
                    self._recent = llm_mod.push_recent_rows(self._recent,
                                                            toks, emit)
                    # each lane's write position
                    slots_w = self._plen + self._counts
                    self._counts += emit.long()
                with span("decode.step"):
                    emb1 = m.embed_speech_token(
                        torch.clamp(toks, 0, eos - 1).long())[:, None, :]
                    self._logits = m.decode_step_rows(
                        emb1, slots_w, self._valid, self._cache, slots_w,
                        emit).float()
            with span("decode.sync"):
                return (torch.stack(out, 1).cpu().numpy(),
                        self._done.cpu().numpy())

    # -- host scheduling -------------------------------------------------------
    def submit(self, request: Request) -> int:
        """Queue a request; returns its stream id. A prompt plan longer
        than the largest prompt bucket is refused here, before it can
        reach the shared pool."""
        cfg = self.p.cfg
        spk = 1 if cfg.lm.use_speaker_encoder else 0
        plan_len = (2 + spk + len(request.prompt_text_tokens)
                    + len(request.text_tokens)
                    + len(request.prompt_speech_tokens))
        if plan_len > self.prompt_buckets[-1]:
            raise ValueError(
                f"prompt plan of {plan_len} tokens exceeds the largest "
                f"prompt bucket {self.prompt_buckets[-1]}; shorten the "
                f"prompt/text or construct the batcher with larger "
                f"prompt_buckets")
        rid = next(self._ids)
        stamp(rid, "submit")
        self._queue.append((rid, request))
        return rid

    def _admit(self):
        with span("serve.admit"):
            for slot, lane in enumerate(self.lanes):
                if not self._queue:
                    return
                if lane.free:
                    rid, r = self._queue.pop(0)
                    stamp(rid, "grant")
                    self._prefill_into(slot, r, rid)
                    self.lanes[slot] = _Lane(request_id=rid, request=r,
                                             free=False)

    def tick(self) -> list[StreamEvent]:
        """Admit queued requests, run one decode burst, hop ready lanes."""
        with span("serve.tick"):
            self._admit()
            if all(lane.free for lane in self.lanes):
                return []
            toks, done = self._burst(self.token_hop)
            for i, lane in enumerate(self.lanes):
                if lane.free or lane.done:
                    continue
                new = toks[i][toks[i] >= 0]
                lane.tokens.extend(int(t) for t in new)
                lane.pending += len(new)
                lane.done = bool(done[i])
            with span("serve.hop"):
                events = list(self._hop())
            # recycle flushed lanes, then admit at once, so a waiting request
            # loses at most one tick
            for i, lane in enumerate(self.lanes):
                if lane.flushed:
                    self.lanes[i] = _Lane()
            self._admit()
            return events

    def busy(self) -> bool:
        return bool(self._queue) or any(not lane.free for lane in self.lanes)

    def _hop(self) -> Iterator[StreamEvent]:
        """The streaming flow and codec for every ready lane, whatever the
        others do."""
        # a lane that finished with no token (empty text: max_len 0) has
        # no audio but must still flush, or its slot would leak
        for lane in self.lanes:
            if not lane.free and not lane.flushed and lane.done \
                    and not lane.tokens:
                lane.flushed = True
                yield StreamEvent(stream=lane.request_id,
                                  audio=np.zeros(0, np.float32), tokens=0,
                                  final=True)
        idxs = [i for i, lane in enumerate(self.lanes)
                if not lane.free and not lane.flushed and lane.tokens
                and (lane.done
                     or lane.pending >= self.token_hop + self.lookahead)]
        if not idxs:
            return
        reqs = [self.lanes[i].request for i in idxs]
        pf, pfl = padded_prompt_feats(reqs, self.p.cfg.flow.output_size)
        wav = self.flow_audio(
            [np.concatenate([r.prompt_speech_tokens,
                             np.asarray(self.lanes[i].tokens, np.int64)])
             for i, r in zip(idxs, reqs)],
            pf, pfl, np.stack([r.flow_emb for r in reqs]))
        for j, i in enumerate(idxs):
            lane = self.lanes[i]
            with span("hop.cut"):
                audio = self.cut(lane, wav[j], int(pfl[j]))
            if audio is None:
                if lane.done:
                    lane.flushed = True
                    yield StreamEvent(stream=lane.request_id,
                                      audio=np.zeros(0, np.float32),
                                      tokens=len(lane.tokens), final=True)
                continue
            yield StreamEvent(stream=lane.request_id, audio=audio,
                              tokens=len(lane.tokens), final=lane.done)

    # -- workload driver -------------------------------------------------------
    def run(self, arrivals: Iterable[tuple[float, Request]],
            clock=None) -> Iterator[tuple[float, StreamEvent]]:
        """Drive staggered arrivals: (t_arrive, request) pairs. clock: a
        callable giving 'now'; by default a simulated clock that jumps to
        the next arrival when idle and advances by each tick's host time
        (each tick ends in a copy to the host, so that includes the
        device's work). Yields (emit_time, event). Each request is stamped
        `due` at its arrival time on time.perf_counter (its submission
        less how late `clock` says it was submitted), and `first_audio`
        as its first audio is handed on."""
        pending = sorted(arrivals, key=lambda a: a[0])
        use_wall = clock is not None
        now = 0.0

        def t():
            return clock() if use_wall else now

        i = 0
        while i < len(pending) or self.busy():
            while i < len(pending):
                late = t() - pending[i][0]
                if late < 0:
                    break
                due = time.perf_counter() - late
                stamp(self.submit(pending[i][1]), "due", due)
                i += 1
            if not self.busy():
                if use_wall:
                    time.sleep(0.001)
                else:
                    now = pending[i][0]
                continue
            t0 = time.perf_counter()
            events = self.tick()
            if not use_wall:
                now += time.perf_counter() - t0
            for ev in events:
                if len(ev.audio):
                    stamp(ev.stream, "first_audio")
                yield t(), ev
