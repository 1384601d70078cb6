"""Bistream decoding: streaming text in, speech tokens out.

Port of minimax_speech_tpu/infer/bistream.py. Text arrives as an
iterator of token chunks; the LM context interleaves mix_ratio[0] = 5
text tokens with mix_ratio[1] = 15 speech tokens, and the decoder emits
a FILL token after each full speech chunk (forced at the chunk's end).
When the text ends, the rest of it and a TASK token are appended and the
decode runs to EOS. The context grows by appending blocks to one
preallocated KV cache through `SpeechLM.extend`.

Decoding runs in bursts of mix_ratio[1] + 1 steps, eagerly, with one
copy to the host at a burst's end: the cache slot, the position and the
stop flag live on the device, a step after the burst stopped writes an
invalid slot and changes nothing else. Each step takes one row of noise
(the Gumbel draws behind JAX's per-step key split): `noise(burst, n)`
returns a (n, top_k) and a (n, V) table, drawn from a generator unless
given.
"""
from __future__ import annotations

from typing import Callable, Iterator, Tuple

import numpy as np
import torch

from minimax_speech_torch.models import llm as llm_mod
from minimax_speech_torch.models import qwen2
from minimax_speech_torch.ops import sampling as sampling_ops
from minimax_speech_torch.utils.device import check_on, resolve_device

BistreamNoise = Callable[[int, int], Tuple[torch.Tensor, torch.Tensor]]


class BistreamDecoder:
    def __init__(self, model: llm_mod.SpeechLM, max_steps: int = 768,
                 device=None):
        self.device = resolve_device(device)
        check_on(model, self.device, "the LM")
        self.model = model
        self.max_steps = max_steps

    def _ids(self, toks) -> torch.Tensor:
        return torch.as_tensor(np.asarray(toks, np.int64).reshape(1, -1),
                               device=self.device)

    @torch.no_grad()
    def _burst(self, st: dict, g_top, g_fb, n: int, fill_at: int,
               allow_eos: bool) -> np.ndarray:
        """Up to n sample + extend steps, in place on the decode state
        `st`. fill_at: the step at which FILL is forced (-1: never). A fill
        (or, with allow_eos, EOS) ends the run; later steps change nothing.
        Returns the n sampled ids, -1 after the stop, on the host."""
        m = self.model
        cfg = m.cfg
        eos, fill = cfg.eos_token, cfg.fill_token
        ids = torch.arange(cfg.vocab, device=self.device)
        banned = (ids > eos) & (ids != fill)
        if not allow_eos:
            banned |= ids == eos
        stopped = torch.zeros((), dtype=torch.bool, device=self.device)
        out = []
        for i in range(n):
            logp = torch.log_softmax(st["logits"][0].float(), dim=-1)
            sampled = sampling_ops.ras_sample(
                g_top[i], g_fb[i], logp.masked_fill(banned, float("-inf")),
                st["recent"], cfg.top_p, cfg.top_k, cfg.ras_win, cfg.ras_tau)
            forced = fill_at == i
            tok = torch.full_like(sampled, fill) if forced else sampled
            if not forced:
                st["recent"] = torch.where(
                    stopped, st["recent"],
                    sampling_ops.push_recent(st["recent"], tok))
            # final decode: EOS stops, a stray fill is skipped; chunk
            # decode: a fill (or EOS) ends the run
            stop_tok = tok == eos if allow_eos else tok >= eos
            skip_tok = tok > eos if allow_eos else torch.zeros_like(stopped)
            out.append(torch.where(stopped, -1, tok))
            do_ext = ~(stopped | stop_tok | skip_tok)
            emb = m.embed_speech_token(torch.clamp(tok, 0, eos - 1)
                                       .long().reshape(1, 1))
            logits = m.extend(emb, st["pos"].reshape(1, 1), do_ext.reshape(1),
                              st["valid"], st["cache"], st["slot"])
            st["logits"] = torch.where(do_ext, logits, st["logits"])
            st["slot"] = st["slot"] + do_ext.long()
            st["pos"] = st["pos"] + do_ext.long()
            stopped = stopped | stop_tok
        return torch.stack(out).cpu().numpy()

    def _append(self, st: dict, emb) -> None:
        """Append a block of real tokens (1, n, C) at the host's slot."""
        n = emb.shape[1]
        slot = int(st["slot"])
        pos = int(st["pos"])
        st["logits"] = self.model.extend(
            emb, pos + torch.arange(n, device=self.device)[None], [n],
            st["valid"], st["cache"], slot)
        st["slot"] = torch.tensor([slot + n], device=self.device)
        st["pos"] = torch.tensor(pos + n, device=self.device)

    @torch.no_grad()
    def generate(self, text_chunks: Iterator[np.ndarray],
                 prompt_text: np.ndarray, prompt_speech: np.ndarray, spk_emb,
                 generator: torch.Generator | None = None,
                 noise: BistreamNoise | None = None) -> Iterator[int]:
        """Yield speech token ids as the text chunks arrive. spk_emb: the
        projected speaker embedding (1, C)."""
        m = self.model
        cfg = m.cfg
        n_text, n_speech = cfg.mix_ratio
        eos, fill = cfg.eos_token, cfg.fill_token
        dev = self.device
        max_len = self.max_steps
        if noise is None:
            def noise(burst, n):
                return (sampling_ops.gumbel((n, cfg.top_k), generator, dev),
                        sampling_ops.gumbel((n, cfg.vocab), generator, dev))
        cache = qwen2.make_cache(cfg.qwen, 1, max_len + 512,
                                 next(m.parameters()).dtype, dev)
        st = dict(cache=cache,
                  valid=torch.zeros((1, cache[0].shape[2]), dtype=torch.bool,
                                    device=dev),
                  slot=torch.tensor([0], device=dev),
                  pos=torch.tensor(0, device=dev),
                  recent=torch.full((cfg.ras_win,), -1, dtype=torch.int32,
                                    device=dev))
        spk_emb = torch.as_tensor(spk_emb, device=dev)
        bursts = 0

        def plan_block(src_type, tok_id):
            return m.embed_plan(self._ids([src_type]), self._ids([tok_id]),
                                spk_emb)

        def burst(fill_at: int, allow_eos: bool) -> np.ndarray:
            nonlocal bursts
            n = n_speech + 1
            if int(st["slot"]) + n > st["valid"].shape[1]:
                raise ValueError("the bistream context outgrew its cache of "
                                 f"{st['valid'].shape[1]} slots")
            g_top, g_fb = (torch.as_tensor(g, device=dev).float()
                           for g in noise(bursts, n))
            bursts += 1
            return self._burst(st, g_top, g_fb, n, fill_at, allow_eos)

        # [sos] (+ the speaker slot, as the trained layout has it)
        self._append(st, plan_block(llm_mod.SRC_SPECIAL, llm_mod.SOS_EOS_ID))
        if cfg.use_speaker_encoder:
            self._append(st, plan_block(llm_mod.SRC_SPK, 0))

        text_cache = list(map(int, prompt_text))
        speech_prompt = list(map(int, prompt_speech))
        out_tokens: list[int] = []
        next_fill = -1

        def append(table, toks, size):
            # an id past the table is a device-side assert on CUDA
            if min(toks) < 0 or max(toks) >= size:
                raise ValueError(f"token ids {toks} outside [0, {size})")
            self._append(st, table(self._ids(toks)))

        def append_text(toks):
            append(m.embed_text_token, toks, cfg.qwen.vocab_size)

        def append_speech(toks):
            append(m.embed_speech_token, toks, cfg.speech_token_size)

        for chunk in text_chunks:
            text_cache.extend(map(int, chunk))
            # the prompt's speech interleaved with its text, 5:15
            while speech_prompt and len(text_cache) >= n_text:
                append_text(text_cache[:n_text])
                append_speech(speech_prompt[:n_speech])
                text_cache = text_cache[n_text:]
                speech_prompt = speech_prompt[n_speech:]
            if speech_prompt:
                continue  # more text is needed before decoding
            # after each full speech chunk (its fill out), 5 more text
            if not out_tokens or out_tokens[-1] == fill:
                if len(text_cache) < n_text:
                    continue
                append_text(text_cache[:n_text])
                text_cache = text_cache[n_text:]
            # decode to the chunk's fill
            while len(out_tokens) < max_len:
                fill_at = (next_fill - len(out_tokens)
                           if next_fill != -1 else -1)
                hit_fill = False
                for tok in (int(t) for t in burst(fill_at, False) if t >= 0):
                    if len(out_tokens) >= max_len:
                        break
                    if tok == fill:
                        next_fill = len(out_tokens) + n_speech + 1
                    out_tokens.append(tok)
                    if tok >= eos:
                        hit_fill = True
                        break  # fill: fetch more text
                    yield tok
                if hit_fill:
                    break

        # the rest of the text and the task token, then decode to EOS
        if text_cache:
            append_text(text_cache)
        self._append(st, plan_block(llm_mod.SRC_SPECIAL, llm_mod.TASK_ID))
        while len(out_tokens) < max_len:
            got_eos = False
            for tok in (int(t) for t in burst(-1, True) if t >= 0):
                if len(out_tokens) >= max_len:
                    break
                out_tokens.append(tok)
                if tok == eos:
                    got_eos = True
                    break
                if tok > eos:
                    continue  # a stray fill in the final decode
                yield tok
            if got_eos:
                break
