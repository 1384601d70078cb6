"""Chunked streaming flow: O(chunk) work per 25-token hop.

Port of minimax_speech_tpu/infer/stream_flow.py. Instead of rerunning
the flow over every token so far at each hop, the upsample conformer
keeps preallocated KV caches and conv tails, and the UNet estimator
keeps, for each Euler step, window K/V tails and causal-conv tails, so
each hop's 10-step solve touches only the new chunk's frames.

Chunk grid: unit 0 is the prompt, unit k the k-th hop
(ops/masks.unit_chunk_mask); `flow_inference_unit_grid` computes the
same frames in one full-sequence pass. The prefill is a full UNet pass
over the bucket-padded prompt per Euler step, attending through K1 on
CUDA; the hops attend by plain torch ops over [window tail | chunk].
"""
from __future__ import annotations

import numpy as np
import torch

from minimax_speech_torch.models import cfm
from minimax_speech_torch.models.flow import (FlowModel, latent_denormalize,
                                              latent_normalize)
from minimax_speech_torch.models.upsample_encoder import make_encoder_cache
from minimax_speech_torch.utils.device import check_on, resolve_device


class ChunkedFlowSession:
    """One utterance's streaming flow state on one device.

        s = ChunkedFlowSession(flow, noise, device=...)
        s.prefill(prompt_tokens, prompt_feat, embedding, first3)
        feat50 = s.step(tokens25, next3)     # per hop
        featN = s.final(remaining_tokens)    # the tail
    """

    def __init__(self, flow: FlowModel, noise, token_hop: int = 25,
                 lookahead: int = 3, max_tokens: int = 1024,
                 window: int = 100, final_bucket: int = 32,
                 prompt_buckets=(32, 64, 128, 256, 512), device=None):
        self.device = resolve_device(device)
        check_on(flow, self.device, "the flow model")
        self.flow = flow
        self.noise = torch.as_tensor(noise, device=self.device)
        self.hop = token_hop
        self.lookahead = lookahead
        self.max_tokens = max_tokens
        self.window = window
        self.final_bucket = final_bucket
        self.prompt_buckets = prompt_buckets
        self.ratio = flow.cfg.token_latent_ratio
        self._spks = self._enc_cache = self._unet_caches = None
        self._offset = 0

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(np.asarray(tokens, np.int64),
                               device=self.device)[None]

    @torch.no_grad()
    def prefill(self, prompt_tokens: np.ndarray, prompt_feat: np.ndarray,
                embedding, first_ctx: np.ndarray) -> None:
        """prompt_tokens: (Tp,) ints; prompt_feat: (2*Tp, 80) latents;
        embedding: (1, 192); first_ctx: the first `lookahead` tokens of the
        first hop."""
        c = self.flow.cfg
        plen = len(prompt_tokens)
        if plen + self.lookahead > self.max_tokens:
            raise ValueError(
                f"prompt of {plen} tokens (+{self.lookahead} lookahead) "
                f"exceeds the session's preallocated KV cache (max_tokens="
                f"{self.max_tokens}); raise max_tokens")
        buckets = [b for b in self.prompt_buckets
                   if b >= plen + self.lookahead]
        p = buckets[0] if buckets else plen + self.lookahead
        buf = np.zeros((p,), np.int64)
        buf[:plen] = prompt_tokens
        buf[plen: plen + self.lookahead] = first_ctx[: self.lookahead]
        pf = np.zeros((1, p * self.ratio, prompt_feat.shape[-1]), np.float32)
        pf[0, : prompt_feat.shape[0]] = prompt_feat

        enc0 = make_encoder_cache(c.encoder, 1, self.max_tokens,
                                  self.device)
        mu, self._enc_cache = self.flow.stream_encode_prefill(
            self._tokens(buf), plen, enc0)
        self._spks = self.flow.project_speaker(
            torch.as_tensor(embedding, device=self.device))
        tf = mu.shape[1]
        plen2 = plen * self.ratio
        fmask = (torch.arange(tf, device=self.device) < plen2)[None].to(
            mu.dtype)
        conds = latent_normalize(c, torch.as_tensor(pf, device=self.device)
                                 )[:, :tf] * fmask[..., None]
        z = self.noise[:, :tf].to(mu.dtype)
        _, self._unet_caches = cfm.solve_euler_collect(
            self.flow.estimate, z, mu, fmask, self._spks, conds,
            c.n_timesteps, c.cfm, collect_len=plen2, window=self.window)
        self._offset = plen

    def _chunk(self, tokens: torch.Tensor, ctx, q_valid: int) -> torch.Tensor:
        c = self.flow.cfg
        mu, self._enc_cache = self.flow.stream_encode_chunk(
            tokens, self._enc_cache, self._offset, q_valid, ctx)
        off2 = self._offset * self.ratio
        z = self.noise[:, off2: off2 + mu.shape[1]].to(mu.dtype)
        x, self._unet_caches = cfm.solve_euler_chunk(
            self.flow.estimate, z, mu, self._spks, torch.zeros_like(mu),
            c.n_timesteps, c.cfm, self._unet_caches, off2,
            q_valid * self.ratio, window=self.window)
        return latent_denormalize(c, x)[0]

    @torch.no_grad()
    def step(self, tokens: np.ndarray, next_ctx: np.ndarray) -> np.ndarray:
        """One steady hop: tokens (hop,), next_ctx (lookahead,). Returns
        (hop*ratio, 80) latent frames."""
        if len(tokens) != self.hop:
            raise ValueError(f"a hop takes {self.hop} tokens, got "
                             f"{len(tokens)}")
        if self._offset + self.hop + self.lookahead > self.max_tokens:
            raise ValueError(
                f"session at offset {self._offset} would exceed the "
                f"preallocated KV cache (max_tokens={self.max_tokens}) with "
                f"this {self.hop}-token hop; raise max_tokens")
        x = self._chunk(self._tokens(tokens), self._tokens(next_ctx),
                        self.hop)
        self._offset += self.hop
        return x.float().cpu().numpy()

    @torch.no_grad()
    def final(self, tokens: np.ndarray) -> np.ndarray:
        """The final ragged hop (<= final_bucket tokens, zero right padding:
        finalize semantics). Returns (len(tokens)*ratio, 80)."""
        n = len(tokens)
        if n > self.final_bucket:
            raise ValueError(f"final hop of {n} tokens exceeds "
                             f"final_bucket={self.final_bucket}")
        if self._offset + self.final_bucket > self.max_tokens:
            raise ValueError(
                f"session at offset {self._offset} would exceed the "
                f"preallocated KV cache (max_tokens={self.max_tokens}) with "
                f"the final {self.final_bucket}-token bucket; raise "
                f"max_tokens")
        buf = np.zeros((self.final_bucket,), np.int64)
        buf[:n] = tokens
        x = self._chunk(self._tokens(buf), None, n)
        self._offset += n
        return x[: n * self.ratio].float().cpu().numpy()
