"""Zero-shot TTS pipeline: text + prompt audio -> 24 kHz int16 PCM.

Port of minimax_speech_tpu/infer/pipeline.py, in both output modes:
`output_type` latent (the flow makes DAC-VAE latents, the DAC-VAE
decoder makes audio) or mel (the flow makes an 80-bin mel at 50 Hz, the
HiFT vocoder makes audio, as the upstream CosyVoice2 layout runs):

  1. prompt audio 16 kHz -> whisper log-mel -> S3 FSQ tokens
  2. prompt audio 24 kHz -> a host log-mel (speaker-encoder conditioning,
     and the flow's prompt in mel mode) and, in latent mode, DAC-VAE
     latents (the flow's prompt)
  3. SpeechLM RAS decode: text (+ prompt text) tokens -> FSQ tokens
  4. FlowModel: [prompt | generated] tokens -> latents or mel (10-step
     CFG Euler)
  5. the vocoder (`decode`) -> trimmed int16 PCM, cut on the device

Everything runs on one device, CUDA unless the caller passes
device="cpu". `synthesize_fused` copies to the host once, at the end; it
is `fused_batch`, which batched serving runs (infer/serving.py), at B = 1.
`synthesize` (the unfused path) copies the generated tokens to the host
between the LM and the flow. Streaming is infer/session.py. With
`lm.qwen.quantized` the LM's projections are W8A8 (models/qwen2.py), and
`from_random` gives them random int8 kernels, as bench.py does.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from minimax_speech_torch.models import cfm as cfm_mod
from minimax_speech_torch.models import dac_vae, hifigan
from minimax_speech_torch.models import llm as llm_mod
from minimax_speech_torch.models import s3tokenizer as s3
from minimax_speech_torch.models.flow import (FlowConfig, FlowModel,
                                              flow_inference,
                                              flow_inference_batched)
from minimax_speech_torch.ops import mel as mel_ops
from minimax_speech_torch.utils import params_io
from minimax_speech_torch.utils.device import resolve_device

# 24 kHz samples per 50 Hz flow frame: the DAC-VAE's hop, HiFT's upsampling
SAMPLES_PER_FRAME = 480


def next_bucket(n: int, buckets=(32, 64, 128, 256, 512, 1024)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return ((n + 255) // 256) * 256


@dataclass
class TTSConfig:
    lm: llm_mod.LMConfig = field(default_factory=llm_mod.LMConfig)
    flow: FlowConfig = field(default_factory=FlowConfig)
    dac: dac_vae.DACVAEConfig = field(default_factory=dac_vae.DACVAEConfig)
    hift: hifigan.HiFTConfig = field(default_factory=hifigan.HiFTConfig)
    s3: s3.S3TokenizerConfig = field(default_factory=s3.S3TokenizerConfig)
    output_type: str = "latent"       # 'latent' (DAC) | 'mel' (HiFT)
    token_frame_rate: int = 25
    token_latent_ratio: int = 2
    sample_rate: int = 24000
    max_speech_tokens: int = 512
    min_token_text_ratio: float = 2.0
    max_token_text_ratio: float = 20.0


def decode_plan(cfg: TTSConfig, text_tokens, prompt_text_tokens,
                prompt_speech_tokens):
    """The LM decode's inputs for one utterance: the bucket-padded prompt
    plan (src_type, tok_id, prompt_len) and the length bounds (min_len,
    max_len) from the text length, as numpy."""
    full_text = np.concatenate([prompt_text_tokens, text_tokens])
    src, tok, plen = llm_mod.build_inference_plan(
        full_text, prompt_speech_tokens, use_spk=cfg.lm.use_speaker_encoder)
    pad_to = next_bucket(src.shape[1])
    src = np.pad(src, ((0, 0), (0, pad_to - src.shape[1])))
    tok = np.pad(tok, ((0, 0), (0, pad_to - tok.shape[1])))
    n_text = len(text_tokens)
    min_len = int(n_text * cfg.min_token_text_ratio)
    max_len = min(int(n_text * cfg.max_token_text_ratio),
                  cfg.max_speech_tokens)
    return src, tok, plen, np.array([min_len]), np.array([max_len])


class TTSPipeline:
    """The four models on one device, in eval mode, with the fixed flow
    noise table. The codec is the DAC-VAE (`dac`) in latent mode and the
    HiFT vocoder (`hift`) in mel mode; the other one is None."""

    def __init__(self, cfg: TTSConfig, device=None):
        if cfg.output_type not in ("latent", "mel"):
            raise ValueError(f"output_type={cfg.output_type!r}: 'latent' or "
                             f"'mel'")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dac = self.hift = None
        with torch.device(self.device):
            self.lm = llm_mod.SpeechLM(cfg.lm).eval()
            self.flow = FlowModel(cfg.flow).eval()
            if cfg.output_type == "latent":
                self.dac = dac_vae.DACVAE(cfg.dac).eval()
            else:
                self.hift = hifigan.HiFTGenerator(cfg.hift).eval()
            self.s3 = s3.S3TokenizerV2(cfg.s3).eval()
        self.noise = torch.as_tensor(cfm_mod.make_fixed_noise(
            15000, cfg.flow.output_size)[None], device=self.device)

    def models(self):
        return {"lm": self.lm, "flow": self.flow,
                "codec": self.dac if self.hift is None else self.hift,
                "s3": self.s3}

    def decode(self, feat: torch.Tensor) -> torch.Tensor:
        """Flow output (B, T, 80) on the device -> float32 waveform (B, T *
        480): DAC-VAE decode of latents, or HiFT of a mel (its sine source
        without noise, as the JAX package's key=None)."""
        if self.hift is not None:
            return self.hift(feat.float())[0]
        return self.dac.decode(feat.float()).reshape(feat.shape[0], -1)

    def extract_prompt_feat(self, audio_24k: np.ndarray) -> np.ndarray:
        """The flow's prompt features for `output_type`: DAC latents, or
        the log-mel."""
        if self.cfg.output_type == "latent":
            return self.extract_prompt_latent(audio_24k)
        return self.extract_prompt_mel(audio_24k)

    # -- construction --------------------------------------------------------
    @classmethod
    def from_random(cls, cfg: TTSConfig, seed: int = 0,
                    device=None) -> "TTSPipeline":
        """Random weights at flax-default scales, from `seed`."""
        pipe = cls(cfg, device)
        gen = torch.Generator(device=pipe.device).manual_seed(seed)
        for m in pipe.models().values():
            params_io.init_params(m, gen)
        return pipe

    @classmethod
    def from_flax(cls, cfg: TTSConfig, lm_vars, flow_vars, codec_vars,
                  s3_vars, device=None) -> "TTSPipeline":
        """Weights from the JAX package's variable trees (numpy leaves, as
        from its params_io.load_params); codec_vars are the DAC-VAE's in
        latent mode and HiFT's in mel mode."""
        pipe = cls(cfg, device)
        for m, tree in zip(pipe.models().values(),
                           (lm_vars, flow_vars, codec_vars, s3_vars)):
            params_io.load_flax_params(m, tree)
        return pipe

    # -- prompt processing ----------------------------------------------------
    @torch.no_grad()
    def extract_prompt_tokens(self, audio_16k: np.ndarray) -> np.ndarray:
        """16 kHz prompt audio (<= 30 s) -> FSQ tokens."""
        audio = torch.as_tensor(np.asarray(audio_16k, np.float32),
                                device=self.device)
        mel_t = mel_ops.whisper_log_mel(audio).T[None]
        t = mel_t.shape[1]
        mel_t = torch.nn.functional.pad(mel_t, (0, 0, 0, next_bucket(t) - t))
        codes, code_len = self.s3(mel_t, torch.tensor([t], device=self.device))
        return codes[0, : int(code_len[0])].cpu().numpy()

    def extract_prompt_mel(self, audio_24k: np.ndarray) -> np.ndarray:
        """24 kHz prompt -> (T, 80) log-mel at 50 Hz, on the host."""
        return mel_ops.hifigan_log_mel_np(audio_24k).T.copy()

    @torch.no_grad()
    def extract_prompt_latent(self, audio_24k: np.ndarray) -> np.ndarray:
        """24 kHz prompt -> (T, 80) DAC latents (mu) at 50 Hz."""
        a = dac_vae.pad_to_hop(np.asarray(audio_24k, np.float32)[None, :],
                               self.cfg.dac.hop_length)
        a = torch.as_tensor(a[..., None], device=self.device)
        return self.dac.encode(a)[1][0].cpu().numpy()

    @torch.no_grad()
    def speaker_embedding(self, prompt_mel: np.ndarray):
        """(T, 80) reference mel -> conditioning for the LM (projected,
        (1, C)) and the flow (192-d, (1, 192)), on the device."""
        mel = torch.as_tensor(np.asarray(prompt_mel, np.float32),
                              device=self.device)[None]
        return self.lm.embed_speaker(mel), self.flow.embed_speaker(mel)

    # -- synthesis ------------------------------------------------------------
    @torch.no_grad()
    def synthesize(self, text_tokens: np.ndarray,
                   prompt_text_tokens: np.ndarray,
                   prompt_speech_tokens: np.ndarray, prompt_feat: np.ndarray,
                   lm_spk, flow_emb, generator: torch.Generator | None = None,
                   gumbel_top=None, gumbel_fallback=None,
                   return_timings: bool = False):
        """One utterance, unfused: the LM decode, the generated tokens to
        the host, then flow (`flow_inference` on [prompt | generated]
        padded to a bucket) and the vocoder, the waveform trimmed on the
        host. prompt_feat: (Tp, 80) latents or mel, as output_type. Noise
        as synthesize_fused. Returns float32 audio."""
        cfg = self.cfg
        t0 = time.perf_counter()
        src, tok, plen, min_len, max_len = decode_plan(
            cfg, text_tokens, prompt_text_tokens, prompt_speech_tokens)
        out, count = llm_mod.generate(
            self.lm, src, tok, plen, lm_spk, min_len, max_len,
            max_steps=cfg.max_speech_tokens, gumbel_top=gumbel_top,
            gumbel_fallback=gumbel_fallback, generator=generator,
            device=self.device)
        n = int(count[0])
        gen_tokens = out[0, :n].cpu().numpy()
        t1 = time.perf_counter()

        all_tokens = np.concatenate([prompt_speech_tokens, gen_tokens])
        tl = len(all_tokens)
        tokens = np.zeros((1, next_bucket(tl)), np.int64)
        tokens[0, :tl] = all_tokens
        feat = flow_inference(
            self.flow, tokens, [tl], np.asarray(prompt_feat, np.float32)[None],
            flow_emb, self.noise, device=self.device)
        wav = self.decode(feat).reshape(-1)
        wav = wav[: n * cfg.token_latent_ratio * SAMPLES_PER_FRAME]
        wav = wav.cpu().numpy()
        t2 = time.perf_counter()
        if return_timings:
            return wav, {"lm_s": t1 - t0, "flow_s": t2 - t1,
                         "total_s": t2 - t0, "tokens": n,
                         "audio_s": len(wav) / cfg.sample_rate}
        return wav

    @torch.no_grad()
    def synthesize_fused(self, text_tokens: np.ndarray,
                         prompt_text_tokens: np.ndarray,
                         prompt_speech_tokens: np.ndarray,
                         prompt_feat: np.ndarray, lm_spk, flow_emb,
                         generator: torch.Generator | None = None,
                         gumbel_top=None, gumbel_fallback=None,
                         return_timings: bool = False):
        """One utterance: LM decode -> flow -> vocoder -> trim -> int16,
        on the device, one copy to the host at the end: `fused_batch` at
        B = 1. prompt_feat: (Tp, 80) latents or mel, as output_type. The
        decode noise is `gumbel_top` / `gumbel_fallback` (see
        llm.generate), else drawn from `generator`. Returns float32 audio
        (PCM / 32767)."""
        cfg = self.cfg
        t0 = time.perf_counter()
        n_prompt = len(prompt_speech_tokens)
        ptoks = np.zeros((1, next_bucket(n_prompt,
                                         buckets=(16, 32, 64, 128, 256))),
                         np.int64)
        ptoks[0, :n_prompt] = prompt_speech_tokens
        pf_pad = next_bucket(prompt_feat.shape[0],
                             buckets=(16, 32, 64, 128, 256, 512))
        pf = np.zeros((1, pf_pad, cfg.flow.output_size), np.float32)
        pf[0, : prompt_feat.shape[0]] = prompt_feat
        src, tok, plen, min_len, max_len = decode_plan(
            cfg, text_tokens, prompt_text_tokens, prompt_speech_tokens)
        pcm, count, lm_s = self.fused_batch(
            src, tok, plen, lm_spk, min_len, max_len, ptoks, [n_prompt], pf,
            [prompt_feat.shape[0]], flow_emb, generator=generator,
            gumbel_top=gumbel_top, gumbel_fallback=gumbel_fallback)
        n = int(count[0])
        wav = pcm[0, : n * cfg.token_latent_ratio * SAMPLES_PER_FRAME].astype(
            np.float32) / 32767.0
        t1 = time.perf_counter()
        if return_timings:
            return wav, {"total_s": t1 - t0, "lm_s": lm_s, "tokens": n,
                         "audio_s": len(wav) / cfg.sample_rate}
        return wav

    @torch.no_grad()
    def fused_batch(self, src, tok, plen, lm_spk, min_len, max_len,
                    prompt_tokens, prompt_tok_len, prompt_feat,
                    prompt_feat_len, flow_emb,
                    generator: torch.Generator | None = None,
                    gumbel_top=None, gumbel_fallback=None):
        """B utterances on the device, the twin of the JAX package's
        `_e2e`: the LM decode of the padded plans src/tok (B, P) with true
        lengths plen and bounds min_len/max_len (B,); each row's [prompt |
        generated] tokens compacted by a gather (prompt_tokens (B, Pt),
        true lengths prompt_tok_len); one flow_inference_batched call with
        the ragged prompt features prompt_feat (B, Tp, 80) /
        prompt_feat_len and flow_emb (B, 192); the vocoder; row i trimmed
        from its own prompt_feat_len[i] frames (the start clamped as
        dynamic_slice clamps it) to int16. Noise as llm.generate, for B
        rows. Returns (PCM (B, S) int16, token counts (B,), both numpy; the
        LM's host seconds): row i's audio is its first counts[i] * 960
        samples."""
        cfg = self.cfg
        dev = self.device
        t0 = time.perf_counter()
        out, count = llm_mod.generate(
            self.lm, src, tok, plen, torch.as_tensor(lm_spk, device=dev),
            min_len, max_len, max_steps=cfg.max_speech_tokens,
            gumbel_top=gumbel_top, gumbel_fallback=gumbel_fallback,
            generator=generator, device=dev)
        # the decode loop's stop test synchronizes every step, so the LM's
        # work is done when it returns
        lm_s = time.perf_counter() - t0
        count = count.long()
        gen = torch.clamp(out.long(), min=0)  # -1 pads -> 0, masked by length
        ptoks = torch.as_tensor(np.asarray(prompt_tokens), device=dev).long()
        ptl = torch.as_tensor(np.asarray(prompt_tok_len), device=dev).long()
        pfl = torch.as_tensor(np.asarray(prompt_feat_len), device=dev).long()
        b, p_max = ptoks.shape
        # position j of row i holds prompt_tokens[i, j] while j <
        # prompt_tok_len[i], else gen[i, j - prompt_tok_len[i]]
        j = torch.arange(p_max + gen.shape[1], device=dev)[None].expand(b, -1)
        pv = torch.gather(ptoks, 1, torch.clamp(j, max=p_max - 1))
        gv = torch.gather(gen, 1, torch.clamp(j - ptl[:, None], 0,
                                              gen.shape[1] - 1))
        compact = torch.where(j < ptl[:, None], pv, gv)
        feat = flow_inference_batched(
            self.flow, compact, ptl + count, prompt_feat, pfl,
            torch.as_tensor(flow_emb, device=dev), self.noise, device=dev)
        wav = self.decode(feat).reshape(b, -1)
        spf = SAMPLES_PER_FRAME
        gen_samples = min(cfg.max_speech_tokens * cfg.token_latent_ratio
                          * spf, wav.shape[1])
        start = torch.clamp(pfl * spf, 0, wav.shape[1] - gen_samples)
        wav = torch.gather(wav, 1, start[:, None] + torch.arange(
            gen_samples, device=dev)[None])
        pcm = torch.clamp(wav * 32767.0, -32768.0, 32767.0).to(torch.int16)
        return pcm.cpu().numpy(), count.cpu().numpy(), lm_s
