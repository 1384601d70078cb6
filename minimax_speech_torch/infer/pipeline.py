"""Zero-shot TTS pipeline: text + prompt audio -> 24 kHz int16 PCM.

Port of minimax_speech_tpu/infer/pipeline.py, latent output mode
(DAC-VAE vocoder):

  1. prompt audio 16 kHz -> whisper log-mel -> S3 FSQ tokens
  2. prompt audio 24 kHz -> DAC-VAE latents (flow prompt) and a host
     log-mel (speaker-encoder conditioning)
  3. SpeechLM RAS decode: text (+ prompt text) tokens -> FSQ tokens
  4. FlowModel: [prompt | generated] tokens -> latents (10-step CFG Euler)
  5. DAC-VAE decode -> trimmed int16 PCM, cut on the device

Everything runs on one device, CUDA unless the caller passes
device="cpu". `synthesize_fused` copies to the host once, at the end.
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
                                              flow_inference_batched)
from minimax_speech_torch.ops import mel as mel_ops
from minimax_speech_torch.utils import params_io
from minimax_speech_torch.utils.device import resolve_device

SAMPLES_PER_FRAME = 480  # 24 kHz samples per 50 Hz latent frame


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
    output_type: str = "latent"       # only 'latent' (DAC) is ported
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
    noise table."""

    def __init__(self, cfg: TTSConfig, device=None):
        if cfg.output_type != "latent":
            raise NotImplementedError(
                f"output_type={cfg.output_type!r}: only 'latent' is ported")
        self.cfg = cfg
        self.device = resolve_device(device)
        with torch.device(self.device):
            self.lm = llm_mod.SpeechLM(cfg.lm).eval()
            self.flow = FlowModel(cfg.flow).eval()
            self.dac = dac_vae.DACVAE(cfg.dac).eval()
            self.s3 = s3.S3TokenizerV2(cfg.s3).eval()
        self.noise = torch.as_tensor(cfm_mod.make_fixed_noise(
            15000, cfg.flow.output_size)[None], device=self.device)

    def models(self):
        return {"lm": self.lm, "flow": self.flow, "codec": self.dac,
                "s3": self.s3}

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
        from its params_io.load_params)."""
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
        return self.dac.encode(a)[0].cpu().numpy()

    @torch.no_grad()
    def speaker_embedding(self, prompt_mel: np.ndarray):
        """(T, 80) reference mel -> conditioning for the LM (projected,
        (1, C)) and the flow (192-d, (1, 192)), on the device."""
        mel = torch.as_tensor(np.asarray(prompt_mel, np.float32),
                              device=self.device)[None]
        return self.lm.embed_speaker(mel), self.flow.embed_speaker(mel)

    # -- synthesis ------------------------------------------------------------
    @torch.no_grad()
    def synthesize_fused(self, text_tokens: np.ndarray,
                         prompt_text_tokens: np.ndarray,
                         prompt_speech_tokens: np.ndarray,
                         prompt_feat: np.ndarray, lm_spk, flow_emb,
                         generator: torch.Generator | None = None,
                         gumbel_top=None, gumbel_fallback=None,
                         return_timings: bool = False):
        """One utterance: LM decode -> flow -> DAC decode -> trim -> int16,
        on the device, one copy to the host at the end. prompt_feat:
        (Tp, 80) latents. The decode noise is `gumbel_top` /
        `gumbel_fallback` (see llm.generate), else drawn from
        `generator`. Returns float32 audio (PCM / 32767)."""
        cfg = self.cfg
        dev = self.device
        t0 = time.perf_counter()

        n_prompt = len(prompt_speech_tokens)
        pt_pad = next_bucket(n_prompt, buckets=(16, 32, 64, 128, 256))
        ptoks = np.zeros((1, pt_pad), np.int64)
        ptoks[0, :n_prompt] = prompt_speech_tokens
        pf_pad = next_bucket(prompt_feat.shape[0],
                             buckets=(16, 32, 64, 128, 256, 512))
        pf = np.zeros((1, pf_pad, cfg.flow.output_size), np.float32)
        pf[0, : prompt_feat.shape[0]] = prompt_feat
        pfl = prompt_feat.shape[0]

        src, tok, plen, min_len, max_len = decode_plan(
            cfg, text_tokens, prompt_text_tokens, prompt_speech_tokens)
        out, count = llm_mod.generate(
            self.lm, src, tok, plen, lm_spk, min_len, max_len,
            max_steps=cfg.max_speech_tokens, gumbel_top=gumbel_top,
            gumbel_fallback=gumbel_fallback, generator=generator,
            device=dev)
        # the decode loop's stop test synchronizes every step, so the LM's
        # work is done when it returns
        t_lm = time.perf_counter()
        count = count.long()
        gen = torch.clamp(out.long(), min=0)  # -1 pads -> 0, masked by length
        # compact [prompt | generated]: position j holds the prompt token
        # while j < n_prompt, else gen[j - n_prompt]
        prompt_tok = torch.as_tensor(ptoks, device=dev)
        prompt_len = torch.tensor([n_prompt], device=dev)
        j = torch.arange(pt_pad + gen.shape[1], device=dev)[None]
        pv = torch.gather(prompt_tok, 1,
                          torch.clamp(j, max=pt_pad - 1).expand(1, -1))
        gi = torch.clamp(j - prompt_len[:, None], 0, gen.shape[1] - 1)
        gv = torch.gather(gen, 1, gi)
        compact = torch.where(j < prompt_len[:, None], pv, gv)
        feat = flow_inference_batched(
            self.flow, compact, prompt_len + count,
            torch.as_tensor(pf, device=dev), torch.tensor([pfl], device=dev),
            flow_emb, self.noise, device=dev)
        wav = self.dac.decode(feat.float()).reshape(1, -1)
        # trim on the device: each row's own prompt region is cut
        spf = SAMPLES_PER_FRAME
        gen_samples = min(cfg.max_speech_tokens * cfg.token_latent_ratio
                          * spf, wav.shape[1])
        start = min(pfl * spf, wav.shape[1] - gen_samples)
        wav = wav[:, start: start + gen_samples]
        pcm = torch.clamp(wav * 32767.0, -32768.0, 32767.0).to(torch.int16)
        pcm, count = pcm.cpu().numpy(), count.cpu().numpy()
        n = int(count[0])
        wav = pcm[0, : n * cfg.token_latent_ratio * spf].astype(
            np.float32) / 32767.0
        t1 = time.perf_counter()
        if return_timings:
            return wav, {"total_s": t1 - t0, "lm_s": t_lm - t0, "tokens": n,
                         "audio_s": len(wav) / cfg.sample_rate}
        return wav
