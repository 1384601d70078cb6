"""The top-level TTS API, CosyVoice2's surface.

Port of minimax_speech_tpu/infer/api.py, both output modes:
  * inference_zero_shot(tts_text, prompt_text, prompt_speech_16k)
  * inference_cross_lingual(tts_text, prompt_speech_16k)
  * inference_instruct2(tts_text, instruct_text, prompt_speech_16k)
  * inference_vc(source_speech_16k, prompt_speech_16k)
  * the speaker cache: add_zero_shot_spk, save_spkinfo, load_spkinfo

Every method is a generator of {'tts_speech': np.ndarray (1, T)}, the
per-chunk RTF logged. A model_dir holds {llm,flow,codec,s3}.npz in the
JAX package's format and, optionally, config.yaml and campplus.onnx.
With CAM++ weights (campplus=, or that campplus.onnx) and the flow's
speaker encoder off (flow.use_speaker_encoder false), the speaker
conditioning is the prompt's CAM++ x-vector (models/campplus.py,
ops/kaldi_fbank.py): the flow takes it unit-normed, the LM through
project_xvector.
"""
from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Generator, Optional

import numpy as np
import torch

from minimax_speech_torch import config as cfg_lib
from minimax_speech_torch.data.pipeline import linear_resample
from minimax_speech_torch.infer.frontend import Frontend
from minimax_speech_torch.infer.pipeline import TTSPipeline, next_bucket
from minimax_speech_torch.infer.session import StreamingSession
from minimax_speech_torch.models.campplus import load_campplus, xvector
from minimax_speech_torch.models.flow import flow_inference
from minimax_speech_torch.utils.params_io import load_params


class TTS:
    """The CosyVoice2-style entry object, on CUDA unless device names
    another. model_dir: converted weights (and config.yaml); pipeline: an
    already built TTSPipeline (random weights in tests)."""

    def __init__(self, model_dir: Optional[str] = None,
                 pipeline: Optional[TTSPipeline] = None,
                 tokenizer_path: Optional[str] = None,
                 config: str = "configs/default.yaml",
                 campplus: Optional[str] = None, device=None):
        if pipeline is None:
            d = Path(model_dir)
            cfg_file = d / "config.yaml"
            cfg = cfg_lib.load_tts_config(cfg_file if cfg_file.exists()
                                          else config)
            pipeline = TTSPipeline.from_flax(
                cfg, *(load_params(d / f"{n}.npz")
                       for n in ("llm", "flow", "codec", "s3")),
                device=device)
            if campplus is None and (d / "campplus.onnx").exists():
                campplus = str(d / "campplus.onnx")
        self.pipeline = pipeline
        self.cfg = pipeline.cfg
        self.sample_rate = self.cfg.sample_rate
        self.frontend = Frontend(tokenizer_path)
        self.spk2info: dict[str, dict] = {}
        self._stream_sess: Optional[StreamingSession] = None
        self._campplus = None if campplus is None else load_campplus(
            campplus, device=pipeline.device)

    def xvector(self, prompt_speech_16k: np.ndarray) -> np.ndarray:
        """(T,) 16 kHz audio -> (1, 192) CAM++ x-vector."""
        return xvector(self._campplus, torch.as_tensor(
            np.asarray(prompt_speech_16k, np.float32),
            device=self.pipeline.device)).cpu().numpy()

    # -- the speaker cache -----------------------------------------------------
    def add_zero_shot_spk(self, prompt_text: str,
                          prompt_speech_16k: np.ndarray, spk_id: str) -> bool:
        self.spk2info[spk_id] = self._prompt_features(prompt_speech_16k,
                                                      prompt_text)
        return True

    def save_spkinfo(self, path: str = "spk2info.npz"):
        flat = {}
        for sid, info in self.spk2info.items():
            for k, v in info.items():
                flat[f"{sid}||{k}"] = np.asarray(v)
        np.savez(path, **flat)

    def load_spkinfo(self, path: str):
        data = np.load(path, allow_pickle=False)
        for key in data.files:
            sid, k = key.split("||")
            self.spk2info.setdefault(sid, {})[k] = data[key]

    def list_available_spks(self):
        return list(self.spk2info)

    # -- prompt features -------------------------------------------------------
    def _prompt_features(self, prompt_speech_16k: np.ndarray,
                         prompt_text: str = "") -> dict:
        """Host numpy arrays: prompt tokens, the flow's prompt features
        (latents, or the mel in mel mode), the LM's (1, C) and the flow's
        (1, 192) speaker conditioning, prompt text tokens."""
        p = self.pipeline
        audio24 = linear_resample(prompt_speech_16k, 16000, 24000)
        if self._campplus is not None \
                and not self.cfg.flow.use_speaker_encoder:
            xv = self.xvector(prompt_speech_16k)
            flow_emb = torch.as_tensor(
                xv / max(float(np.linalg.norm(xv)), 1e-12), device=p.device)
            with torch.no_grad():
                lm_spk = p.lm.project_xvector(flow_emb.to(
                    next(p.lm.parameters()).dtype))
        else:
            lm_spk, flow_emb = p.speaker_embedding(
                p.extract_prompt_mel(audio24))
        return {"prompt_tokens": p.extract_prompt_tokens(
                    prompt_speech_16k.astype(np.float32)),
                "prompt_feat": p.extract_prompt_feat(audio24),
                "lm_spk": lm_spk.float().cpu().numpy(),
                "flow_emb": flow_emb.float().cpu().numpy(),
                "prompt_text_tokens": (
                    self.frontend.extract_text_tokens(prompt_text)
                    if prompt_text else np.zeros((0,), np.int32))}

    def _conditioning(self, info: dict):
        """The speaker conditioning on the pipeline's device, the LM's in
        the LM's dtype."""
        p = self.pipeline
        lm_dtype = next(p.lm.parameters()).dtype
        return (torch.as_tensor(np.asarray(info["lm_spk"]), device=p.device)
                .to(lm_dtype),
                torch.as_tensor(np.asarray(info["flow_emb"]),
                                device=p.device))

    # -- synthesis -------------------------------------------------------------
    def _tts(self, text_pieces, info: dict, stream: bool, speed: float,
             seed: int) -> Generator[dict, None, None]:
        p = self.pipeline
        # one generator for the call: each piece draws fresh noise, and the
        # whole call is reproducible from the seed
        gen = torch.Generator(device=p.device).manual_seed(seed)
        lm_spk, flow_emb = self._conditioning(info)
        for piece in text_pieces:
            text_tokens = self.frontend.extract_text_tokens(piece)
            start = time.time()
            if stream:
                if self._stream_sess is None:
                    self._stream_sess = StreamingSession(p)
                for chunk in self._stream_sess.synthesize_stream(
                        text_tokens, info["prompt_text_tokens"],
                        info["prompt_tokens"], info["prompt_feat"], lm_spk,
                        flow_emb, generator=gen):
                    wav = _speed_change(chunk.audio, speed)
                    dur = len(wav) / self.sample_rate
                    logging.info("yield speech len %.2f, rtf %.4f", dur,
                                 (time.time() - start) / max(dur, 1e-9))
                    yield {"tts_speech": wav[None, :]}
                    start = time.time()
            else:
                wav = _speed_change(p.synthesize_fused(
                    text_tokens, info["prompt_text_tokens"],
                    info["prompt_tokens"], info["prompt_feat"], lm_spk,
                    flow_emb, generator=gen), speed)
                dur = len(wav) / self.sample_rate
                logging.info("yield speech len %.2f, rtf %.4f", dur,
                             (time.time() - start) / max(dur, 1e-9))
                yield {"tts_speech": wav[None, :]}

    def inference_zero_shot(self, tts_text: str, prompt_text: str,
                            prompt_speech_16k: np.ndarray,
                            zero_shot_spk_id: str = "", stream: bool = False,
                            speed: float = 1.0, seed: int = 0):
        prompt_text_n = self.frontend.text_normalize(prompt_text,
                                                     split=False)[0]
        info = (self.spk2info[zero_shot_spk_id] if zero_shot_spk_id
                else self._prompt_features(prompt_speech_16k, prompt_text_n))
        pieces = self.frontend.text_normalize(tts_text, split=True)
        yield from self._tts(pieces, info, stream, speed, seed)

    def inference_cross_lingual(self, tts_text: str,
                                prompt_speech_16k: np.ndarray,
                                zero_shot_spk_id: str = "",
                                stream: bool = False, speed: float = 1.0,
                                seed: int = 0):
        """Zero-shot without the prompt transcript."""
        info = (self.spk2info[zero_shot_spk_id] if zero_shot_spk_id
                else self._prompt_features(prompt_speech_16k))
        info = {**info, "prompt_text_tokens": np.zeros((0,), np.int32)}
        pieces = self.frontend.text_normalize(tts_text, split=True)
        yield from self._tts(pieces, info, stream, speed, seed)

    def inference_instruct2(self, tts_text: str, instruct_text: str,
                            prompt_speech_16k: np.ndarray,
                            zero_shot_spk_id: str = "", stream: bool = False,
                            speed: float = 1.0, seed: int = 0):
        """Instructed synthesis: the instruction, ended by
        <|endofprompt|>, takes the transcript's place, and the prompt's
        speech tokens leave the LM context (the flow keeps its prompt)."""
        info = (self.spk2info[zero_shot_spk_id] if zero_shot_spk_id
                else self._prompt_features(prompt_speech_16k))
        info = {**info,
                "prompt_text_tokens": self.frontend.extract_text_tokens(
                    instruct_text + "<|endofprompt|>"),
                "prompt_tokens": np.zeros((0,), np.int32)}
        pieces = self.frontend.text_normalize(tts_text, split=True)
        yield from self._tts(pieces, info, stream, speed, seed)

    @torch.no_grad()
    def inference_vc(self, source_speech_16k: np.ndarray,
                     prompt_speech_16k: np.ndarray, stream: bool = False,
                     speed: float = 1.0, seed: int = 0):
        """Voice conversion: the source's speech tokens drive the flow
        with the prompt speaker's conditioning; no LM. One chunk, as the
        JAX package gives it, stream or not."""
        p = self.pipeline
        info = self._prompt_features(prompt_speech_16k)
        source_tokens = p.extract_prompt_tokens(
            source_speech_16k.astype(np.float32))
        start = time.time()
        all_tokens = np.concatenate([info["prompt_tokens"], source_tokens])
        buf = np.zeros((1, next_bucket(len(all_tokens))), np.int64)
        buf[0, : len(all_tokens)] = all_tokens
        feat = flow_inference(p.flow, buf, [len(all_tokens)],
                              info["prompt_feat"][None].astype(np.float32),
                              self._conditioning(info)[1], p.noise,
                              device=p.device)
        n_frames = len(source_tokens) * self.cfg.token_latent_ratio
        wav = p.decode(feat[:, :n_frames]).reshape(-1)
        wav = _speed_change(wav.cpu().numpy(), speed)
        dur = len(wav) / self.sample_rate
        logging.info("yield speech len %.2f, rtf %.4f", dur,
                     (time.time() - start) / max(dur, 1e-9))
        yield {"tts_speech": wav[None, :]}


def _speed_change(wav: np.ndarray, speed: float) -> np.ndarray:
    """Speed change by linear resampling."""
    if speed == 1.0:
        return wav
    n = int(round(len(wav) / speed))
    return np.interp(np.linspace(0, 1, n, endpoint=False),
                     np.linspace(0, 1, len(wav), endpoint=False),
                     wav).astype(np.float32)
