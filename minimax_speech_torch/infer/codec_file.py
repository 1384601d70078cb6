"""The `.dacz` codec artifact and chunked compress/decompress.

Port of minimax_speech_tpu/infer/codec_file.py around the port's DAC-VAE:
  * the "codes" are the encoder's mu latents, stored float16 (the VAE has
    no discrete quantizer);
  * chunking is overlap-crop: each window is encoded with `overlap`
    samples of context on both sides, more than the conv stack's
    receptive field, and only its centre latents are kept, so the chunked
    latents equal a full-signal encode up to float noise, one window
    shape for every chunk;
  * loudness is an unweighted BS.1770-style energy measure; compress
    normalizes to it and decompress restores it.

Artifact (np.save of a dict, suffix .dacz), shared with the JAX package:
a file written by either decodes in the other.
  {"latents": float16 (T_lat, D), "metadata": {original_length,
   input_db, sample_rate, chunk_length, channels, version}}
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from minimax_speech_torch.data.pipeline import linear_resample
from minimax_speech_torch.utils.device import module_device

VERSION = "minimax-speech-tpu-dacvae-1.0"


def loudness_db(audio: np.ndarray) -> float:
    """Unweighted BS.1770-style program loudness in dB."""
    energy = float(np.mean(np.square(audio, dtype=np.float64)))
    return -0.691 + 10.0 * math.log10(max(energy, 1e-12))


@dataclass
class DACVAEFile:
    """The compressed-latent artifact."""
    latents: np.ndarray          # (T_lat, D) float16
    original_length: int
    input_db: float
    sample_rate: int
    chunk_length: int            # latent frames per compressed chunk
    channels: int = 1
    version: str = VERSION

    def save(self, path) -> Path:
        path = Path(path).with_suffix(".dacz")
        artifacts = {
            "latents": self.latents.astype(np.float16),
            "metadata": {
                "original_length": int(self.original_length),
                "input_db": float(self.input_db),
                "sample_rate": int(self.sample_rate),
                "chunk_length": int(self.chunk_length),
                "channels": int(self.channels),
                "version": self.version,
            },
        }
        with open(path, "wb") as f:
            np.save(f, artifacts, allow_pickle=True)
        return path

    @classmethod
    def load(cls, path) -> "DACVAEFile":
        """Read a .dacz (a pickled dict: load only files this program or
        the JAX package wrote)."""
        artifacts = np.load(path, allow_pickle=True)[()]
        meta = artifacts["metadata"]
        if meta.get("version") != VERSION:
            raise RuntimeError(f"{path}: unsupported artifact version "
                               f"{meta.get('version')!r}")
        return cls(latents=artifacts["latents"],
                   original_length=meta["original_length"],
                   input_db=meta["input_db"],
                   sample_rate=meta["sample_rate"],
                   chunk_length=meta["chunk_length"],
                   channels=meta["channels"], version=meta["version"])


class DACVAECodec:
    """Chunked compress/decompress around a DACVAE on its device:
    `win_duration` seconds a chunk, `overlap` samples of context on each
    side (more than the receptive field: the default 1 s covers the
    (2, 3, 4, 4, 5)-stride stack's ~0.6 s)."""

    def __init__(self, model, model_sr: int = 24000,
                 win_duration: float = 5.0, overlap: int = 24000):
        self.model = model.eval()
        self.device = module_device(model)
        self.model_sr = model_sr
        self.hop = model.cfg.hop_length
        self.win = int(math.ceil(win_duration * model_sr / self.hop)) \
            * self.hop
        self.overlap = int(math.ceil(overlap / self.hop)) * self.hop
        self.ov_lat = self.overlap // self.hop
        self.win_lat = self.win // self.hop

    @torch.no_grad()
    def encode_mu(self, audio: np.ndarray) -> np.ndarray:
        """(T,) float audio, T a multiple of the hop -> (T / hop, D) mu."""
        x = torch.as_tensor(audio, dtype=torch.float32, device=self.device)
        return self.model.encode(x[None, :, None])[1][0].cpu().numpy()

    @torch.no_grad()
    def decode(self, latents: np.ndarray) -> np.ndarray:
        """(T_lat, D) latents -> (T_lat * hop,) audio."""
        z = torch.as_tensor(latents, dtype=torch.float32, device=self.device)
        return self.model.decode(z[None]).reshape(-1).cpu().numpy()

    def compress(self, audio: np.ndarray, sample_rate: int,
                 normalize_db: float = -16.0) -> DACVAEFile:
        """(T,) mono float audio -> DACVAEFile."""
        original_length = len(audio)
        x = linear_resample(audio, sample_rate, self.model_sr)
        input_db = loudness_db(x)
        if normalize_db is not None:
            x = x * (10.0 ** ((normalize_db - input_db) / 20.0))
        peak = float(np.max(np.abs(x), initial=1e-9))
        if peak > 1.0:          # ensure_max_of_audio
            x = x / peak

        t = len(x)
        t_pad = int(math.ceil(max(t, 1) / self.win)) * self.win
        buf = np.zeros(self.overlap + t_pad + self.overlap, np.float32)
        buf[self.overlap: self.overlap + t] = x
        latents = np.concatenate([
            self.encode_mu(buf[s: s + self.win + 2 * self.overlap])[
                self.ov_lat: self.ov_lat + self.win_lat]
            for s in range(0, t_pad, self.win)], axis=0)
        n_lat = int(math.ceil(t / self.hop))
        return DACVAEFile(latents=latents[:n_lat].astype(np.float16),
                          original_length=original_length,
                          input_db=input_db, sample_rate=sample_rate,
                          chunk_length=self.win_lat)

    def decompress(self, obj) -> np.ndarray:
        """DACVAEFile (or its path) -> (original_length,) float audio at
        the artifact's sample rate."""
        if isinstance(obj, (str, Path)):
            obj = DACVAEFile.load(obj)
        lat = obj.latents.astype(np.float32)
        n_lat, d = lat.shape
        n_chunks = int(math.ceil(n_lat / self.win_lat))
        buf = np.zeros((self.ov_lat + n_chunks * self.win_lat + self.ov_lat,
                        d), np.float32)
        buf[self.ov_lat: self.ov_lat + n_lat] = lat
        wav = np.concatenate([
            self.decode(buf[s: s + self.win_lat + 2 * self.ov_lat])[
                self.overlap: self.overlap + self.win]
            for s in range(0, n_chunks * self.win_lat, self.win_lat)
        ])[: n_lat * self.hop]
        wav = wav * (10.0 ** ((obj.input_db - loudness_db(wav)) / 20.0))
        wav = linear_resample(wav, self.model_sr, obj.sample_rate)
        return wav[: obj.original_length]
