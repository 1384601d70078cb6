"""Audio-folder dataset of codec and vocoder training.

Port of minimax_speech_tpu/data/audio_folder.py: every *.wav under the
roots (sorted), fixed-duration random crops from random.Random(seed),
peak normalization of a crop whose peak is above 1 (to 0.95), and an
endless batch stream. Files are decoded by data/native_loader.py's
batch_load, resampled to the sample rate; if it raises, by
pipeline._load_audio and a linear resample.
"""
from __future__ import annotations

import random
from pathlib import Path
from typing import Iterator

import numpy as np

from minimax_speech_torch.data import native_loader
from minimax_speech_torch.data.pipeline import _load_audio, linear_resample


class AudioFolder:
    def __init__(self, roots: list[str] | str, duration: float = 0.38,
                 sample_rate: int = 24000, normalize: bool = True,
                 seed: int = 0, use_native: bool = True):
        roots = [roots] if isinstance(roots, str) else roots
        self.files = sorted(f for r in roots for f in Path(r).rglob("*.wav"))
        if not self.files:
            raise ValueError(f"no wavs under {roots}")
        self.duration = duration
        self.sample_rate = sample_rate
        self.normalize = normalize
        self.rng = random.Random(seed)
        self.use_native = use_native

    def __len__(self):
        return len(self.files)

    def _load(self, paths):
        if self.use_native:
            try:
                return native_loader.batch_load([str(p) for p in paths],
                                                target_sr=self.sample_rate)
            except Exception:  # noqa: BLE001 - any failure: the plain reader
                pass
        out = []
        for p in paths:
            audio, sr = _load_audio(str(p))
            if sr != self.sample_rate:
                audio = linear_resample(audio, sr, self.sample_rate)
            out.append((audio, self.sample_rate))
        return out

    def sample_batch(self, batch_size: int) -> np.ndarray:
        """(batch_size, int(duration * sample_rate)) random crops; a file
        shorter than a crop is zero-padded."""
        n = int(self.duration * self.sample_rate)
        paths = [self.rng.choice(self.files) for _ in range(batch_size)]
        out = np.zeros((batch_size, n), np.float32)
        for i, (audio, _) in enumerate(self._load(paths)):
            if len(audio) >= n:
                start = self.rng.randint(0, len(audio) - n)
                crop = audio[start: start + n]
            else:
                crop = np.pad(audio, (0, n - len(audio)))
            if self.normalize:
                peak = np.abs(crop).max()
                if peak > 1.0:
                    crop = crop / peak * 0.95
            out[i] = crop
        return out

    def infinite_batches(self, batch_size: int) -> Iterator[np.ndarray]:
        while True:
            yield self.sample_batch(batch_size)
