"""Kaldi-compatible fbank features (torchaudio.compliance.kaldi.fbank).

Port of minimax_speech_tpu/ops/kaldi_fbank.py, the CAM++ x-vector's
input (80 bins, dither 0, 16 kHz), with kaldi's conventions:

  * snip_edges frames: 25 ms window, 10 ms shift, no padding;
  * per-frame DC removal, pre-emphasis 0.97 with the first sample
    replicated, the povey window (hann ** 0.85);
  * a 512-point rFFT, the power spectrum without its Nyquist column;
  * kaldi mel banks (mel = 1127 ln(1 + f/700), 20 Hz to Nyquist,
    triangles on the FFT-bin grid, no area normalisation);
  * the natural log, floored at float32's eps.

The tables are numpy (float64 math, stored float32); the framing and the
rest run on the audio's device.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def _mel(f):
    return 1127.0 * np.log(1.0 + f / 700.0)


@lru_cache(maxsize=None)
def _mel_banks(num_bins: int, fft: int, sr: int, low: float, high: float
               ) -> np.ndarray:
    """(num_bins, fft // 2) kaldi triangular mel weights: kaldi drops the
    Nyquist column."""
    if high <= 0:
        high = sr / 2.0 + high
    mel_low, mel_high = _mel(low), _mel(high)
    delta = (mel_high - mel_low) / (num_bins + 1)
    mel_f = _mel(np.arange(fft // 2) * (sr / fft))
    banks = np.zeros((num_bins, fft // 2), np.float64)
    for b in range(num_bins):
        l, c, r = (mel_low + d * delta for d in (b, b + 1, b + 2))
        up = (mel_f - l) / (c - l)
        down = (r - mel_f) / (r - c)
        banks[b] = np.clip(np.minimum(up, down), 0.0, None)
    return banks.astype(np.float32)


@lru_cache(maxsize=None)
def _povey_window(n: int) -> np.ndarray:
    a = 2 * np.pi / (n - 1)
    return ((0.5 - 0.5 * np.cos(a * np.arange(n))) ** 0.85).astype(np.float32)


def kaldi_fbank(audio: torch.Tensor, num_mel_bins: int = 80,
                sample_rate: int = 16000, frame_length_ms: float = 25.0,
                frame_shift_ms: float = 10.0, preemphasis: float = 0.97,
                low_freq: float = 20.0, high_freq: float = 0.0,
                ) -> torch.Tensor:
    """(T,) 16 kHz float waveform in [-1, 1] -> (frames, num_mel_bins),
    on the waveform's device. kaldi works on int16-scale samples: the
    features differ from torchaudio's by log(32768), which CAM++'s
    per-utterance mean subtraction cancels."""
    win = int(sample_rate * frame_length_ms / 1000.0)    # 400
    hop = int(sample_rate * frame_shift_ms / 1000.0)     # 160
    fft = 1
    while fft < win:
        fft *= 2                                         # 512
    num_frames = max(1 + (audio.shape[0] - win) // hop, 0)
    if num_frames == 0:  # shorter than a window (an empty FFT raises)
        return audio.new_zeros((0, num_mel_bins))
    frames = audio[:(num_frames - 1) * hop + win].unfold(0, win, hop)
    frames = frames - frames.mean(dim=1, keepdim=True)
    prev = torch.cat([frames[:, :1], frames[:, :-1]], dim=1)
    frames = frames - preemphasis * prev
    frames = frames * torch.as_tensor(_povey_window(win), device=audio.device)
    spec = torch.fft.rfft(frames, n=fft)
    power = (spec.real ** 2 + spec.imag ** 2)[:, : fft // 2]
    banks = torch.as_tensor(_mel_banks(num_mel_bins, fft, sample_rate,
                                       low_freq, high_freq),
                            device=audio.device)
    mel = power @ banks.T
    return torch.log(torch.clamp(mel, min=float(np.finfo(np.float32).eps)))
