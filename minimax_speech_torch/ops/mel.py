"""Mel frontends: whisper log-mel (16 kHz, S3 tokenizer input) on tensors,
HiFi-GAN log-mel (24 kHz, speaker-encoder input) on the host in numpy.

Port of minimax_speech_tpu/ops/mel.py. Framing, padding, window and
filterbank are copied from it rather than taken from torch.stft's
defaults, so both packages frame the same samples.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def _hz_to_mel_slaney(freqs: np.ndarray) -> np.ndarray:
    freqs = np.asanyarray(freqs, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = freqs / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = freqs >= min_log_hz
    return np.where(log_t, min_log_mel + np.log(
        np.maximum(freqs, 1e-10) / min_log_hz) / logstep, mels)


def _mel_to_hz_slaney(mels: np.ndarray) -> np.ndarray:
    mels = np.asanyarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = mels >= min_log_mel
    return np.where(log_t, min_log_hz * np.exp(logstep * (mels - min_log_mel)),
                    freqs)


@functools.lru_cache(maxsize=None)
def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: float | None = None) -> np.ndarray:
    """Slaney-scale, Slaney-normalized filterbank (n_mels, 1 + n_fft//2)
    (librosa.filters.mel defaults). Cached; treat the result as
    read-only."""
    if fmax is None:
        fmax = sr / 2.0
    fft_freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2, dtype=np.float64)
    mel_pts = np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax),
                          n_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def hann_window(win_length: int, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """Periodic Hann window."""
    n = torch.arange(win_length, dtype=dtype, device=device)
    return 0.5 - 0.5 * torch.cos(2.0 * torch.pi * n / win_length)


def stft_power(x: torch.Tensor, n_fft: int, hop: int,
               pad: int) -> torch.Tensor:
    """(..., T) -> |STFT|^2 (..., frames, 1 + n_fft//2): reflect-pad `pad`
    samples each side, frames of n_fft every hop, periodic Hann window."""
    lead = x.shape[:-1]
    flat = x.reshape(-1, x.shape[-1])
    if pad > 0:
        flat = F.pad(flat, (pad, pad), mode="reflect")
    frames = flat.unfold(-1, n_fft, hop)
    spec = torch.fft.rfft(frames * hann_window(n_fft, x.dtype, x.device),
                          n=n_fft, dim=-1)
    mag2 = spec.real ** 2 + spec.imag ** 2
    return mag2.reshape(lead + mag2.shape[-2:])


def whisper_log_mel(audio: torch.Tensor, n_mels: int = 128, sr: int = 16000,
                    n_fft: int = 400, hop: int = 160) -> torch.Tensor:
    """(..., T) 16 kHz audio -> (..., n_mels, frames) whisper log-mel:
    centered power STFT without its last frame, Slaney mel, log10 clamped
    at 1e-10, an 8-unit floor under the per-example max, (x + 4) / 4."""
    mag = stft_power(audio.float(), n_fft, hop, n_fft // 2)[..., :-1, :]
    filters = torch.as_tensor(mel_filterbank(sr, n_fft, n_mels),
                              device=audio.device)
    mel = torch.einsum("mf,...tf->...mt", filters, mag)
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    floor = log_spec.amax(dim=(-2, -1), keepdim=True) - 8.0
    log_spec = torch.maximum(log_spec, floor)
    return (log_spec + 4.0) / 4.0


def hifigan_log_mel_np(audio: np.ndarray, n_fft: int = 1920,
                       n_mels: int = 80, sr: int = 24000, hop: int = 480,
                       win_length: int = 1920, fmin: float = 0.0,
                       fmax: float | None = 8000.0) -> np.ndarray:
    """(..., T) 24 kHz audio -> (..., n_mels, frames) on the host:
    reflect-pad (n_fft - hop)/2, uncentered STFT, sqrt(|S|^2 + 1e-9),
    mel, ln(clamp(x, 1e-5))."""
    x = np.asarray(audio, np.float32)
    p = (n_fft - hop) // 2
    x = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(p, p)], mode="reflect")
    num_frames = 1 + (x.shape[-1] - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(num_frames)[:, None]
    frames = x[..., idx]
    n = np.arange(win_length, dtype=np.float32)
    win = (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(
        np.float32)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        win = np.pad(win, (lpad, n_fft - win_length - lpad))
    spec = np.fft.rfft(frames * win, n=n_fft, axis=-1)
    mag = np.sqrt((spec.real ** 2 + spec.imag ** 2 + 1e-9).astype(np.float32))
    filters = mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
    mel = np.einsum("mf,...tf->...mt", filters, mag)
    return np.log(np.maximum(mel, 1e-5))
