"""Mel frontends: whisper log-mel (16 kHz, S3 tokenizer input) on tensors,
HiFi-GAN log-mel (24 kHz, flow and vocoder features) on tensors
(differentiable: HiFT's generator loss backpropagates through it) and on
the host in numpy; the STFT magnitude of the spectral discriminators;
framing and the inverse STFT of the HiFT vocoder's head.

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


def frame_signal(x: torch.Tensor, frame_length: int,
                 hop: int) -> torch.Tensor:
    """(..., T) -> (..., 1 + (T - frame_length) // hop, frame_length), the
    frames starting every `hop` samples (a strided view)."""
    return x.unfold(-1, frame_length, hop)


def istft(real: torch.Tensor, imag: torch.Tensor, n_fft: int, hop: int,
          length: int | None = None) -> torch.Tensor:
    """Inverse STFT as torch.istft computes it with center=True and a
    periodic Hann window of n_fft: real/imag (..., n_fft//2 + 1, frames)
    -> (..., n_fft + hop (frames - 1) - 2 (n_fft//2)) samples, or the
    first `length`. Each frame's irfft, windowed, is overlap-added
    (F.fold, which sums without atomics on the card), divided by the
    overlap-added squared window (NOLA, floored at 1e-11), and n_fft//2
    samples are trimmed from both ends. The imaginary parts of the DC
    and Nyquist bins are set to 0 before the irfft, which is what a
    real inverse transform of a Hermitian spectrum reads (numpy's and
    pocketfft's irfft ignore them; cuFFT's is not specified for them)."""
    win = hann_window(n_fft, real.dtype, real.device)
    imag = torch.cat([torch.zeros_like(imag[..., :1, :]), imag[..., 1:-1, :],
                      torch.zeros_like(imag[..., -1:, :])], dim=-2)
    frames = torch.fft.irfft(torch.complex(real, imag).transpose(-1, -2),
                             n=n_fft, dim=-1) * win  # (..., frames, n_fft)
    lead, num_frames = frames.shape[:-2], frames.shape[-2]
    out_len = n_fft + hop * (num_frames - 1)
    cols = frames.reshape(-1, num_frames, n_fft).transpose(1, 2)
    out = F.fold(cols, (1, out_len), (1, n_fft), stride=(1, hop))
    wsq = F.fold((win ** 2)[None, :, None].expand(1, n_fft, num_frames),
                 (1, out_len), (1, n_fft), stride=(1, hop))
    out = (out / torch.clamp(wsq, min=1e-11)).reshape(-1, out_len)
    out = out[:, n_fft // 2: out_len - n_fft // 2]
    if length is not None:
        out = out[:, :length]
    return out.reshape(lead + out.shape[-1:])


def reflect_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    """(..., T) -> (..., T + 2p), reflected at both ends as np.pad and
    jnp.pad's mode="reflect" do: repeatedly where p >= T (F.pad takes
    only p < T)."""
    n = x.shape[-1]
    if p < n:
        lead = x.shape[:-1]
        return F.pad(x.reshape(-1, 1, n), (p, p),
                     mode="reflect").reshape(lead + (n + 2 * p,))
    period = 2 * (n - 1)
    idx = np.arange(-p, n + p) % period
    idx = np.where(idx >= n, period - idx, idx)
    return x[..., torch.as_tensor(idx, device=x.device)]


def stft(x: torch.Tensor, n_fft: int, hop: int, win_length: int | None = None,
         pad: int | None = None) -> torch.Tensor:
    """(..., T) -> complex STFT (..., frames, 1 + n_fft//2): reflect-pad
    `pad` samples each side (default n_fft//2, centered), frames of n_fft
    every hop, a periodic Hann window of win_length (default n_fft),
    zero-padded in the middle to n_fft when shorter."""
    p = n_fft // 2 if pad is None else pad
    win_length = win_length or n_fft
    lead = x.shape[:-1]
    flat = x.reshape(-1, x.shape[-1])
    if p > 0:
        flat = reflect_pad(flat, p)
    win = hann_window(win_length, x.dtype, x.device)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        win = F.pad(win, (lpad, n_fft - win_length - lpad))
    spec = torch.fft.rfft(flat.unfold(-1, n_fft, hop) * win, n=n_fft, dim=-1)
    return spec.reshape(lead + spec.shape[-2:])


def stft_magnitude(x: torch.Tensor, n_fft: int, hop: int, win_length: int,
                   center: bool = True, pad: int | None = None,
                   power: float = 2.0, eps: float = 0.0) -> torch.Tensor:
    """(..., T) -> (..., frames, 1 + n_fft//2): |STFT|^2 when power is 2,
    else (|STFT|^2 + eps)^(power / 2). Reflect-pads n_fft//2 each side
    with center (`pad` instead when given), `pad` or nothing without."""
    p = (n_fft // 2 if center else 0) if pad is None else pad
    spec = stft(x, n_fft, hop, win_length, p)
    mag2 = spec.real ** 2 + spec.imag ** 2
    if power == 2.0:
        return mag2
    return torch.pow(mag2 + eps, power / 2.0)


def whisper_log_mel(audio: torch.Tensor, n_mels: int = 128, sr: int = 16000,
                    n_fft: int = 400, hop: int = 160) -> torch.Tensor:
    """(..., T) 16 kHz audio -> (..., n_mels, frames) whisper log-mel:
    centered power STFT without its last frame, Slaney mel, log10 clamped
    at 1e-10, an 8-unit floor under the per-example max, (x + 4) / 4."""
    mag = stft_magnitude(audio.float(), n_fft, hop, n_fft)[..., :-1, :]
    filters = torch.as_tensor(mel_filterbank(sr, n_fft, n_mels),
                              device=audio.device)
    mel = torch.einsum("mf,...tf->...mt", filters, mag)
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    floor = log_spec.amax(dim=(-2, -1), keepdim=True) - 8.0
    log_spec = torch.maximum(log_spec, floor)
    return (log_spec + 4.0) / 4.0


def hifigan_log_mel(audio: torch.Tensor, n_fft: int = 1920, n_mels: int = 80,
                    sr: int = 24000, hop: int = 480, win_length: int = 1920,
                    fmin: float = 0.0,
                    fmax: float | None = 8000.0) -> torch.Tensor:
    """(..., T) 24 kHz audio -> (..., n_mels, frames), differentiable:
    reflect-pad (n_fft - hop)/2, uncentered STFT, sqrt(|S|^2 + 1e-9),
    mel, ln(clamp(x, 1e-5)). hifigan_log_mel_np computes the same on the
    host."""
    mag = stft_magnitude(audio, n_fft, hop, win_length, center=False,
                         pad=(n_fft - hop) // 2, power=2.0)
    mag = torch.sqrt(mag + 1e-9)
    filters = torch.as_tensor(mel_filterbank(sr, n_fft, n_mels, fmin, fmax),
                              dtype=mag.dtype, device=mag.device)
    mel = torch.einsum("mf,...tf->...mt", filters, mag)
    return torch.log(torch.clamp(mel, min=1e-5))


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
