"""Audio distance and intelligibility metrics of codec evaluation, on the
host.

Port of the numpy metrics of minimax_speech_tpu/utils/audio_metrics.py:
STOI (Taal et al. 2011, pystoi's constants), SI-SDR, waveform L1 and the
multi-scale mel distance. STOI resamples to 10 kHz with the polyphase
Kaiser-windowed sinc of utils/audio_signal.resample (the JAX package's
filter), here in float64 on the host. That filter's cutoff is rolloff /
(2 max(up, down)) input cycles per sample, `up` times below julius's:
from 24 kHz it passes 0-945 Hz (a 1 kHz tone comes out at 0.12, 1.5 kHz
at 3e-8), so STOI's upper six third-octave bands read the filter's
leakage, 46-80 dB down, where float32 rounding moves them; the port
keeps the JAX package's filter, so that both give the same metric. PESQ
and ViSQOL, which wrap external packages, are not ported.
"""
from __future__ import annotations

import numpy as np
import torch

from minimax_speech_torch.utils import audio_losses
from minimax_speech_torch.utils.audio_signal import resample

FS = 10000          # STOI's internal sample rate
N_FRAME = 256       # frame length (25.6 ms)
NFFT = 512
NUMBAND = 15        # one-third octave bands
MINFREQ = 150.0
N = 30              # analysis segment, in frames (384 ms)
BETA = -15.0        # lower SDR clip (dB)
DYN_RANGE = 40.0    # silent-frame removal range (dB)


def _resample(x: np.ndarray, sr: int, new_sr: int) -> np.ndarray:
    """(T,) -> round(T * new_sr / sr) samples, float64, through
    utils/audio_signal.resample."""
    if sr == new_sr:
        return x
    n = int(round(len(x) * new_sr / sr))
    return resample(torch.as_tensor(np.asarray(x, np.float64)), sr,
                    new_sr).numpy()[:n]


def _thirdoct(fs: int, nfft: int, num_bands: int, min_freq: float):
    """One-third octave band matrix (J, F)."""
    f = np.linspace(0, fs, nfft + 1)[: nfft // 2 + 1]
    cf = 2.0 ** (np.arange(num_bands, dtype=np.float64) / 3.0) * min_freq
    lo, hi = cf * 2 ** (-1.0 / 6.0), cf * 2 ** (1.0 / 6.0)
    obm = np.zeros((num_bands, len(f)))
    for i in range(num_bands):
        obm[i, np.argmin((f - lo[i]) ** 2): np.argmin((f - hi[i]) ** 2)] = 1.0
    return obm


def _frames(x: np.ndarray, flen: int, hop: int) -> np.ndarray:
    n = (len(x) - flen) // hop + 1
    if n <= 0:
        return np.zeros((0, flen))
    return x[np.arange(flen)[None, :] + hop * np.arange(n)[:, None]]


def _overlap_add(frames, flen: int, hop: int) -> np.ndarray:
    out = np.zeros((len(frames) - 1) * hop + flen if len(frames) else 0)
    for i, fr in enumerate(frames):
        out[i * hop: i * hop + flen] += fr
    return out


def _remove_silent_frames(x, y, dyn_range, flen, hop):
    w = np.hanning(flen + 2)[1:-1]
    xf, yf = _frames(x, flen, hop) * w, _frames(y, flen, hop) * w
    energies = 20 * np.log10(np.linalg.norm(xf, axis=1) + 1e-12)
    mask = energies > (energies.max() - dyn_range)
    return (_overlap_add(xf[mask], flen, hop),
            _overlap_add(yf[mask], flen, hop))


def stoi(reference: np.ndarray, estimate: np.ndarray, sr: int) -> float:
    """Short-Time Objective Intelligibility, about 0 to 1 (nan for less
    than one 384 ms segment of speech)."""
    x = _resample(np.asarray(reference, np.float64), sr, FS)
    y = _resample(np.asarray(estimate, np.float64), sr, FS)
    n = min(len(x), len(y))
    x, y = _remove_silent_frames(x[:n], y[:n], DYN_RANGE, N_FRAME,
                                 N_FRAME // 2)
    if len(x) < N_FRAME * 2:
        return float("nan")
    w = np.hanning(N_FRAME + 2)[1:-1]
    xs = np.abs(np.fft.rfft(_frames(x, N_FRAME, N_FRAME // 2) * w, NFFT,
                            axis=1)) ** 2
    ys = np.abs(np.fft.rfft(_frames(y, N_FRAME, N_FRAME // 2) * w, NFFT,
                            axis=1)) ** 2
    obm = _thirdoct(FS, NFFT, NUMBAND, MINFREQ)
    xb, yb = np.sqrt(xs @ obm.T), np.sqrt(ys @ obm.T)  # (T, J)
    if xb.shape[0] < N:
        return float("nan")
    d_sum, count = 0.0, 0
    for m in range(N, xb.shape[0] + 1):
        xseg, yseg = xb[m - N: m].T, yb[m - N: m].T   # (J, N)
        alpha = np.sqrt(np.sum(xseg ** 2, axis=1, keepdims=True)
                        / (np.sum(yseg ** 2, axis=1, keepdims=True) + 1e-12))
        yprim = np.minimum(yseg * alpha, xseg * (1 + 10 ** (-BETA / 20.0)))
        xn = xseg - xseg.mean(axis=1, keepdims=True)
        yn = yprim - yprim.mean(axis=1, keepdims=True)
        corr = np.sum(xn * yn, axis=1) / (
            np.linalg.norm(xn, axis=1) * np.linalg.norm(yn, axis=1) + 1e-12)
        d_sum += corr.sum()
        count += NUMBAND
    return float(d_sum / max(count, 1))


def si_sdr(reference: np.ndarray, estimate: np.ndarray) -> float:
    """Scale-invariant SDR in dB."""
    x = np.asarray(reference, np.float64)
    y = np.asarray(estimate, np.float64)
    n = min(len(x), len(y))
    x, y = x[:n] - x[:n].mean(), y[:n] - y[:n].mean()
    s = (np.dot(y, x) / (np.dot(x, x) + 1e-12)) * x
    e = y - s
    return float(10 * np.log10((np.dot(s, s) + 1e-12)
                               / (np.dot(e, e) + 1e-12)))


def l1_distance(reference: np.ndarray, estimate: np.ndarray) -> float:
    n = min(len(reference), len(estimate))
    return float(np.mean(np.abs(np.asarray(reference[:n])
                                - np.asarray(estimate[:n]))))


def mel_distance(reference: np.ndarray, estimate: np.ndarray,
                 sr: int = 24000) -> float:
    """The multi-scale log-mel L1 (audio_losses.mel_spectrogram_loss), in
    float32 on the CPU."""
    n = min(len(reference), len(estimate))
    x, y = (torch.as_tensor(np.asarray(a[:n], np.float32))[None]
            for a in (reference, estimate))
    return float(audio_losses.mel_spectrogram_loss(x, y, sr))
