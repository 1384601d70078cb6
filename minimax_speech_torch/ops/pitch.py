"""F0 estimation (YIN) on the host, for HiFT's f0 loss.

Port (a numpy copy) of minimax_speech_tpu/ops/pitch.py: difference
function -> cumulative mean normalized difference -> absolute threshold
-> parabolic interpolation, one frame every `hop` samples (480 at
24 kHz: the mel's 50 Hz).
"""
from __future__ import annotations

import numpy as np


def yin_f0(audio: np.ndarray, sr: int = 24000, hop: int = 480,
           frame_length: int = 1024, fmin: float = 60.0, fmax: float = 500.0,
           threshold: float = 0.15) -> np.ndarray:
    """(T,) audio -> (n_frames,) float32 f0 in Hz (0 = unvoiced)."""
    tau_min = max(int(sr / fmax), 2)
    tau_max = min(int(sr / fmin), frame_length - 1)
    n_frames = max(1 + (len(audio) - frame_length) // hop, 0)
    f0 = np.zeros(n_frames, np.float32)
    for i in range(n_frames):
        frame = audio[i * hop: i * hop + frame_length].astype(np.float64)
        # the difference function through the autocorrelation
        spec = np.fft.rfft(frame, 2 * frame_length)
        ac = np.fft.irfft(spec * np.conj(spec))[:frame_length]
        cum = np.cumsum(frame ** 2)
        energy = cum[-1] - np.concatenate([[0.0], cum[:-1]])
        if energy[0] < 1e-8:  # silent: unvoiced
            continue
        d = (energy[0] + energy - 2 * ac)[: tau_max + 1]
        cmndf = np.ones_like(d)
        running = np.cumsum(d[1:])
        cmndf[1:] = d[1:] * np.arange(1, len(d)) / np.maximum(running, 1e-12)
        region = cmndf[tau_min:tau_max]
        below = np.nonzero(region < threshold)[0]
        if len(below) == 0:
            tau = tau_min + int(np.argmin(region))
            if region.min() > 0.5:  # unvoiced
                continue
        else:
            tau = tau_min + int(below[0])
            while tau + 1 < tau_max and cmndf[tau + 1] < cmndf[tau]:
                tau += 1  # down to the local minimum
        if 1 <= tau < len(cmndf) - 1:  # parabolic interpolation
            a, b, c = cmndf[tau - 1], cmndf[tau], cmndf[tau + 1]
            denom = a - 2 * b + c
            shift = 0.5 * (a - c) / denom if abs(denom) > 1e-12 else 0.0
            tau_f = tau + float(np.clip(shift, -1, 1))
        else:
            tau_f = float(tau)
        f0[i] = sr / tau_f
    return f0
