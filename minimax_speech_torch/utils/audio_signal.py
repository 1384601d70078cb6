"""audiotools slice: AudioSignal, the BS.1770 loudness meter, resampling.

Port of minimax_speech_tpu/utils/audio_signal.py: the signal wraps a
(B, C, T) float32 tensor and every DSP method returns a new signal on
the same device (STFT and iSTFT, masks, gain, convolution, mixing, the
mel-band equalizer, sinc FIR filters, clipping and quantization,
resampling, the spectral gate). Only the K-weighting IIR of the loudness
meter runs on the host, through scipy's lfilter, as in the JAX package:
a recurrence over every sample, and loudness is metadata.

`resample` keeps the JAX package's Kaiser-windowed sinc, whose cutoff is
rolloff / (2 max(up, down)) input cycles per sample, `up` times below
julius's (ROADMAP.md section 3): utils/audio_metrics.py's STOI uses it
and agrees with JAX's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from minimax_speech_torch.ops import mel as mel_ops

MIN_LOUDNESS = -70.0


@dataclass(frozen=True)
class STFTParams:
    window_length: int = 2048
    hop_length: int = 512
    window_type: str = "hann"


# ------------------------------------------------------------------ resample
def _kaiser_sinc_kernel(orig_sr: int, new_sr: int, zeros: int = 24,
                        rolloff: float = 0.945):
    """(up, taps) windowed-sinc polyphase filters, up, down, half width."""
    g = math.gcd(orig_sr, new_sr)
    up, down = new_sr // g, orig_sr // g
    cutoff = rolloff * 0.5 / max(up, down)
    width = int(math.ceil(zeros / cutoff / 2))
    t = (np.arange(-width, width + 1)[None, :]
         - np.arange(up)[:, None] / up)
    sinc = np.sinc(2 * cutoff * t) * 2 * cutoff
    beta = 14.769656459379492  # Kaiser beta of a 180 dB sidelobe
    x = t / width
    win = np.i0(beta * np.sqrt(np.clip(1 - x ** 2, 0, 1))) / np.i0(beta)
    return (sinc * win).astype(np.float32), up, down, width


def resample(audio: torch.Tensor, orig_sr: int, new_sr: int) -> torch.Tensor:
    """(..., T) -> (..., ceil(T * new / orig)), in the input's dtype and on
    its device: each phase's filter over the zero-padded input (one conv
    of `up` channels), the phases interleaved, every down-th kept."""
    if orig_sr == new_sr:
        return audio
    kernels, up, down, width = _kaiser_sinc_kernel(orig_sr, new_sr)
    t = audio.shape[-1]
    x = F.pad(audio.reshape(-1, 1, t), (width, width + down))
    w = torch.as_tensor(kernels, device=audio.device).to(audio.dtype)
    y = F.conv1d(x, w[:, None, :])                       # (B, up, T')
    flat = y.transpose(1, 2).reshape(y.shape[0], -1)     # j = i * up + p
    n_out = int(math.ceil(t * new_sr / orig_sr))
    return flat[:, ::down][:, :n_out].reshape(audio.shape[:-1] + (n_out,))


# ------------------------------------------------------------------ loudness
def _k_weighting_coeffs(sr: int):
    """ITU-R BS.1770-4 K-weighting: the high-shelf pre-filter and the RLB
    high-pass, re-derived for any sample rate (pyloudnorm's constants)."""
    f0, G, Q = 1681.9744509555319, 3.99984385397, 0.7071752369554193
    K = math.tan(math.pi * f0 / sr)
    Vh = 10.0 ** (G / 20.0)
    Vb = Vh ** 0.499666774155
    a0_ = 1.0 + K / Q + K * K
    b_shelf = [(Vh + Vb * K / Q + K * K) / a0_,
               2.0 * (K * K - Vh) / a0_,
               (Vh - Vb * K / Q + K * K) / a0_]
    a_shelf = [1.0, 2.0 * (K * K - 1.0) / a0_, (1.0 - K / Q + K * K) / a0_]
    f0, Q = 38.13547087602444, 0.5003270373238773
    K = math.tan(math.pi * f0 / sr)
    denom = 1.0 + K / Q + K * K
    b_hp = [1.0, -2.0, 1.0]
    a_hp = [1.0, 2.0 * (K * K - 1.0) / denom,
            (1.0 - K / Q + K * K) / denom]
    return (np.array(b_shelf), np.array(a_shelf),
            np.array(b_hp), np.array(a_hp))


def integrated_loudness(audio, sample_rate: int,
                        block_size: float = 0.4) -> np.ndarray:
    """Gated integrated loudness in LUFS (BS.1770-4), on the host in
    float64. audio: (B, C, T), (C, T) or (T,), numpy or a tensor. Returns
    (B,), floored at -70."""
    from scipy.signal import lfilter
    if torch.is_tensor(audio):
        audio = audio.detach().cpu().numpy()
    x = np.asarray(audio, np.float64)
    while x.ndim < 3:
        x = x[None]
    nb, nch, t = x.shape
    b1, a1, b2, a2 = _k_weighting_coeffs(sample_rate)
    y = lfilter(b2, a2, lfilter(b1, a1, x, axis=-1), axis=-1)

    gate = int(block_size * sample_rate)   # 400 ms blocks
    hop = int(gate * 0.25)                 # 75% overlap
    if t < gate:
        y = np.pad(y, ((0, 0), (0, 0), (0, gate - t)))
        t = gate
    n_blocks = 1 + (t - gate) // hop
    idx = (np.arange(gate)[None, :] + hop * np.arange(n_blocks)[:, None])
    z = np.mean(y[..., idx] ** 2, axis=-1)  # (nb, nch, n_blocks)

    G = np.array([1.0, 1.0, 1.0, 1.41, 1.41])[:nch]
    l = -0.691 + 10.0 * np.log10(
        np.maximum((G[None, :, None] * z).sum(1), 1e-12))  # (nb, n_blocks)

    out = np.full((nb,), MIN_LOUDNESS)
    for i in range(nb):
        m_a = l[i] > -70.0
        if not m_a.any():
            continue
        z_a = z[i][:, m_a].mean(-1)
        gamma_r = -0.691 + 10.0 * np.log10(
            np.maximum((G * z_a).sum(), 1e-12)) - 10.0
        m = m_a & (l[i] > gamma_r)
        if not m.any():
            continue
        z_g = z[i][:, m].mean(-1)
        out[i] = -0.691 + 10.0 * np.log10(np.maximum((G * z_g).sum(), 1e-12))
    return np.maximum(out, MIN_LOUDNESS)


# ---------------------------------------------------------------- helpers
def _stft(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(N, T) -> complex (N, frames, n_fft//2 + 1): reflect-padded by
    n_fft//2, zero-padded on the right to a whole hop, periodic Hann."""
    xp = F.pad(x[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    rem = (xp.shape[-1] - n_fft) % hop
    if rem:
        xp = F.pad(xp, (0, hop - rem))
    win = mel_ops.hann_window(n_fft, x.dtype, x.device)
    return torch.fft.rfft(xp.unfold(-1, n_fft, hop) * win, n=n_fft, dim=-1)


def stft_frames(length: int, params: STFTParams) -> int:
    """The frame count of AudioSignal.stft over `length` samples."""
    n = length + 2 * (params.window_length // 2)
    return 1 + -(-(n - params.window_length) // params.hop_length)


def _fft_convolve(x: torch.Tensor, ir: torch.Tensor) -> torch.Tensor:
    """Linear convolution by FFT, truncated to x's length."""
    n = x.shape[-1] + ir.shape[-1] - 1
    return torch.fft.irfft(torch.fft.rfft(x, n=n) * torch.fft.rfft(ir, n=n),
                           n=n)[..., : x.shape[-1]]


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


def _sinc_lowpass_kernel(cutoff_hz: float, sr: int, zeros: int = 51
                         ) -> np.ndarray:
    """Hann-windowed sinc with `zeros` zero crossings, unit DC gain."""
    c = cutoff_hz / sr
    half = int(np.ceil(zeros / (4 * max(c, 1e-6))))
    t = np.arange(-half, half + 1, dtype=np.float64)
    kernel = 2 * c * np.sinc(2 * c * t) * np.hanning(2 * half + 1)
    return (kernel / kernel.sum()).astype(np.float32)


def _fir_filter(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Same-length zero-phase FIR by FFT, the kernel centred."""
    k = kernel.shape[0]
    xp = F.pad(x, (k // 2, k // 2))
    n = xp.shape[-1] + k - 1
    y = torch.fft.irfft(torch.fft.rfft(xp, n=n) * torch.fft.rfft(kernel, n=n),
                        n=n)
    return y[..., 2 * (k // 2): 2 * (k // 2) + x.shape[-1]]


def db_to_gain(db, device) -> torch.Tensor:
    """(B,) dB (host float64) -> (B, 1, 1) float32 linear gains."""
    g = np.exp(np.asarray(db, np.float64) * np.log(10.0) / 20.0)
    return torch.as_tensor(g, dtype=torch.float32,
                           device=device).reshape(-1, 1, 1)


# ---------------------------------------------------------------- the signal
class AudioSignal:
    """audio_data: (B, C, T) float32 tensor. DSP methods return new
    signals; `loudness()` is cached per instance; the mask methods, as in
    audiotools, change stft_data in place (call istft() after)."""

    def __init__(self, audio_data, sample_rate: int,
                 stft_params: Optional[STFTParams] = None, device=None):
        a = torch.as_tensor(audio_data, dtype=torch.float32, device=device)
        while a.dim() < 3:
            a = a[None]
        self.audio_data = a
        self.sample_rate = int(sample_rate)
        self.stft_params = stft_params or STFTParams()
        self._loudness = None
        self.stft_data = None
        # file-level side information (the whole file's "loudness" that
        # GlobalVolumeNorm reads)
        self.metadata: dict = {}

    @property
    def device(self) -> torch.device:
        return self.audio_data.device

    @property
    def batch_size(self) -> int:
        return self.audio_data.shape[0]

    @property
    def num_channels(self) -> int:
        return self.audio_data.shape[1]

    @property
    def signal_length(self) -> int:
        return self.audio_data.shape[-1]

    @property
    def signal_duration(self) -> float:
        return self.signal_length / self.sample_rate

    def clone(self) -> "AudioSignal":
        s = AudioSignal(self.audio_data, self.sample_rate, self.stft_params)
        s._loudness = self._loudness
        s.stft_data = self.stft_data
        s.metadata = dict(self.metadata)
        return s

    def _replace(self, audio) -> "AudioSignal":
        return AudioSignal(audio, self.sample_rate, self.stft_params)

    # -- stft ------------------------------------------------------------
    def stft(self) -> "AudioSignal":
        """Centred Hann STFT; stores complex (B, C, F, frames)."""
        p = self.stft_params
        spec = _stft(self.audio_data.reshape(-1, self.signal_length),
                     p.window_length, p.hop_length)
        self.stft_data = spec.transpose(-1, -2).reshape(
            self.batch_size, self.num_channels, p.window_length // 2 + 1, -1)
        return self

    def istft(self) -> "AudioSignal":
        """Inverse of stft(): a new signal of the same length."""
        if self.stft_data is None:
            raise ValueError("call stft() first")
        p = self.stft_params
        spec = self.stft_data.reshape(-1, *self.stft_data.shape[2:])
        wav = mel_ops.istft(spec.real, spec.imag, p.window_length,
                            p.hop_length, length=self.signal_length)
        out = self._replace(wav.reshape(self.batch_size, self.num_channels,
                                        -1))
        out.stft_data = self.stft_data
        return out

    def magnitude(self) -> torch.Tensor:
        if self.stft_data is None:
            self.stft()
        return self.stft_data.abs()

    def log_magnitude(self, ref_value: float = 1.0,
                      amin: float = 1e-5) -> torch.Tensor:
        return 20.0 * torch.log10(torch.clamp(self.magnitude(), min=amin)
                                  / ref_value)

    def phase(self) -> torch.Tensor:
        if self.stft_data is None:
            self.stft()
        return torch.atan2(self.stft_data.imag, self.stft_data.real)

    def set_mag_phase(self, mag, phase) -> "AudioSignal":
        """stft_data from magnitude and phase."""
        self.stft_data = torch.complex(mag * torch.cos(phase),
                                       mag * torch.sin(phase))
        return self

    # -- spectral masks ----------------------------------------------------
    def mask_frequencies(self, fmin_hz, fmax_hz,
                         val: float = 0.0) -> "AudioSignal":
        """Fill the bins in [fmin_hz, fmax_hz) with `val`, phase 0."""
        mag, phase = self.magnitude(), self.phase()
        f = np.linspace(0.0, self.sample_rate / 2, mag.shape[-2])
        band = torch.as_tensor((f >= float(fmin_hz)) & (f < float(fmax_hz)),
                               device=mag.device)[None, None, :, None]
        return self.set_mag_phase(torch.where(band, val, mag),
                                  torch.where(band, 0.0, phase))

    def mask_timesteps(self, tmin_s, tmax_s,
                       val: float = 0.0) -> "AudioSignal":
        """Fill the frames in [tmin_s, tmax_s) with `val`, phase 0."""
        mag, phase = self.magnitude(), self.phase()
        t = np.linspace(0.0, self.signal_duration, mag.shape[-1])
        span = torch.as_tensor((t >= float(tmin_s)) & (t < float(tmax_s)),
                               device=mag.device)[None, None, None, :]
        return self.set_mag_phase(torch.where(span, val, mag),
                                  torch.where(span, 0.0, phase))

    def mask_low_magnitudes(self, db_cutoff,
                            val: float = 0.0) -> "AudioSignal":
        mag = self.magnitude()
        mask = self.log_magnitude() < float(db_cutoff)
        return self.set_mag_phase(torch.where(mask, val, mag), self.phase())

    def shift_phase(self, shift) -> "AudioSignal":
        """Add `shift` (a scalar or a tensor that broadcasts) to the
        phase."""
        return self.set_mag_phase(self.magnitude(), self.phase() + shift)

    # -- loudness and gain -------------------------------------------------
    def loudness(self) -> np.ndarray:
        """(B,) integrated LUFS, cached."""
        if self._loudness is None:
            self._loudness = integrated_loudness(self.audio_data,
                                                 self.sample_rate)
        return self._loudness

    def normalize(self, db: float = -24.0) -> "AudioSignal":
        """Gain to the target LUFS."""
        out = self._replace(self.audio_data * db_to_gain(
            db - self.loudness(), self.device))
        out._loudness = np.full_like(self.loudness(), db)
        return out

    def normalize_per_item(self, db) -> "AudioSignal":
        """Gain to a target LUFS per item."""
        db = np.asarray(db, np.float64)
        out = self._replace(self.audio_data * db_to_gain(
            db - self.loudness(), self.device))
        out._loudness = db
        return out

    def ensure_max_of_audio(self, max: float = 1.0) -> "AudioSignal":
        """Rescale only the items whose peak exceeds `max`."""
        peak = self.audio_data.abs().amax(dim=(1, 2), keepdim=True)
        scale = torch.where(peak > max, max / torch.clamp(peak, min=1e-12),
                            torch.ones_like(peak))
        return self._replace(self.audio_data * scale)

    def volume_change(self, db: float) -> "AudioSignal":
        return self._replace(self.audio_data * float(
            np.exp(np.float32(db) * np.log(np.float32(10.0)) / 20.0)))

    # -- effects -------------------------------------------------------------
    def _match_length(self, other: "AudioSignal") -> torch.Tensor:
        o = other.audio_data.to(self.device)
        pad = self.signal_length - o.shape[-1]
        if pad > 0:
            o = F.pad(o, (0, pad))
        return o[..., : self.signal_length]

    def convolve(self, other: "AudioSignal",
                 start_at_max: bool = True) -> "AudioSignal":
        """FFT convolution with `other` (an IR or a window), length kept:
        each IR rolled to start at its peak."""
        ir = self._match_length(other)
        if start_at_max:
            t = ir.shape[-1]
            idx = ir.abs().argmax(dim=-1)                  # (B, C)
            pos = (torch.arange(t, device=ir.device)[None, None, :]
                   + idx[..., None]) % t
            ir = torch.gather(ir, -1, pos)
        ir = ir.expand(self.audio_data.shape)
        out = _fft_convolve(self.audio_data.reshape(-1, self.signal_length),
                            ir.reshape(-1, self.signal_length))
        return self._replace(out.reshape(self.audio_data.shape))

    def mix(self, other: "AudioSignal", snr=10.0,
            other_eq=None) -> "AudioSignal":
        """Add `other` at a per-item SNR in LUFS, after its equalizer."""
        o = AudioSignal(self._match_length(other), self.sample_rate,
                        self.stft_params)
        if other_eq is not None:
            o = o.equalizer(other_eq)
        tgt = self.loudness() - np.broadcast_to(
            np.asarray(snr, np.float64), (self.batch_size,))
        o = o.normalize_per_item(tgt)
        return self._replace(self.audio_data + o.audio_data)

    def mel_filterbank(self, n_bands: int) -> torch.Tensor:
        """(B, C, T, n_bands) mel-spaced bands that sum to the signal: a
        brickwall split of the FFT at mel-spaced edges."""
        t = self.signal_length
        freqs = np.fft.rfftfreq(t, 1.0 / self.sample_rate)
        edges = _mel_to_hz(np.linspace(
            _hz_to_mel(0.0), _hz_to_mel(self.sample_rate / 2), n_bands + 1))
        spec = torch.fft.rfft(self.audio_data.reshape(-1, t))
        bands = []
        for i in range(n_bands):
            m = (freqs >= edges[i]) & (freqs < edges[i + 1]) \
                if i < n_bands - 1 else freqs >= edges[i]
            bands.append(torch.fft.irfft(
                spec * torch.as_tensor(m, device=spec.device), n=t))
        return torch.stack(bands, dim=-1).reshape(
            self.audio_data.shape + (n_bands,))

    def equalizer(self, db) -> "AudioSignal":
        """Mel-band EQ: each band weighted by 10 ** db (audiotools'
        convention). db: (n_bands,) or (1 | B, n_bands)."""
        db = torch.as_tensor(np.asarray(db, np.float32), device=self.device)
        db = db.reshape(-1, db.shape[-1])
        fbank = self.mel_filterbank(db.shape[-1])
        w = 10.0 ** db
        return self._replace((fbank * w[:, None, None, :]).sum(-1))

    def low_pass(self, cutoff: float, zeros: int = 51) -> "AudioSignal":
        """Windowed-sinc FIR low-pass."""
        kernel = torch.as_tensor(_sinc_lowpass_kernel(
            float(cutoff), self.sample_rate, zeros), device=self.device)
        y = _fir_filter(self.audio_data.reshape(-1, self.signal_length),
                        kernel)
        return self._replace(y.reshape(self.audio_data.shape))

    def high_pass(self, cutoff: float, zeros: int = 51) -> "AudioSignal":
        """x - low_pass(x)."""
        return self._replace(self.audio_data
                             - self.low_pass(cutoff, zeros).audio_data)

    def clip_distortion(self, clip_percentile) -> "AudioSignal":
        """Clip each item at its quantiles q/2 and 1 - q/2."""
        q = torch.as_tensor(np.broadcast_to(np.asarray(
            clip_percentile, np.float32), (self.batch_size,)).copy(),
            device=self.device)
        flat = self.audio_data.reshape(self.batch_size, -1)
        lo = torch.stack([torch.quantile(a, p / 2) for a, p in zip(flat, q)])
        hi = torch.stack([torch.quantile(a, 1 - p / 2)
                          for a, p in zip(flat, q)])
        return self._replace(torch.clamp(self.audio_data, lo[:, None, None],
                                         hi[:, None, None]))

    def quantization(self, quantization_channels: int) -> "AudioSignal":
        q = float(quantization_channels)
        x = torch.floor((self.audio_data + 1) / 2 * q) / q
        return self._replace(2 * x - 1)

    def mulaw_quantization(self, quantization_channels: int
                           ) -> "AudioSignal":
        """mu-law companding, quantization, expansion."""
        mu = float(quantization_channels) - 1.0
        x = self.audio_data
        y = torch.sign(x) * torch.log1p(mu * x.abs()) / np.log1p(mu)
        y = torch.floor((y + 1) / 2 * mu + 0.5)
        y = (y / mu) * 2 - 1.0
        y = torch.sign(y) * (torch.exp(y.abs() * np.log1p(mu)) - 1.0) / mu
        return self._replace(y)

    # -- channels and rate -------------------------------------------------
    def to_mono(self) -> "AudioSignal":
        return self._replace(self.audio_data.mean(dim=1, keepdim=True))

    def resample(self, new_sr: int) -> "AudioSignal":
        if new_sr == self.sample_rate:
            return self
        return AudioSignal(resample(self.audio_data, self.sample_rate,
                                    new_sr), new_sr, self.stft_params)

    # -- io ------------------------------------------------------------------
    def write(self, path: str) -> "AudioSignal":
        from minimax_speech_torch.cli.synthesize import write_wav
        write_wav(path, self.to_mono().audio_data[0, 0].cpu().numpy(),
                  self.sample_rate)
        return self

    @classmethod
    def load(cls, path: str, device=None) -> "AudioSignal":
        from minimax_speech_torch.data.pipeline import _load_audio
        audio, sr = _load_audio(path)
        return cls(audio, sr, device=device)


def _tri_window(n: int) -> np.ndarray:
    up = np.linspace(0, 1, n + 2)[1:-1]
    return np.concatenate([up, [1.0], up[::-1]])


def _gate_mask(sig_db, nz_db, denoise_amount: float, n_std: float,
               n_freq: int, n_time: int) -> torch.Tensor:
    """1 - (the smoothed mask of bins under the noise threshold) x
    denoise_amount; the threshold is the noise's mean plus n_std of its
    (population) std over time, per frequency."""
    thr = nz_db.mean(-1, keepdim=True) \
        + n_std * nz_db.std(-1, unbiased=False, keepdim=True)
    mask = (sig_db < thr).float()                       # (BC, F, T)
    filt = np.outer(_tri_window(n_freq), _tri_window(n_time))
    filt = torch.as_tensor(filt / filt.sum(), dtype=torch.float32,
                           device=mask.device)
    sm = F.conv2d(mask[:, None], filt[None, None],
                  padding=(n_freq, n_time))[:, 0]
    return 1.0 - sm * denoise_amount


def spectral_gate(signal: AudioSignal, nz_signal: AudioSignal,
                  denoise_amount: float = 1.0, n_std: float = 3.0,
                  win_length: int = 2048, hop_length: int = 512,
                  n_freq: int = 3, n_time: int = 5) -> AudioSignal:
    """Spectral-gating denoiser (the noisereduce algorithm): noise
    statistics per frequency -> a dB threshold -> a smoothed
    time-frequency mask -> the signal's STFT scaled by 1 - mask."""
    p = STFTParams(win_length, hop_length)
    sig = AudioSignal(signal.audio_data, signal.sample_rate, p).stft()
    nz = AudioSignal(nz_signal.audio_data.to(signal.device),
                     nz_signal.sample_rate, p).stft()

    def to_db(s):
        return 20.0 * torch.log10(torch.clamp(s.abs(), min=1e-4))

    f, t = sig.stft_data.shape[2], sig.stft_data.shape[3]
    bc = sig.stft_data.shape[0] * sig.stft_data.shape[1]
    nzd = to_db(nz.stft_data).reshape(-1, *nz.stft_data.shape[2:])[:1] \
        .expand(bc, -1, -1)
    mask = _gate_mask(to_db(sig.stft_data).reshape(bc, f, t), nzd,
                      float(np.mean(denoise_amount)), float(n_std),
                      int(n_freq), int(n_time))
    sig.stft_data = sig.stft_data * mask.reshape(sig.stft_data.shape)
    return AudioSignal(sig.istft().audio_data, signal.sample_rate,
                       signal.stft_params)
