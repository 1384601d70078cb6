"""audiotools data transforms, each split into a draw and an apply.

Port of minimax_speech_tpu/utils/audio_transforms.py (the 32 classes,
`_sample_dist`, `build_transform`). JAX draws inside `_transform` from
split PRNG keys; here every transform has
  * `draw(gen, signal)`: all its random numbers for one call on
    `signal`, from a torch.Generator, as a dict of host numbers and
    tensors (the prob gate's Bernoulli mask under "apply", the
    transform's own under "tfm"); they depend on the signal's shape
    only;
  * `apply(draws, signal)`: the deterministic rest, on the signal's
    device;
and `t(gen, signal)` is `t.apply(t.draw(gen, signal), signal)`. A test
can so hand the port the very numbers JAX drew.

Source banks (BackgroundNoise, RoomImpulseResponse, CrossTalk `sources`)
are (N, T) float32 arrays; without one, the default synthetic noise,
impulse responses or talkers are drawn.
"""
from __future__ import annotations

import copy
from typing import Sequence, Tuple

import numpy as np
import torch

from minimax_speech_torch.utils.audio_signal import (AudioSignal, db_to_gain,
                                                     spectral_gate,
                                                     stft_frames)


def _uniform(gen, shape, lo=0.0, hi=1.0) -> np.ndarray:
    return (lo + (hi - lo) * torch.rand(shape, generator=gen)).numpy()


def _normal(gen, shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen)


def _randint(gen, n: int) -> int:
    return int(torch.randint(0, n, (), generator=gen))


def _sample_dist(gen, dist: Tuple, batch: int = 1):
    """('const', v) | ('uniform', lo, hi) | ('choice', [...]): the const
    value, one choice, or (batch,) uniform draws as numpy."""
    if dist[0] == "const":
        return dist[1]
    if dist[0] == "choice":
        return dist[1][_randint(gen, len(dist[1]))]
    return _uniform(gen, (batch,), float(dist[1]), float(dist[2]))


def _eq_draws(gen, amount_dist, batch: int, n_bands: int) -> dict:
    return {"amount": _sample_dist(gen, amount_dist, batch),
            "eq_u": _uniform(gen, (batch, n_bands))}


def _eq(d) -> np.ndarray:
    """The equalizer's dB cut of an _eq_draws dict: -amount x U[0, 1)."""
    return -np.asarray(d["amount"]).reshape(-1, 1) * np.asarray(d["eq_u"])


def _like(signal: AudioSignal, audio) -> AudioSignal:
    return AudioSignal(audio, signal.sample_rate, signal.stft_params)


class BaseTransform:
    """A prob-gated per-item transform."""

    def __init__(self, name: str = None, prob: float = 1.0):
        self.name = name or type(self).__name__
        self.prob = prob

    def _draw(self, gen, signal) -> dict:
        return {}

    def _apply(self, d: dict, signal: AudioSignal) -> AudioSignal:
        return signal

    def draw(self, gen, signal: AudioSignal) -> dict:
        if self.prob <= 0.0:
            return {}
        d = {}
        if self.prob < 1.0:
            d["apply"] = torch.rand(signal.batch_size,
                                    generator=gen) < self.prob
        d["tfm"] = self._draw(gen, signal)
        return d

    def apply(self, draws: dict, signal: AudioSignal) -> AudioSignal:
        if self.prob >= 1.0:
            return self._apply(draws["tfm"], signal)
        if self.prob <= 0.0:
            return signal
        out = self._apply(draws["tfm"], signal.clone())
        mask = torch.as_tensor(draws["apply"], device=signal.device)
        return _like(signal, torch.where(mask[:, None, None],
                                         out.audio_data, signal.audio_data))

    def __call__(self, gen, signal: AudioSignal) -> AudioSignal:
        return self.apply(self.draw(gen, signal), signal)


class Identity(BaseTransform):
    pass


class Compose(BaseTransform):
    """The transforms in sequence."""

    def __init__(self, *transforms: BaseTransform, name: str = None,
                 prob: float = 1.0):
        super().__init__(name=name, prob=prob)
        flat = []
        for t in transforms:
            flat.extend(t if isinstance(t, (list, tuple)) else [t])
        self.transforms = flat

    def _draw(self, gen, signal):
        return {"each": [t.draw(gen, signal) for t in self.transforms]}

    def _apply(self, d, signal):
        for t, td in zip(self.transforms, d["each"]):
            signal = t.apply(td, signal)
        return signal


class VolumeNorm(BaseTransform):
    """Loudness to a dB target: ("const", x), or ("uniform", lo, hi) per
    item."""

    def __init__(self, db: Tuple = ("const", -24), name: str = None,
                 prob: float = 1.0):
        super().__init__(name=name, prob=prob)
        self.db = db

    def _draw(self, gen, signal):
        if self.db[0] in ("const", "lufs"):
            return {}
        return {"db": _uniform(gen, (signal.batch_size,), float(self.db[1]),
                               float(self.db[2]))}

    def _apply(self, d, signal):
        if self.db[0] in ("const", "lufs"):
            return signal.normalize(float(self.db[1]))
        return _like(signal, signal.audio_data * db_to_gain(
            np.asarray(d["db"]) - signal.loudness(), signal.device))


class VolumeChange(BaseTransform):
    """A uniform gain in dB per item."""

    def __init__(self, db: Tuple = ("uniform", -12.0, 0.0),
                 name: str = None, prob: float = 1.0):
        super().__init__(name=name, prob=prob)
        self.db = db

    def _draw(self, gen, signal):
        return {"db": _uniform(gen, (signal.batch_size,), float(self.db[1]),
                               float(self.db[2]))}

    def _apply(self, d, signal):
        db = torch.as_tensor(np.asarray(d["db"], np.float32),
                             device=signal.device)
        gain = torch.exp(db * np.log(np.float32(10.0)) / 20.0)
        return _like(signal, signal.audio_data * gain[:, None, None])


class RescaleAudio(BaseTransform):
    """Rescale the items whose peak exceeds `val`."""

    def __init__(self, val: float = 1.0, name: str = None,
                 prob: float = 1.0):
        super().__init__(name=name, prob=prob)
        self.val = val

    def _apply(self, d, signal):
        return signal.ensure_max_of_audio(self.val)


class ShiftPhase(BaseTransform):
    """A uniform constant phase shift per item (STFT, rotate, iSTFT)."""

    def __init__(self, shift: Tuple = ("uniform", -np.pi, np.pi),
                 name: str = None, prob: float = 1.0):
        super().__init__(name=name, prob=prob)
        self.shift = shift

    def _draw(self, gen, signal):
        return {"shift": _uniform(gen, (signal.batch_size,),
                                  float(self.shift[1]),
                                  float(self.shift[2]))}

    def _apply(self, d, signal):
        signal = signal.clone().stft()
        shift = torch.as_tensor(np.asarray(d["shift"], np.float32),
                                device=signal.device)
        signal.stft_data = signal.stft_data * torch.polar(
            torch.ones_like(shift), shift)[:, None, None, None]
        return signal.istft()


class ClippingDistortion(BaseTransform):
    """Clip each item at a drawn percentile."""

    def __init__(self, perc: Tuple = ("uniform", 0.0, 0.1),
                 name: str = None, prob: float = 1.0):
        super().__init__(name=name, prob=prob)
        self.perc = perc

    def _draw(self, gen, signal):
        return {"perc": _sample_dist(gen, self.perc, signal.batch_size)}

    def _apply(self, d, signal):
        return signal.clip_distortion(d["perc"])


class Equalizer(BaseTransform):
    """A random cut of each mel band, up to eq_amount dB-units."""

    def __init__(self, eq_amount: Tuple = ("const", 1.0),
                 n_bands: int = 6, name: str = None, prob: float = 1.0):
        super().__init__(name=name, prob=prob)
        self.eq_amount = eq_amount
        self.n_bands = n_bands

    def _draw(self, gen, signal):
        return _eq_draws(gen, self.eq_amount, signal.batch_size,
                         self.n_bands)

    def _apply(self, d, signal):
        return signal.equalizer(_eq(d))


class Quantization(BaseTransform):
    def __init__(self, channels: Tuple = ("choice",
                                          [8, 32, 128, 256, 1024]),
                 name: str = None, prob: float = 1.0):
        super().__init__(name=name, prob=prob)
        self.channels = channels

    def _draw(self, gen, signal):
        return {"channels": _sample_dist(gen, self.channels)}

    def _apply(self, d, signal):
        return signal.quantization(d["channels"])


class MuLawQuantization(Quantization):
    def _apply(self, d, signal):
        return signal.mulaw_quantization(d["channels"])


class LowPass(BaseTransform):
    """A windowed-sinc low-pass at a drawn cutoff."""

    def __init__(self, cutoff: Tuple = ("choice", [4000, 8000, 16000]),
                 zeros: int = 51, name: str = None, prob: float = 1.0):
        super().__init__(name=name, prob=prob)
        self.cutoff = cutoff
        self.zeros = zeros

    def _draw(self, gen, signal):
        return {"cutoff": _sample_dist(gen, self.cutoff)}

    def _apply(self, d, signal):
        return signal.low_pass(d["cutoff"], zeros=self.zeros)


class HighPass(LowPass):
    """The complementary high-pass at a drawn cutoff."""

    def __init__(self, cutoff: Tuple = ("choice",
                                        [50, 100, 250, 500, 1000]),
                 zeros: int = 51, name: str = None, prob: float = 1.0):
        super().__init__(cutoff=cutoff, zeros=zeros, name=name, prob=prob)

    def _apply(self, d, signal):
        return signal.high_pass(d["cutoff"], zeros=self.zeros)


class Smoothing(BaseTransform):
    """Convolve with a smoothing window, rescaled to the input's peak."""

    def __init__(self, window_type: Tuple = ("const", "average"),
                 window_length: Tuple = ("choice",
                                         [8, 16, 32, 64, 128, 256, 512]),
                 name: str = None, prob: float = 1.0):
        super().__init__(name=name, prob=prob)
        self.window_type = window_type
        self.window_length = window_length

    def _draw(self, gen, signal):
        return {"type": _sample_dist(gen, self.window_type),
                "length": int(_sample_dist(gen, self.window_length))}

    def _apply(self, d, signal):
        n = d["length"]
        win = np.hanning(n) if d["type"] == "hann" else np.ones(n)
        win = (win / win.sum()).astype(np.float32)
        out = signal.convolve(AudioSignal(win[None, None, :],
                                          signal.sample_rate,
                                          device=signal.device))
        sscale = torch.clamp(signal.audio_data.abs().amax(-1, keepdim=True),
                             min=1e-12)
        oscale = torch.clamp(out.audio_data.abs().amax(-1, keepdim=True),
                             min=1e-12)
        return _like(signal, out.audio_data * (sscale / oscale))


def _bank_clip(sources, i: int, signal: AudioSignal) -> torch.Tensor:
    """Source i tiled to the signal's length, (B, 1, T)."""
    clip = np.asarray(sources[i], np.float32)
    clip = np.tile(clip, int(np.ceil(signal.signal_length / len(clip))))
    return torch.as_tensor(clip[: signal.signal_length]).expand(
        signal.batch_size, 1, signal.signal_length)


def _shaped_noise(white: torch.Tensor, shape) -> torch.Tensor:
    """White noise (B, 1, T) through a real spectral shape (F,)."""
    n = white.shape[-1]
    spec = torch.fft.rfft(white.to(torch.float32))
    return torch.fft.irfft(spec * torch.as_tensor(
        shape, dtype=torch.float32, device=white.device), n=n)


class BackgroundNoise(BaseTransform):
    """Mix a noise clip at a drawn SNR, the noise through a random 3-band
    EQ. Without `sources`, seeded pink-ish noise."""

    def __init__(self, snr: Tuple = ("uniform", 10.0, 30.0),
                 sources: np.ndarray = None, eq_amount: Tuple = ("const",
                                                                 1.0),
                 n_bands: int = 3, name: str = None, prob: float = 1.0):
        super().__init__(name=name, prob=prob)
        self.snr = snr
        self.eq_amount = eq_amount
        self.n_bands = n_bands
        self.sources = sources

    def _draw(self, gen, signal):
        b = signal.batch_size
        noise = ({"source": _randint(gen, len(self.sources))}
                 if self.sources is not None else
                 {"white": _normal(gen, (b, 1, signal.signal_length))})
        return {**noise, "snr": _sample_dist(gen, self.snr, b),
                **_eq_draws(gen, self.eq_amount, b, self.n_bands)}

    def _noise(self, d, signal) -> torch.Tensor:
        if self.sources is not None:
            return _bank_clip(self.sources, d["source"], signal)
        f = np.maximum(np.fft.rfftfreq(signal.signal_length), 1e-3)
        return _shaped_noise(torch.as_tensor(d["white"],
                                             device=signal.device),
                             1.0 / np.sqrt(f))

    def _apply(self, d, signal):
        noise = AudioSignal(self._noise(d, signal), signal.sample_rate,
                            device=signal.device)
        return signal.clone().mix(noise, d["snr"], _eq(d))


class RoomImpulseResponse(BaseTransform):
    """Convolve with an impulse response whose direct-to-reverberant
    ratio is moved to a drawn target, the dry peak kept. Without
    `sources`, a seeded synthetic exponential-decay IR."""

    def __init__(self, drr: Tuple = ("uniform", 0.0, 30.0),
                 sources: np.ndarray = None, eq_amount: Tuple = ("const",
                                                                 1.0),
                 n_bands: int = 6, ir_seconds: float = 0.3,
                 name: str = None, prob: float = 1.0):
        super().__init__(name=name, prob=prob)
        self.drr = drr
        self.eq_amount = eq_amount
        self.n_bands = n_bands
        self.sources = sources
        self.ir_seconds = ir_seconds

    def _draw(self, gen, signal):
        if self.sources is not None:
            ir = np.asarray(self.sources[_randint(gen, len(self.sources))],
                            np.float32)
        else:
            t = int(self.ir_seconds * signal.sample_rate)
            rng = np.random.default_rng(_randint(gen, 2 ** 31 - 1))
            ir = rng.standard_normal(t) * np.exp(
                -np.arange(t) / (0.05 * signal.sample_rate))
            ir[0] = 1.0  # the direct path
            ir = ir.astype(np.float32)
        return {"ir": ir,
                "drr": float(np.mean(_sample_dist(gen, self.drr, 1))),
                **_eq_draws(gen, self.eq_amount, signal.batch_size,
                            self.n_bands)}

    @staticmethod
    def _alter_drr(ir: np.ndarray, sr: int, target_drr: float
                   ) -> np.ndarray:
        """Scale the early field to reach the target DRR (Bryan 2020,
        eqs. 1-5)."""
        td = int(np.argmax(np.abs(ir)))
        t0 = int(sr * 0.0025)
        idx = np.arange(len(ir))
        early_m = (idx >= td - t0) & (idx <= td + t0)
        early = np.where(early_m, ir, 0.0)
        late = np.where(~early_m, ir, 0.0)
        wd = np.zeros_like(ir)
        span = np.nonzero(early_m)[0]
        wd[span] = np.hanning(len(span))
        e_sq, l_sq = early ** 2, late ** 2
        a = (wd ** 2 * e_sq).sum()
        b = (2 * (1 - wd) * wd * e_sq).sum()
        c = (((1 - wd) ** 2) * e_sq).sum() \
            - 10 ** (target_drr / 10) * l_sq.sum()
        disc = max(b * b - 4 * a * c, 0.0)
        alpha = max((-b - np.sqrt(disc)) / (2 * a + 1e-12),
                    (-b + np.sqrt(disc)) / (2 * a + 1e-12))
        peak_l = np.abs(late).max()
        peak_e = max(np.abs(early).max(), 1e-12)
        alpha = max(alpha, peak_l / peak_e)
        out = wd * alpha * early + (1 - wd) * early + late
        return out.astype(np.float32)

    def _apply(self, d, signal):
        ir = self._alter_drr(np.asarray(d["ir"]), signal.sample_rate,
                             d["drr"])
        ir_sig = AudioSignal(ir[None, None, :], signal.sample_rate,
                             device=signal.device).equalizer(_eq(d)[:1])
        peak = signal.audio_data.abs().amax(-1, keepdim=True)
        out = signal.convolve(ir_sig)
        opeak = torch.clamp(out.audio_data.abs().amax(-1, keepdim=True),
                            min=1e-12)
        return _like(signal, out.audio_data * (peak / opeak))


class SpectralTransform(BaseTransform):
    """STFT before, iSTFT after."""

    def _spectral(self, d, signal: AudioSignal) -> AudioSignal:
        return signal

    def _apply(self, d, signal):
        sig = signal.clone()
        sig.stft_data = None
        sig.stft()
        return self._spectral(d, sig).istft()


class Choose(Compose):
    """One of the transforms per item, by weight; each chosen transform
    runs once on just its items."""

    def __init__(self, *transforms: BaseTransform, weights=None,
                 name: str = None, prob: float = 1.0):
        super().__init__(*transforms, name=name, prob=prob)
        n = len(self.transforms)
        w = np.full(n, 1.0 / n) if weights is None else np.asarray(
            weights, np.float64)
        self.weights = w / w.sum()

    def _draw(self, gen, signal):
        idx = torch.multinomial(torch.as_tensor(self.weights),
                                signal.batch_size, replacement=True,
                                generator=gen).numpy()
        each = []
        for t_i, t in enumerate(self.transforms):
            rows = np.nonzero(idx == t_i)[0]
            each.append(t.draw(gen, _like(signal, signal.audio_data[rows]))
                        if rows.size else None)
        return {"idx": idx, "each": each}

    def _apply(self, d, signal):
        idx = np.asarray(d["idx"])
        out = signal.audio_data.clone()
        for t_i, (t, td) in enumerate(zip(self.transforms, d["each"])):
            rows = torch.as_tensor(np.nonzero(idx == t_i)[0],
                                   device=signal.device)
            if rows.numel() == 0:
                continue
            out[rows] = t.apply(td, _like(signal, out[rows])).audio_data
        return _like(signal, out)


class Repeat(Compose):
    """One transform n_repeat times."""

    def __init__(self, transform: BaseTransform, n_repeat: int = 1,
                 name: str = None, prob: float = 1.0):
        super().__init__(*[copy.copy(transform) for _ in range(n_repeat)],
                         name=name, prob=prob)
        self.n_repeat = n_repeat


class RepeatUpTo(Choose):
    """A transform repeated 1 .. max_repeat - 1 times, chosen per item."""

    def __init__(self, transform: BaseTransform, max_repeat: int = 5,
                 weights=None, name: str = None, prob: float = 1.0):
        reps = [Repeat(transform, n_repeat=n, name=f"repeat_{n}")
                for n in range(1, max_repeat)]
        super().__init__(*reps, weights=weights, name=name, prob=prob)
        self.max_repeat = max_repeat


class NoiseFloor(BaseTransform):
    """Gaussian noise at a target LUFS per item."""

    def __init__(self, db: Tuple = ("const", -50.0), name: str = None,
                 prob: float = 1.0):
        super().__init__(name=name, prob=prob)
        self.db = db

    def _draw(self, gen, signal):
        return {"db": _sample_dist(gen, self.db, signal.batch_size),
                "noise": _normal(gen, tuple(signal.audio_data.shape))}

    def _apply(self, d, signal):
        db = np.broadcast_to(d["db"], (signal.batch_size,))
        nz = AudioSignal(d["noise"], signal.sample_rate,
                         device=signal.device).normalize_per_item(db)
        return _like(signal, signal.audio_data + nz.audio_data)


class CrossTalk(BaseTransform):
    """Mix a second talker at a drawn SNR, then restore the loudness.
    Without `sources`, seeded speech-shaped noise."""

    def __init__(self, snr: Tuple = ("uniform", 0.0, 10.0),
                 sources: np.ndarray = None, name: str = None,
                 prob: float = 1.0):
        super().__init__(name=name, prob=prob)
        self.snr = snr
        self.sources = sources

    def _draw(self, gen, signal):
        b = signal.batch_size
        talker = ({"source": _randint(gen, len(self.sources))}
                  if self.sources is not None else
                  {"white": _normal(gen, (b, 1, signal.signal_length))})
        return {**talker, "snr": _sample_dist(gen, self.snr, b)}

    def _talker(self, d, signal) -> torch.Tensor:
        if self.sources is not None:
            return _bank_clip(self.sources, d["source"], signal)
        f = np.fft.rfftfreq(signal.signal_length, 1.0 / signal.sample_rate)
        return _shaped_noise(torch.as_tensor(d["white"],
                                             device=signal.device),
                             1.0 / np.sqrt(1.0 + (f / 500.0) ** 2))

    def _apply(self, d, signal):
        talker = AudioSignal(self._talker(d, signal), signal.sample_rate,
                             device=signal.device)
        loud = signal.loudness()
        return signal.clone().mix(talker, d["snr"]).normalize_per_item(loud)


class GlobalVolumeNorm(BaseTransform):
    """VolumeNorm against the whole source file's loudness, from
    signal.metadata['loudness']; without it, nothing."""

    def __init__(self, db: Tuple = ("const", -24), name: str = None,
                 prob: float = 1.0):
        super().__init__(name=name, prob=prob)
        self.db = db

    def _draw(self, gen, signal):
        return {"db": float(np.mean(_sample_dist(gen, self.db, 1)))}

    def _apply(self, d, signal):
        src = signal.metadata.get("loudness")
        if src is None or not np.isfinite(float(src)):
            return signal
        return signal.volume_change(d["db"] - float(src))


class Silence(BaseTransform):
    """Zeros (default prob 0.1)."""

    def __init__(self, name: str = None, prob: float = 0.1):
        super().__init__(name=name, prob=prob)

    def _apply(self, d, signal):
        return _like(signal, torch.zeros_like(signal.audio_data))


class InvertPhase(ShiftPhase):
    """A constant pi phase shift: the negated signal."""

    def __init__(self, name: str = None, prob: float = 1.0):
        super().__init__(shift=("const", np.pi, np.pi), name=name,
                         prob=prob)

    def _draw(self, gen, signal):
        return {}

    def _apply(self, d, signal):
        return _like(signal, -signal.audio_data)


def _phase_shape(signal: AudioSignal) -> tuple:
    p = signal.stft_params
    return (signal.batch_size, signal.num_channels,
            p.window_length // 2 + 1,
            stft_frames(signal.signal_length, p))


class CorruptPhase(SpectralTransform):
    """Gaussian noise on the STFT phase at a drawn scale."""

    def __init__(self, scale: Tuple = ("uniform", 0, np.pi),
                 name: str = None, prob: float = 1.0):
        super().__init__(name=name, prob=prob)
        self.scale = scale

    def _draw(self, gen, signal):
        return {"scale": float(np.mean(_sample_dist(gen, self.scale, 1))),
                "noise": _normal(gen, _phase_shape(signal))}

    def _spectral(self, d, signal):
        return signal.shift_phase(
            d["scale"] * torch.as_tensor(d["noise"], device=signal.device))


class FrequencyMask(SpectralTransform):
    """A SpecAugment frequency-band mask."""

    def __init__(self, f_center: Tuple = ("uniform", 0.0, 1.0),
                 f_width: Tuple = ("const", 0.1), name: str = None,
                 prob: float = 1.0):
        super().__init__(name=name, prob=prob)
        self.f_center = f_center
        self.f_width = f_width

    def _draw(self, gen, signal):
        return {"center": float(np.mean(_sample_dist(gen, self.f_center, 1))),
                "width": float(np.mean(_sample_dist(gen, self.f_width, 1)))}

    def _band_hz(self, d, signal):
        c, w = d["center"], d["width"]
        nyq = signal.sample_rate / 2
        return max(c - w / 2, 0.0) * nyq, min(c + w / 2, 1.0) * nyq

    def _spectral(self, d, signal):
        return signal.mask_frequencies(*self._band_hz(d, signal))


class TimeMask(SpectralTransform):
    """A SpecAugment time-span mask."""

    def __init__(self, t_center: Tuple = ("uniform", 0.0, 1.0),
                 t_width: Tuple = ("const", 0.025), name: str = None,
                 prob: float = 1.0):
        super().__init__(name=name, prob=prob)
        self.t_center = t_center
        self.t_width = t_width

    def _draw(self, gen, signal):
        return {"center": float(np.mean(_sample_dist(gen, self.t_center, 1))),
                "width": float(np.mean(_sample_dist(gen, self.t_width, 1)))}

    def _span_s(self, d, signal):
        c, w = d["center"], d["width"]
        dur = signal.signal_duration
        return max(c - w / 2, 0.0) * dur, min(c + w / 2, 1.0) * dur

    def _spectral(self, d, signal):
        return signal.mask_timesteps(*self._span_s(d, signal))


class MaskLowMagnitudes(SpectralTransform):
    """Zero the STFT bins under a drawn dB cutoff."""

    def __init__(self, db_cutoff: Tuple = ("uniform", -10, 10),
                 name: str = None, prob: float = 1.0):
        super().__init__(name=name, prob=prob)
        self.db_cutoff = db_cutoff

    def _draw(self, gen, signal):
        return {"db": float(np.mean(_sample_dist(gen, self.db_cutoff, 1)))}

    def _spectral(self, d, signal):
        return signal.mask_low_magnitudes(d["db"])


def _fill_holes(d, signal: AudioSignal) -> AudioSignal:
    """Bins a mask left at magnitude 0 and phase 0 get the drawn noise."""
    mag, phase = signal.magnitude(), signal.phase()
    hole = (mag == 0.0) & (phase == 0.0)
    return signal.set_mag_phase(
        torch.where(hole, torch.as_tensor(d["mag"], device=mag.device), mag),
        torch.where(hole, torch.as_tensor(d["phase"], device=mag.device),
                    phase))


class TimeNoise(TimeMask):
    """TimeMask with noise in the masked frames in place of zeros."""

    def _draw(self, gen, signal):
        shape = _phase_shape(signal)
        return {**super()._draw(gen, signal), "mag": _normal(gen, shape),
                "phase": _normal(gen, shape)}

    def _spectral(self, d, signal):
        return _fill_holes(d, signal.mask_timesteps(*self._span_s(d, signal),
                                                    val=0.0))


class FrequencyNoise(FrequencyMask):
    """FrequencyMask with noise in the masked bands in place of zeros."""

    def _draw(self, gen, signal):
        shape = _phase_shape(signal)
        return {**super()._draw(gen, signal), "mag": _normal(gen, shape),
                "phase": _normal(gen, shape)}

    def _spectral(self, d, signal):
        return _fill_holes(d, signal.mask_frequencies(
            *self._band_hz(d, signal), val=0.0))


class SpectralDenoising(Equalizer):
    """The spectral gate against an EQ'd noise signal at nz_volume LUFS."""

    NOISE_SAMPLES = 22050

    def __init__(self, eq_amount: Tuple = ("const", 1.0),
                 denoise_amount: Tuple = ("uniform", 0.8, 1.0),
                 nz_volume: float = -40, n_bands: int = 6,
                 n_freq: int = 3, n_time: int = 5, name: str = None,
                 prob: float = 1.0):
        super().__init__(eq_amount=eq_amount, n_bands=n_bands,
                         name=name, prob=prob)
        self.nz_volume = nz_volume
        self.denoise_amount = denoise_amount
        self.n_freq, self.n_time = n_freq, n_time

    def _draw(self, gen, signal):
        return {"noise": _normal(gen, (1, 1, self.NOISE_SAMPLES)),
                **_eq_draws(gen, self.eq_amount, 1, self.n_bands),
                "denoise": float(np.mean(_sample_dist(
                    gen, self.denoise_amount, 1)))}

    def _apply(self, d, signal):
        nz = AudioSignal(d["noise"], signal.sample_rate,
                         device=signal.device)
        nz = nz.normalize(self.nz_volume).equalizer(_eq(d))
        return spectral_gate(signal, nz, d["denoise"], n_freq=self.n_freq,
                             n_time=self.n_time)


TRANSFORMS = {c.__name__: c for c in (
    Identity, Compose, VolumeNorm, VolumeChange, RescaleAudio, ShiftPhase,
    ClippingDistortion, Equalizer, Quantization, MuLawQuantization, LowPass,
    HighPass, Smoothing, BackgroundNoise, RoomImpulseResponse,
    SpectralTransform, Choose, Repeat, RepeatUpTo, NoiseFloor, CrossTalk,
    GlobalVolumeNorm, Silence, InvertPhase, CorruptPhase, FrequencyMask,
    TimeMask, MaskLowMagnitudes, TimeNoise, FrequencyNoise,
    SpectralDenoising)}


def build_transform(augment_prob: float = 1.0,
                    preprocess: Sequence[str] = ("Identity",),
                    augment: Sequence[str] = ("Identity",),
                    postprocess: Sequence[str] = ("Identity",)) -> Compose:
    """Compose(preprocess, augment at augment_prob, postprocess), each a
    Compose of the named transforms at their defaults."""

    def to_tfm(names):
        return [TRANSFORMS[n]() for n in names]

    return Compose(
        Compose(*to_tfm(preprocess), name="preprocess"),
        Compose(*to_tfm(augment), name="augment", prob=augment_prob),
        Compose(*to_tfm(postprocess), name="postprocess"))
