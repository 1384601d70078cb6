"""audiotools of the port (AudioSignal, the transforms) against JAX's.

CPU, float32. The signal: 3 items of 9120 samples at 24 kHz (phase 35's
crop), speech-like (two partials under a syllable envelope, noise), one
item quieter. Every AudioSignal method on both packages' signals, and
every transform with JAX's draws: `jax_draws` replays the JAX
transform's own `jax.random` splits and calls on the same key and hands
the numbers to the port's `apply`; the prob gate's Bernoulli mask is one
of them. Limits:
- sample-wise outputs within 2e-5 of the largest |JAX output| (float32
  FFTs and sums in other orders; loudness-driven gains through float64
  host math on either side); the STFT ones (magnitude, phase) on the
  bins above 1e-3 of the largest magnitude, where the phase is defined:
  the phase within 1e-3 rad, the log-magnitude within 0.01 dB;
- loudness in LUFS within 1e-6 dB; resampling in float64 within 1e-12
  of numpy's correlate (audio_metrics' former copy);
- uniform quantization and the masks' choices exact (identical float32
  inputs); mu-law's expansion within the 2e-5 (exp and log1p differ by an
  ulp between the libraries).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minimax_speech_torch.utils import audio_signal as t_as
from minimax_speech_torch.utils import audio_transforms as t_at
from minimax_speech_tpu.utils import audio_signal as j_as
from minimax_speech_tpu.utils import audio_transforms as j_at
from tests import torch_cpu

torch_cpu.share_cores()

SR, T = 24000, 9120
RTOL = 2e-5


def speech(batch=3, n=T, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    out = []
    for i in range(batch):
        f0 = 110 + 40 * i
        env = 0.5 * (1 + np.sin(2 * np.pi * 4 * t + i))
        x = env * (0.4 * np.sin(2 * np.pi * f0 * t)
                   + 0.2 * np.sin(2 * np.pi * 3.1 * f0 * t)) \
            + 0.02 * rng.standard_normal(n)
        out.append(x * (0.1 if i == 2 else 1.0))
    return np.stack(out)[:, None, :].astype(np.float32)


@pytest.fixture(scope="module")
def audio():
    return speech()


def _pair(audio):
    return j_as.AudioSignal(jnp.asarray(audio), SR), t_as.AudioSignal(
        torch.as_tensor(audio), SR)


def _np(x):
    if isinstance(x, (j_as.AudioSignal, t_as.AudioSignal)):
        x = x.audio_data
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(ours, ref, rtol=RTOL, msg=""):
    ours, ref = _np(ours), _np(ref)
    assert ours.shape == ref.shape, msg
    np.testing.assert_allclose(ours, ref, rtol=0,
                               atol=rtol * max(np.abs(ref).max(), 1e-30),
                               err_msg=msg)


# -------------------------------------------------------------- the signal
def _spec_case(fn):
    """A method that changes stft_data; compared as complex STFTs."""
    def run(sig):
        return fn(sig.clone().stft()).stft_data
    return run


ir = speech(1, 2400, seed=9) * np.exp(-np.arange(2400) / 300.0)
other = speech(3, 7000, seed=5)
METHODS = {
    "stft": lambda s: s.clone().stft().stft_data,
    "istft": lambda s: s.clone().stft().istft(),
    "magnitude": lambda s: s.clone().magnitude(),
    "set_mag_phase": lambda s: s.clone().set_mag_phase(
        s.clone().magnitude(), s.clone().phase() + 0.5).istft(),
    "mask_frequencies": _spec_case(lambda s: s.mask_frequencies(500, 3000)),
    "mask_timesteps": _spec_case(lambda s: s.mask_timesteps(0.1, 0.2)),
    "mask_low_magnitudes": _spec_case(lambda s: s.mask_low_magnitudes(-5)),
    "shift_phase": lambda s: s.clone().shift_phase(1.3).istft(),
    "normalize": lambda s: s.normalize(-20.0),
    "normalize_per_item": lambda s: s.normalize_per_item(
        np.array([-30.0, -20.0, -25.0])),
    "ensure_max_of_audio": lambda s: s.ensure_max_of_audio(0.3),
    "volume_change": lambda s: s.volume_change(-6.5),
    "convolve": lambda s: s.convolve(type(s)(ir, SR)),
    "mix": lambda s: s.mix(type(s)(other, SR), np.array([5.0, 10.0, 0.0])),
    "mix_eq": lambda s: s.mix(type(s)(other, SR), 10.0,
                              -np.linspace(0, 1, 6)[None]),
    "mel_filterbank": lambda s: s.mel_filterbank(5),
    "equalizer": lambda s: s.equalizer(-np.linspace(0.1, 0.9, 12)
                                       .reshape(3, 4)),
    "low_pass": lambda s: s.low_pass(4000),
    "high_pass": lambda s: s.high_pass(500, zeros=21),
    "clip_distortion": lambda s: s.clip_distortion(
        np.array([0.05, 0.0, 0.2], np.float32)),
    "quantization": lambda s: s.quantization(32),
    "mulaw_quantization": lambda s: s.mulaw_quantization(256),
    "to_mono": lambda s: type(s)(np.concatenate(
        [_np(s), 0.5 * _np(s)], axis=1), SR).to_mono(),
    "resample": lambda s: s.resample(16000),
}
EXACT = {"quantization", "to_mono"}


@pytest.mark.parametrize("name", list(METHODS))
def test_audio_signal_methods_match_jax(audio, name):
    j, t = _pair(audio)
    ref, ours = METHODS[name](j), METHODS[name](t)
    if name in ("stft", "mask_frequencies", "mask_timesteps",
                "mask_low_magnitudes"):
        ref, ours = np.asarray(ref), ours.numpy()
        _close(ours.real, ref.real, msg=name)
        _close(ours.imag, ref.imag, msg=name)
        np.testing.assert_array_equal(ours == 0, ref == 0)
    elif name in EXACT:
        np.testing.assert_array_equal(_np(ours), _np(ref))
    else:
        _close(ours, ref, msg=name)
    if isinstance(ours, t_as.AudioSignal):
        assert ours.audio_data.dtype == torch.float32
        assert ours.sample_rate == (16000 if name == "resample" else SR)


def test_phase_loudness_and_resample_match_jax(audio):
    """phase() and log_magnitude() on the bins above 1e-3 of the largest
    magnitude (below, float32 FFT noise decides them); the gated loudness; the
    polyphase resampler in float32 and float64 (float64 on the host is
    what audio_metrics' STOI runs)."""
    j, t = _pair(audio)
    mag = np.asarray(j.clone().magnitude())
    keep = mag > 1e-3 * mag.max()
    dphi = np.angle(np.exp(1j * (t.clone().phase().numpy()
                                 - np.asarray(j.clone().phase()))))
    assert np.abs(dphi[keep]).max() < 1e-3
    # a float32 FFT's error there, 1e-3 relative at most: 0.0087 dB
    np.testing.assert_allclose(t.clone().log_magnitude().numpy()[keep],
                               np.asarray(j.clone().log_magnitude())[keep],
                               rtol=0, atol=0.01)
    np.testing.assert_allclose(t.loudness(), j.loudness(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        t_as.integrated_loudness(audio[0, 0], SR),
        j_as.integrated_loudness(audio[0, 0], SR), rtol=0, atol=1e-6)
    for sr in (16000, 10000, 44100):
        _close(t_as.resample(torch.as_tensor(audio), SR, sr),
               j_as.resample(jnp.asarray(audio), SR, sr), msg=str(sr))
    x = np.random.default_rng(2).standard_normal(5000)
    ours64 = t_as.resample(torch.as_tensor(x), SR, 10000).numpy()
    kernels, up, down, width = t_as._kaiser_sinc_kernel(SR, 10000)
    xp = np.pad(x, (width, width + down))
    ref64 = np.stack([np.correlate(xp, k.astype(np.float64), "valid")
                      for k in kernels], axis=1).reshape(-1)[::down]
    np.testing.assert_allclose(ours64, ref64[: len(ours64)], rtol=0,
                               atol=1e-12)


def test_spectral_gate_write_and_load(audio, tmp_path):
    j, t = _pair(audio)
    nz = speech(1, 22050, seed=7) * 0.05
    ref = j_as.spectral_gate(j, j_as.AudioSignal(nz, SR), 0.9)
    ours = t_as.spectral_gate(t, t_as.AudioSignal(nz, SR), 0.9)
    _close(ours, ref)
    t.write(str(tmp_path / "t.wav"))
    j.write(str(tmp_path / "j.wav"))
    back, jback = t_as.AudioSignal.load(str(tmp_path / "t.wav")), \
        j_as.AudioSignal.load(str(tmp_path / "j.wav"))
    np.testing.assert_array_equal(_np(back), _np(jback))
    assert back.sample_rate == SR and back.signal_length == T


# -------------------------------------------------------------- transforms
def _split_dist(key, dist, batch=1):
    return j_at._sample_dist(key, dist, batch)


def _mean1(key, dist):
    return float(np.mean(_split_dist(key, dist, 1)))


def _eq_draws(key_a, key_e, t, batch):
    return {"amount": _split_dist(key_a, t.eq_amount, batch),
            "eq_u": np.array(jax.random.uniform(key_e,
                                                  (batch, t.n_bands)))}


def _phase_shape(s):
    return tuple(s.clone().phase().shape)


def _tfm_draws(t, k, s):
    """The JAX transform's draws on key k (its k_tfm) over signal s."""
    name, b = type(t).__name__, s.batch_size
    if name in ("Identity", "RescaleAudio", "Silence", "InvertPhase",
                "SpectralTransform"):
        return {}
    if name in ("Compose", "Repeat"):
        each = []
        for sub in t.transforms:
            k, kk = jax.random.split(k)
            each.append(jax_draws(sub, kk, s))
        return {"each": each}
    if name in ("Choose", "RepeatUpTo"):
        k_c, *keys = jax.random.split(k, len(t.transforms) + 1)
        idx = np.array(jax.random.choice(
            k_c, len(t.transforms), (b,), p=jnp.asarray(t.weights)))
        each = []
        for t_i, (sub, kk) in enumerate(zip(t.transforms, keys)):
            rows = np.nonzero(idx == t_i)[0]
            each.append(jax_draws(sub, kk, j_as.AudioSignal(
                s.audio_data[rows], s.sample_rate)) if rows.size else None)
        return {"idx": idx, "each": each}
    if name == "VolumeNorm":
        return {} if t.db[0] in ("const", "lufs") else {
            "db": np.array(jax.random.uniform(k, (b,), minval=t.db[1],
                                                maxval=t.db[2]))}
    if name in ("VolumeChange", "ShiftPhase"):
        lo, hi = (t.db if name == "VolumeChange" else t.shift)[1:3]
        key = "db" if name == "VolumeChange" else "shift"
        return {key: np.array(jax.random.uniform(
            k, (b,), minval=float(lo), maxval=float(hi)))}
    if name == "ClippingDistortion":
        return {"perc": _split_dist(k, t.perc, b)}
    if name in ("Equalizer",):
        return _eq_draws(*jax.random.split(k), t, b)
    if name in ("Quantization", "MuLawQuantization"):
        return {"channels": _split_dist(k, t.channels)}
    if name in ("LowPass", "HighPass"):
        return {"cutoff": _split_dist(k, t.cutoff)}
    if name == "Smoothing":
        k_t, k_l = jax.random.split(k)
        return {"type": _split_dist(k_t, t.window_type),
                "length": int(_split_dist(k_l, t.window_length))}
    if name in ("BackgroundNoise", "CrossTalk"):
        if name == "BackgroundNoise":
            k_n, k_s, k_a, k_e = jax.random.split(k, 4)
        else:
            k_n, k_s = jax.random.split(k)
        noise = ({"source": int(jax.random.randint(k_n, (), 0,
                                                   len(t.sources)))}
                 if t.sources is not None else {"white": np.array(
                     jax.random.normal(k_n, (b, 1, s.signal_length)))})
        d = {**noise, "snr": _split_dist(k_s, t.snr, b)}
        if name == "BackgroundNoise":
            d.update(_eq_draws(k_a, k_e, t, b))
        return d
    if name == "RoomImpulseResponse":
        k_i, k_d, k_a, k_e = jax.random.split(k, 4)
        return {"ir": t._ir(k_i, s.sample_rate), "drr": _mean1(k_d, t.drr),
                **_eq_draws(k_a, k_e, t, b)}
    if name == "NoiseFloor":
        k_d, k_n = jax.random.split(k)
        return {"db": _split_dist(k_d, t.db, b), "noise": np.array(
            jax.random.normal(k_n, s.audio_data.shape))}
    if name == "GlobalVolumeNorm":
        return {"db": _mean1(k, t.db)}
    if name == "CorruptPhase":
        k_s, k_n = jax.random.split(k)
        return {"scale": _mean1(k_s, t.scale), "noise": np.array(
            jax.random.normal(k_n, _phase_shape(s)))}
    if name in ("FrequencyMask", "TimeMask", "TimeNoise", "FrequencyNoise"):
        if name in ("TimeNoise", "FrequencyNoise"):
            k, k_a, k_p = jax.random.split(k, 3)
        k_c, k_w = jax.random.split(k)
        c, w = (t.f_center, t.f_width) if "Frequency" in name \
            else (t.t_center, t.t_width)
        d = {"center": _mean1(k_c, c), "width": _mean1(k_w, w)}
        if name in ("TimeNoise", "FrequencyNoise"):
            shape = _phase_shape(s)
            d.update(mag=np.array(jax.random.normal(k_a, shape)),
                     phase=np.array(jax.random.normal(k_p, shape)))
        return d
    if name == "MaskLowMagnitudes":
        return {"db": _mean1(k, t.db_cutoff)}
    if name == "SpectralDenoising":
        k_n, k_a, k_e, k_d = jax.random.split(k, 4)
        return {"noise": np.array(jax.random.normal(k_n, (1, 1, 22050))),
                **_eq_draws(k_a, k_e, t, 1),
                "denoise": _mean1(k_d, t.denoise_amount)}
    raise KeyError(name)


def jax_draws(t, key, s):
    """BaseTransform.__call__'s draws: the gate's mask from k_gate, the
    transform's from k_tfm, as the port's draw() lays them out."""
    k_gate, k_tfm = jax.random.split(key)
    if t.prob <= 0.0:
        return {}
    d = {}
    if t.prob < 1.0:
        d["apply"] = np.array(jax.random.bernoulli(
            k_gate, t.prob, (s.batch_size,)))
    d["tfm"] = _tfm_draws(t, k_tfm, s)
    return d


BANK = speech(2, 5000, seed=11)[:, 0]
IR_BANK = np.stack([np.exp(-np.arange(3000) / 400.0)
                    * np.cos(np.arange(3000) / 7.0)] * 2).astype(np.float32)
IR_BANK[1, 50] = 1.5  # a late peak: the DRR's early window moves there


def _cases():
    """{case id: (class name, its keyword arguments, or the name of a
    composite that _make assembles)}."""
    cases = {n: (n, {}) for n in t_at.TRANSFORMS
             if n not in ("Compose", "Choose", "Repeat", "RepeatUpTo")}
    cases.update({
        "VolumeNorm_uniform": ("VolumeNorm", {"db": ("uniform", -30, -10)}),
        "BackgroundNoise_bank": ("BackgroundNoise", {"sources": BANK}),
        "RoomImpulseResponse_bank": ("RoomImpulseResponse",
                                     {"sources": IR_BANK}),
        "CrossTalk_bank": ("CrossTalk", {"sources": BANK}),
        "Smoothing_hann": ("Smoothing", {"window_type": ("const", "hann")}),
        "ClippingDistortion_const": ("ClippingDistortion",
                                     {"perc": ("const", 0.1)}),
        "VolumeChange_gate": ("VolumeChange", {"prob": 0.5}),
        "Silence_gate": ("Silence", {}),
        "Compose": ("Compose", "compose"),
        "Choose": ("Choose", "choose"),
        "Repeat": ("Repeat", "repeat"),
        "RepeatUpTo": ("RepeatUpTo", "repeat_up_to"),
    })
    return cases


CASES = _cases()


def _make(mod, case):
    name, kw = CASES[case]
    if kw == "compose":
        return mod.Compose(mod.VolumeChange(), mod.LowPass(prob=0.6),
                           mod.Compose(mod.ShiftPhase(), mod.NoiseFloor()),
                           prob=0.7)
    if kw == "choose":
        return mod.Choose(mod.VolumeChange(), mod.HighPass(),
                          mod.Quantization(), weights=[0.5, 0.3, 0.2])
    if kw == "repeat":
        return mod.Repeat(mod.VolumeChange(), n_repeat=3)
    if kw == "repeat_up_to":
        return mod.RepeatUpTo(mod.Equalizer(), max_repeat=4)
    return getattr(mod, name)(**kw)


@pytest.mark.parametrize("case", list(CASES))
def test_transform_matches_jax_with_its_draws(audio, case):
    """The JAX transform on key 7; the port's apply on JAX's draws; then
    the port's own draw() has the same layout and its call runs."""
    jt, tt = _make(j_at, case), _make(t_at, case)
    j, t = _pair(audio)
    for s in (j, t):
        s.metadata["loudness"] = -18.5  # GlobalVolumeNorm reads it
    key = jax.random.PRNGKey(7)
    draws = jax_draws(jt, key, j)
    ref = jt(key, j)
    ours = tt.apply(draws, t)
    if case in ("Quantization", "Silence",
                "Silence_gate", "InvertPhase", "Identity"):
        np.testing.assert_array_equal(_np(ours), _np(ref))
    else:
        _close(ours, ref, msg=case)
    if "apply" in draws:  # the gate both ways within the batch
        assert 0 < draws["apply"].sum() < 3 or case != "VolumeChange_gate"

    def layout(d):
        if isinstance(d, dict):
            return {k: layout(v) for k, v in d.items()
                    if k not in ("each", "idx")} | (
                {"each": len(d["each"])} if "each" in d else {})
        return type(d).__name__ if not np.isscalar(d) else "scalar"

    own = tt.draw(torch.Generator().manual_seed(0), t)
    if "each" not in own.get("tfm", {}):
        assert own.keys() == draws.keys()
        assert own.get("tfm", {}).keys() == draws.get("tfm", {}).keys()
    out = tt.apply(own, t)
    assert out.audio_data.shape == t.audio_data.shape
    assert torch.isfinite(out.audio_data).all()


def test_build_transform_and_prob_gate(audio):
    """build_transform's three stages with augment_prob 0.5 on JAX's
    draws; at prob 0 the augment stage draws nothing and changes
    nothing."""
    names = dict(preprocess=["VolumeNorm"], augment=["LowPass", "Equalizer"],
                 postprocess=["RescaleAudio"])
    jt = j_at.build_transform(0.5, **names)
    tt = t_at.build_transform(0.5, **names)
    j, t = _pair(audio)
    key = jax.random.PRNGKey(3)
    draws = jax_draws(jt, key, j)
    gate = draws["tfm"]["each"][1]["apply"]
    assert 0 < gate.sum() < len(gate)  # some items augmented, some not
    _close(tt.apply(draws, t), jt(key, j))
    off = t_at.build_transform(0.0, **names)
    d = off.draw(torch.Generator().manual_seed(1), t)
    assert d["tfm"]["each"][1] == {}
    _close(off.apply(d, t),
           t_at.Compose(t_at.VolumeNorm(), t_at.RescaleAudio()).apply(
               {"tfm": {"each": [d["tfm"]["each"][0],
                                 d["tfm"]["each"][2]]}}, t))
