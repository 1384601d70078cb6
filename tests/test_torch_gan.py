"""The GAN training modules of the port against the JAX package, on the
CPU: the STFT magnitude and the differentiable HiFi-GAN mel
(ops/mel.py), YIN f0 (ops/pitch.py), the spectral losses
(utils/audio_losses.py), the GAN losses (utils/losses.py) and the
discriminators (models/discriminators.py), at tiny geometries, weights
jittered and loaded by both packages through the bridge.

Tolerances (float32 on both sides, sums in other orders): discriminator
scores and feature maps within 1e-5 of each map's largest element;
spectral and GAN losses 1e-5 relative; STFT magnitudes and mels within
1e-5 of their largest; YIN f0 identical (float64 numpy on both sides).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minimax_speech_torch.models import discriminators as t_disc
from minimax_speech_torch.ops import mel as t_mel
from minimax_speech_torch.ops import pitch as t_pitch
from minimax_speech_torch.utils import audio_losses as t_al
from minimax_speech_torch.utils import losses as t_loss
from minimax_speech_torch.utils import params_io as t_io
from minimax_speech_tpu.models import discriminators as j_disc
from minimax_speech_tpu.ops import mel as j_mel
from minimax_speech_tpu.ops import pitch as j_pitch
from minimax_speech_tpu.utils import audio_losses as j_al
from minimax_speech_tpu.utils import losses as j_loss
from tests.conftest import synthetic_audio
from tests.test_torch_bridge import jitter
from tests import torch_cpu

torch_cpu.share_cores()

TINY_DAC_DISC = dict(periods=(2, 3), fft_sizes=(256,), rates=(2,))
TINY_COSY_DISC = dict(periods=(2, 5), fft_sizes=(256, 128),
                      hop_sizes=(64, 30), win_lengths=(128, 96))


def _close(ours, ref, tol=1e-5, msg=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(ours), ref,
                               atol=tol * max(np.abs(ref).max(), 1e-12),
                               rtol=0, err_msg=msg)


def _audio(rng, b=2, n=2400, scale=0.3):
    return (rng.standard_normal((b, n)) * scale).astype(np.float32)


@pytest.mark.parametrize("n_fft,hop,win,center,pad,power,eps", [
    (256, 64, 128, True, None, 1.0, 1e-12),   # SpecDiscriminator's
    (1920, 480, 1920, False, 720, 2.0, 0.0),  # hifigan_log_mel's
    (128, 30, 96, True, None, 2.0, 0.0),
    (512, 128, 512, False, None, 0.5, 1e-6)])
def test_stft_magnitude_matches_jax(rng, n_fft, hop, win, center, pad,
                                    power, eps):
    x = _audio(rng, n=6000)
    ref = j_mel.stft_magnitude(jnp.asarray(x), n_fft, hop, win, center=center,
                               pad=pad, power=power, eps=eps)
    ours = t_mel.stft_magnitude(torch.as_tensor(x), n_fft, hop, win,
                                center=center, pad=pad, power=power, eps=eps)
    assert ours.shape == ref.shape
    _close(ours, ref)


def test_hifigan_log_mel_matches_jax_and_host(rng):
    """The tensor mel against JAX's and against the port's host twin; its
    gradient against JAX's within 1e-5 of the largest."""
    x = synthetic_audio(rng, 0.7, 24000)[None].repeat(2, 0)
    x[1] *= 0.2
    ref = j_mel.hifigan_log_mel(jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_(True)
    ours = t_mel.hifigan_log_mel(xt)
    _close(ours.detach(), ref)
    _close(ours.detach(), t_mel.hifigan_log_mel_np(x), 1e-5)
    w = rng.standard_normal(ref.shape).astype(np.float32)
    gref = jax.grad(lambda a: jnp.sum(j_mel.hifigan_log_mel(a) * w))(
        jnp.asarray(x))
    (ours * torch.as_tensor(w)).sum().backward()
    _close(xt.grad, gref)


def test_yin_f0_identical(rng):
    """Voiced tones, a glide, noise and silence: identical f0."""
    sr = 24000
    t = np.arange(int(0.8 * sr)) / sr
    sig = np.concatenate([
        0.5 * np.sin(2 * np.pi * 180.0 * t[: sr // 4]),
        0.4 * np.sin(2 * np.pi * (120.0 + 200.0 * t[: sr // 4]) * t[: sr // 4]),
        0.05 * rng.standard_normal(sr // 5), np.zeros(sr // 10)]).astype(
        np.float32)
    ours = t_pitch.yin_f0(sig, sr, 480)
    ref = j_pitch.yin_f0(sig, sr, 480)
    assert ours.dtype == ref.dtype and (ours > 0).any() and (ours == 0).any()
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("scale", [0.3, 0.01])
def test_spectral_losses_match_jax(rng, scale):
    """multi_scale_stft_loss, mel_spectrogram_loss (the seven scales),
    l1_loss and sisdr_loss, 1e-5 relative."""
    x, y = _audio(rng, scale=scale), _audio(rng)
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)
    for name, args in (("multi_scale_stft_loss", ()),
                       ("multi_scale_stft_loss", ((256, 64),)),
                       ("mel_spectrogram_loss", (24000,)),
                       ("l1_loss", ()), ("sisdr_loss", ())):
        ref = float(getattr(j_al, name)(xj, yj, *args))
        ours = float(getattr(t_al, name)(xt, yt, *args))
        np.testing.assert_allclose(ours, ref, rtol=1e-5, err_msg=name)


def _scores(rng, shapes, offset=0.0):
    return [rng.standard_normal(s).astype(np.float32) + offset
            for s in shapes]


def test_gan_losses_match_jax(rng):
    """discriminator_loss, generator_adv_loss, feature_matching_loss,
    tpr_loss (odd counts) and kl_loss, 1e-5 relative."""
    shapes = [(2, 1, 13, 2), (2, 1, 9, 3), (2, 221)]
    real, fake = _scores(rng, shapes, 0.5), _scores(rng, shapes)
    rf = [_scores(rng, [(2, 4, 7, 3), (2, 1, 5, 2)]) for _ in shapes]
    ff = [_scores(rng, [(2, 4, 7, 3), (2, 1, 5, 2)]) for _ in shapes]
    j, t = (lambda v: [jnp.asarray(a) for a in v]), \
        (lambda v: [torch.as_tensor(a) for a in v])
    cases = [
        ("discriminator_loss", (j(real), j(fake)), (t(real), t(fake))),
        ("generator_adv_loss", (j(fake),), (t(fake),)),
        ("feature_matching_loss", ([j(f) for f in rf], [j(f) for f in ff]),
         ([t(f) for f in rf], [t(f) for f in ff])),
        ("tpr_loss", (j(real), j(fake), 0.04), (t(real), t(fake), 0.04)),
        ("tpr_loss", (j(real), j(fake), 5.0), (t(real), t(fake), 5.0))]
    mu, logs = _scores(rng, [(2, 19, 6)] * 2)
    cases.append(("kl_loss", (jnp.asarray(mu), jnp.asarray(logs)),
                  (torch.as_tensor(mu), torch.as_tensor(logs))))
    for name, ja, ta in cases:
        np.testing.assert_allclose(float(getattr(t_loss, name)(*ta)),
                                   float(getattr(j_loss, name)(*ja)),
                                   rtol=1e-5, err_msg=name)


def test_tpr_loss_median_averages_at_even_count():
    """An even count (4): jnp.median averages the two middle values,
    torch.median takes the lower. With d = real - fake = [0, 1, 3, 10]
    the median is 2, the elements below it 0 and 1, L = (4 + 1) / 2 =
    2.5; the lower median (1) gives L = 1. tau 10 keeps L untruncated."""
    real = [np.array([[0.0, 1.0], [3.0, 10.0]], np.float32)]
    fake = [np.zeros((2, 2), np.float32)]
    ref = float(j_loss.tpr_loss([jnp.asarray(a) for a in real],
                                [jnp.asarray(a) for a in fake], 10.0))
    ours = float(t_loss.tpr_loss([torch.as_tensor(a) for a in real],
                                 [torch.as_tensor(a) for a in fake], 10.0))
    assert ref == ours == 2.5
    d = torch.as_tensor(real[0] - fake[0])
    assert float(torch.median(d)) == 1.0 and float(t_loss.median(d)) == 2.0
    x = torch.randn(64, generator=torch.Generator().manual_seed(0))
    assert float(t_loss.median(x)) == float(jnp.median(jnp.asarray(
        x.numpy())))


def _nhwc(x):
    """A torch map as the JAX package lays it out: (B, C, H, W) ->
    (B, H, W, C), (B, C, T) -> (B, T, C)."""
    return x.permute(0, 2, 3, 1) if x.dim() == 4 else x.transpose(1, 2)


@pytest.mark.parametrize("kind", ["dac", "cosyvoice"])
def test_discriminators_match_jax(rng, kind):
    """Scores and every feature map (MPD with a tail pad, MSD at rate 2,
    MRD bands, spectral discriminators) within 1e-5 of each one's
    largest element; the bridge maps every flax leaf, the auto-named
    ones too, and round-trips."""
    if kind == "dac":
        jd, td = j_disc.DACDiscriminator(**TINY_DAC_DISC), \
            t_disc.DACDiscriminator(**TINY_DAC_DISC)
        x = _audio(rng, n=2401)  # 2401 = 1 mod 2 and 3: a tail pad each
    else:
        jd, td = j_disc.CosyVoiceDiscriminator(**TINY_COSY_DISC), \
            t_disc.CosyVoiceDiscriminator(**TINY_COSY_DISC)
        x = _audio(rng, n=2403)
    variables = jitter(jax.jit(jd.init)(jax.random.PRNGKey(0),
                                        jnp.asarray(x)), seed=1)
    t_io.load_flax_params(td, variables)
    back = t_io._flatten(t_io.to_flax_params(td))
    for k, v in t_io._flatten(variables).items():
        np.testing.assert_array_equal(back[k], np.asarray(v))
    rs, rf = jd.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        ts, tf = td(torch.as_tensor(x))
    assert len(ts) == len(rs) and len(tf) == len(rf)
    for i, (s, r) in enumerate(zip(ts, rs)):
        s = s if s.dim() == 2 else _nhwc(s)
        assert tuple(s.shape) == r.shape, i
        _close(s, r, msg=f"score {i}")
        for j, (a, b) in enumerate(zip(tf[i], rf[i])):
            _close(_nhwc(a), b, msg=f"fmap {i}.{j}")


def test_discriminator_random_init_scales():
    """The port's random WNConv2d: g equals |v| per output channel and
    v lies within 1/sqrt(fan_in), as flax's init draws it."""
    d = t_io.init_params(t_disc.MPD(3, channels=(8, 16, 16, 16, 16)),
                         torch.Generator().manual_seed(0))
    for conv in d.convs:
        fan_in = conv.v[0].numel()
        assert float(conv.v.detach().abs().max()) <= fan_in ** -0.5
        torch.testing.assert_close(
            conv.g, torch.sqrt(conv.v.square().sum((1, 2, 3)) + 1e-12))
        assert not conv.bias.any()


def test_gan_gradient_jumps_under_a_tiny_nudge():
    """Why chip_smoke.py phase 37 holds the GAN iteration's gradients
    card vs CPU in float64 only: the discriminators' leaky ReLUs make the
    gradient a discontinuous function of the input. On phase 37's
    reduced DAC iteration in float64, moving the batch by GAN_NUDGE (1e-6
    relative, float32 rounding's scale after a few layers) keeps the
    median leaf within 1e-5 of its largest and moves some leaf by more
    than 1e-4 (the port alone, no JAX). One crop of 0.1 s shows both (phase
    37 runs 2 x 0.3 s; at 1 x 0.2 s the median lies above 1e-5)."""
    import chip_smoke as cs
    from minimax_speech_torch.infer.pipeline import TTSConfig

    cfg, disc_kw = cs.reduced_gan("dac", TTSConfig().dac)
    data = cs.gan_batch("dac", cfg, 1, 0.1, seed=3)
    base = cs.gan_iteration("dac", cfg, disc_kw, data, "cpu",
                            torch.float64)[1]
    moves = []
    for seed in range(2):
        rng = np.random.default_rng(seed)
        audio = data["audio"] * (1 + cs.GAN_NUDGE * rng.standard_normal(
            data["audio"].shape))
        moves += cs.grad_errors(cs.gan_iteration(
            "dac", cfg, disc_kw, {"audio": audio.astype(np.float32)}, "cpu",
            torch.float64)[1], base).values()
    assert max(moves) > 1e-4
    assert float(np.median(moves)) < 1e-5
