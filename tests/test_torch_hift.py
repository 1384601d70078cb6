"""The HiFT vocoder of the port (models/hifigan.py, ops/mel.py's framing
and inverse STFT) against the JAX package's.

CPU, float32, at tests/test_hifigan.py's SMALL geometry and at the full
HiFTConfig of configs/default.yaml on a short mel. The weights are the
port's seeded init, jittered, bridged to JAX's tree by params_io. Random
weights leave f0 far below the 10 Hz voicing threshold, where the sine
source is exactly 0 and the sine, STFT and source_downs path would go
untested; so the f0 classifier's bias is set to 100-300 Hz (drawn from
the seed) in both trees, and every test that runs the f0 predictor
asserts that at least half of its frames are voiced.

The source's harmonic phases are a long cumsum of f h / sr, which the
two packages sum their own ways (JAX's scan in float32, the port in
float64 on every device, since the card's float32 cumsum lay up to half
a cycle off at 5 s). So the decode and the source are held apart:
- `decode` on one shared source on both sides: DECODE_TOL;
- each side's phase against a float64 cumsum: chip_smoke.phase_tol,
  ceil(log2 n)/2 ulp of the largest cumulative phase S over n samples (a
  bound that grows with the length; measured at n = 120000: a float32
  cumsum on the CPU 0.56 ulp, the JAX package's 3.4, the port's float64
  one 2e-4);
- the source: the sines within alpha 2 pi twice that of JAX's, the merge
  within sum|w| of that;
- the whole forward: by the triangle inequality, within the port's own
  response to the two sources (decode_t(src_t) against decode_t(src_j))
  plus DECODE_TOL; that response is at most chip_smoke.DECODE_GAIN times
  the sources' distance (measured 0.99-1.11 at these weights;
  tests/test_torch_mel_mode.py and chip_smoke.py's phase 26 derive their
  PCM limits from these constants).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minimax_speech_torch.models import hifigan as t_h
from minimax_speech_torch.ops import mel as t_mel
from minimax_speech_torch.utils import params_io as t_io
from minimax_speech_tpu.models import hifigan as j_h
from minimax_speech_tpu.ops import mel as j_mel
from chip_smoke import DECODE_GAIN, phase_tol
from tests.test_torch_bridge import jitter, port_config
from tests import torch_cpu

torch_cpu.share_cores()

# decode on a shared source: float32 sums in other orders through the
# convolutions and the iSTFT, on audio in [-0.99, 0.99]
DECODE_TOL = 5e-6
SMALL = j_h.HiFTConfig(in_channels=8, base_channels=32,
                       upsample_rates=(4, 3), upsample_kernel_sizes=(8, 5),
                       resblock_kernel_sizes=(3,),
                       resblock_dilations=((1, 2),),
                       source_resblock_kernel_sizes=(3, 3),
                       source_resblock_dilations=((1,), (1,)),
                       f0_cond_channels=16)
GEOMETRIES = {"small": (SMALL, 20), "full": (j_h.HiFTConfig(), 12)}


def voiced_share(f0, cfg) -> float:
    share = float((np.asarray(f0) > cfg.nsf_voiced_threshold).mean())
    print(f"voiced share {share:.3f}")
    assert share >= 0.5
    return share


@pytest.fixture(scope="module", params=list(GEOMETRIES))
def voc(request):
    """(JAX model, its tree, the port's twin, mel (2, T, C)) with voiced
    f0 and the JAX forward's (wav, source) jitted once per geometry."""
    jcfg, frames = GEOMETRIES[request.param]
    pcfg = port_config(jcfg, t_h.HiFTConfig)
    seed = 3 if request.param == "small" else 4
    init = t_io.init_params(t_h.HiFTGenerator(pcfg),
                            torch.Generator().manual_seed(seed))
    tree = jitter(t_io.to_flax_params(init), seed=seed)
    rng = np.random.default_rng(seed)
    tree["params"]["f0_predictor"]["classifier"]["bias"][:] = \
        rng.uniform(100.0, 300.0)
    port = t_io.load_flax_params(t_h.HiFTGenerator(pcfg).eval(), tree)
    mel = rng.standard_normal((2, frames, jcfg.in_channels)).astype(
        np.float32)
    model = j_h.HiFTGenerator(jcfg)
    forward = jax.jit(model.apply)
    wav_j, src_j = forward(tree, jnp.asarray(mel))
    return dict(model=model, tree=tree, port=port, mel=mel, cfg=jcfg,
                forward=forward, wav_j=np.asarray(wav_j),
                src_j=np.asarray(src_j))


def test_frame_signal_identical():
    x = np.random.default_rng(0).standard_normal((3, 101)).astype(np.float32)
    np.testing.assert_array_equal(
        t_mel.frame_signal(torch.as_tensor(x), 16, 4).numpy(),
        np.asarray(j_mel.frame_signal(jnp.asarray(x), 16, 4)))


@pytest.mark.parametrize("n_fft,hop,frames", [(16, 4, 41), (16, 4, 3),
                                              (12, 5, 9)])
def test_istft_matches_jax_and_torch(n_fft, hop, frames):
    """JAX's istft and torch.istft (center=True, periodic Hann) on random
    spectra: 1e-6 of the output's scale."""
    rng = np.random.default_rng(n_fft + frames)
    re, im = (rng.standard_normal((2, n_fft // 2 + 1, frames)).astype(
        np.float32) for _ in range(2))
    ours = t_mel.istft(torch.as_tensor(re), torch.as_tensor(im), n_fft, hop)
    ref = np.asarray(j_mel.istft(jnp.asarray(re), jnp.asarray(im), n_fft,
                                 hop))
    assert ours.shape == ref.shape == (2, hop * (frames - 1))
    np.testing.assert_allclose(ours.numpy(), ref,
                               atol=1e-6 * max(np.abs(ref).max(), 1.0))
    if frames > 1 and n_fft % hop == 0:
        lib = torch.istft(torch.complex(torch.as_tensor(re),
                                        torch.as_tensor(im)), n_fft, hop,
                          window=torch.hann_window(n_fft), center=True)
        np.testing.assert_allclose(ours.numpy(), lib.numpy(), atol=1e-6 * max(
            np.abs(ref).max(), 1.0))
    short = t_mel.istft(torch.as_tensor(re), torch.as_tensor(im), n_fft, hop,
                        length=3)
    assert short.shape == (2, min(3, ref.shape[1]))


def test_stft_matches(voc):
    x = np.random.default_rng(1).standard_normal((2, 480)).astype(np.float32)
    re_j, im_j = voc["model"].apply(voc["tree"], jnp.asarray(x),
                                    method=j_h.HiFTGenerator._stft)
    re_t, im_t = voc["port"]._stft(torch.as_tensor(x))
    for a, b in ((re_t, re_j), (im_t, im_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def _f0_up(frames: int, seed: int):
    """(2, frames * 480) upsampled f0: 100-300 Hz, a quarter of the
    frames unvoiced (below the threshold)."""
    rng = np.random.default_rng(seed)
    f0 = rng.uniform(100.0, 300.0, (2, frames))
    f0[:, rng.permutation(frames)[: frames // 4]] = rng.uniform(0.0, 5.0)
    return np.repeat(f0, 480, axis=-1).astype(np.float32)


def _sine_tol(cfg, f0_up) -> float:
    """The sines' limit: each side within phase_tol of float64."""
    s_max = float(f0_up.astype(np.float64).sum(1).max()) * (
        cfg.nb_harmonics + 1) / cfg.sampling_rate
    return cfg.nsf_alpha * 2 * math.pi * 2 * phase_tol(f0_up.shape[1],
                                                       s_max)


@pytest.mark.parametrize("keyed", [False, True])
def test_sine_source_matches(keyed):
    """key=None (no noise, zero phases) and a key, whose phases and noise
    JAX draws (hifigan.py:101-105) and the port is given."""
    cfg = j_h.HiFTConfig()
    pcfg = port_config(cfg, t_h.HiFTConfig)
    f0_up = _f0_up(40, 2)
    voiced_share(f0_up, cfg)
    key = jax.random.PRNGKey(5) if keyed else None
    ref = np.asarray(j_h.sine_source(jnp.asarray(f0_up), cfg, key))
    phase = noise = None
    if keyed:
        k1, k2 = jax.random.split(key)
        h = cfg.nb_harmonics + 1
        phase = jax.random.uniform(k1, (2, 1, h), minval=-jnp.pi,
                                   maxval=jnp.pi).at[:, :, 0].set(0.0)
        noise = jax.random.normal(k2, f0_up.shape + (h,))
        phase, noise = (torch.tensor(np.asarray(a)) for a in (phase, noise))
    ours = t_h.sine_source(torch.as_tensor(f0_up), pcfg, phase=phase,
                           noise=noise).numpy()
    unvoiced = f0_up < cfg.nsf_voiced_threshold
    if not keyed:
        assert (ours[unvoiced] == 0).all() and (ref[unvoiced] == 0).all()
    np.testing.assert_allclose(ours, ref, atol=_sine_tol(cfg, f0_up) + 1e-6)
    gen = t_h.sine_source(torch.as_tensor(f0_up), pcfg,
                          generator=torch.Generator().manual_seed(1))
    assert (gen[torch.as_tensor(unvoiced)] != 0).any()


def test_harmonic_phase_against_float64():
    """5 s (250 frames x 480 samples) of 100-300 Hz, 9 harmonics: the
    port's phase and the JAX package's expression (hifigan.py:97-100)
    each within phase_tol of a float64 cumsum, in cycles."""
    cfg = j_h.HiFTConfig()
    f0_up = _f0_up(250, 3)
    h = np.arange(1, cfg.nb_harmonics + 2)
    rad = f0_up.astype(np.float64)[:, :, None] * h / cfg.sampling_rate
    cum = np.cumsum(rad, axis=1)
    truth = cum % 1.0
    tol = phase_tol(f0_up.shape[1], float(cum.max()))
    ours = t_h.harmonic_phase(torch.as_tensor(f0_up),
                              port_config(cfg, t_h.HiFTConfig)).numpy()
    rad_j = jnp.asarray(f0_up)[:, :, None] * jnp.asarray(h, jnp.float32) \
        / cfg.sampling_rate
    theirs = np.asarray(jnp.cumsum(rad_j, axis=1) % 1.0)
    for name, got in (("port", ours / (2 * np.pi)), ("jax", theirs)):
        d = np.abs((got - truth + 0.5) % 1.0 - 0.5).max()
        print(f"{name}: {d:.3e} cycles from float64 (S {cum.max():.0f}, "
              f"tol {tol:.3e})")
        assert d <= tol, name


def test_resblock_and_f0_predictor_match(voc):
    cfg, tree = voc["cfg"], voc["tree"]["params"]
    rng = np.random.default_rng(4)
    ch = cfg.base_channels // 2
    x = rng.standard_normal((2, 30, ch)).astype(np.float32)
    k, d = cfg.resblock_kernel_sizes[0], tuple(cfg.resblock_dilations[0])
    ref = np.asarray(j_h.ResBlock(ch, k, d).apply(
        {"params": tree["resblocks_0"]}, jnp.asarray(x)))
    with torch.no_grad():
        ours = voc["port"].resblocks[0](
            torch.as_tensor(x).transpose(1, 2)).transpose(1, 2).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-5 * np.abs(ref).max())
    f0_j = np.asarray(voc["model"].apply(
        voc["tree"], jnp.asarray(voc["mel"]),
        method=j_h.HiFTGenerator.predict_f0))
    with torch.no_grad():
        f0_t = voc["port"].predict_f0(torch.as_tensor(voc["mel"])).numpy()
    voiced_share(f0_j, cfg)
    np.testing.assert_allclose(f0_t, f0_j, rtol=1e-5)


def test_decode_on_a_shared_source(voc):
    """The JAX forward's own source into the port's decode: DECODE_TOL."""
    with torch.no_grad():
        ours = voc["port"].decode(torch.as_tensor(voc["mel"]),
                                  torch.tensor(voc["src_j"])).numpy()
    ref = voc["wav_j"]
    assert ours.shape == ref.shape == (
        2, voc["mel"].shape[1] * voc["cfg"].total_upsample)
    assert np.abs(ref).max() > 0.05
    np.testing.assert_allclose(ours, ref, atol=DECODE_TOL)


@pytest.mark.parametrize("cached", [False, True])
def test_forward_matches(voc, cached):
    """The whole forward, without and with a cache_source of half the
    samples (spliced on both sides): the source within its derived limit,
    the waveform within the port's response to the two sources plus
    DECODE_TOL, that response within DECODE_GAIN."""
    cfg, mel = voc["cfg"], torch.as_tensor(voc["mel"])
    wav_j, src_j = voc["wav_j"], voc["src_j"]
    cache = None
    if cached:
        cache = src_j[:, : src_j.shape[1] // 2]
        wav_j, src_j = (np.asarray(a) for a in voc["forward"](
            voc["tree"], jnp.asarray(voc["mel"]),
            cache_source=jnp.asarray(cache)))
    with torch.no_grad():
        f0 = voc["port"].predict_f0(mel).numpy()
        wav_t, src_t = voc["port"](
            mel, cache_source=None if cache is None else torch.tensor(cache))
        response = voc["port"].decode(mel, torch.tensor(src_j))
    voiced_share(f0, cfg)
    wav_t, src_t = wav_t.numpy(), src_t.numpy()
    if cached:
        np.testing.assert_array_equal(src_t[:, : cache.shape[1]], cache)
    f0_up = np.repeat(f0, cfg.total_upsample, axis=-1)
    w = np.abs(voc["tree"]["params"]["source_linear"]["kernel"]).sum()
    src_d = float(np.abs(src_t - src_j).max())
    assert src_d <= w * _sine_tol(cfg, f0_up) + 1e-6
    own = float(np.abs(wav_t - response.numpy()).max())
    assert own <= DECODE_GAIN * src_d + DECODE_TOL
    print(f"source {src_d:.2e} apart, the decode's response {own:.2e}")
    np.testing.assert_allclose(wav_t, wav_j, atol=own + DECODE_TOL)
    assert np.abs(wav_t).max() <= cfg.audio_limit
