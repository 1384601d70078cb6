"""HiFT vocoder GAN training in the port against the JAX package, on the
CPU: one iteration of train/gan_steps.make_hift_steps (the
discriminator's step, then the generator's, with and without the f0
loss) at a tiny geometry, jittered weights with a voiced f0 loaded by
both packages, the sine source's phases and noise rebuilt from JAX's
key; and the data of cli/train_hift.py: AudioFolder's crops
(data/audio_folder.py), the --train_data chain and padding_gan
(data/pipeline.py). Tolerances as tests/test_torch_codec_train.py
states them; data identical.
"""
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minimax_speech_torch.data import audio_folder as t_af
from minimax_speech_torch.data import pipeline as t_dp
from minimax_speech_torch.models import discriminators as t_disc
from minimax_speech_torch.models import hifigan as t_h
from minimax_speech_torch.train import gan_steps as t_gan
from minimax_speech_torch.train import schedule as t_sched
from minimax_speech_torch.train import steps as t_steps
from minimax_speech_torch.utils import params_io as t_io
from minimax_speech_tpu.data import audio_folder as j_af
from minimax_speech_tpu.data import pipeline as j_dp
from minimax_speech_tpu.models import discriminators as j_disc
from minimax_speech_tpu.models import hifigan as j_h
from minimax_speech_tpu.train import gan_steps as j_gan
from tests.conftest import synthetic_audio
from tests.test_torch_bridge import jitter, port_config
from tests.test_torch_codec_train import (LR, assert_grads_close,
                                          assert_metrics_close,
                                          assert_update_close, capture,
                                          jax_update, torch_grads)
from tests import torch_cpu

torch_cpu.share_cores()

HIFT_CFG = j_h.HiFTConfig(in_channels=8, base_channels=16,
                          upsample_rates=(4, 3), upsample_kernel_sizes=(8, 5),
                          resblock_kernel_sizes=(3,),
                          resblock_dilations=((1,),),
                          source_resblock_kernel_sizes=(3, 3),
                          source_resblock_dilations=((1,), (1,)),
                          f0_cond_channels=8)
HIFT_DISC = dict(periods=(2, 3), fft_sizes=(256,), hop_sizes=(64,),
                 win_lengths=(128,))


@pytest.fixture(scope="module")
def hift():
    """(JAX generator, discriminator, jittered variables with a voiced
    f0, batch with pitch)."""
    gen = j_h.HiFTGenerator(HIFT_CFG)
    disc = j_disc.CosyVoiceDiscriminator(**HIFT_DISC)
    rng = np.random.default_rng(1)
    t = 24
    mel = rng.standard_normal((2, t, 8)).astype(np.float32)
    n = t * HIFT_CFG.total_upsample
    audio = np.stack([synthetic_audio(rng, n / 24000, 24000)[:n]] * 2) * 0.5
    audio[1] *= 0.6
    gv = jitter(jax.jit(gen.init)(jax.random.PRNGKey(0), jnp.asarray(mel)),
                seed=2)
    gv["params"]["f0_predictor"]["classifier"]["bias"][:] = 180.0
    dv = jitter(jax.jit(disc.init)(jax.random.PRNGKey(1), jnp.asarray(audio)),
                seed=3)
    pitch = np.abs(rng.normal(150.0, 40.0, (2, t))).astype(np.float32)
    pitch[:, -3:] = 0.0
    batch = {"speech_feat": mel, "audio": audio.astype(np.float32),
             "pitch": pitch}
    return gen, disc, gv, dv, batch


def jax_hift_draws(key, cfg, b, t_mel) -> t_gan.HiFTDraws:
    """The phases and noise JAX's sine_source draws from `key`."""
    k1, k2 = jax.random.split(key)
    h = cfg.nb_harmonics + 1
    phase = np.array(jax.random.uniform(k1, (b, 1, h), minval=-jnp.pi,
                                        maxval=jnp.pi))
    phase[:, :, 0] = 0.0
    noise = np.array(jax.random.normal(
        k2, (b, t_mel * cfg.total_upsample, h)))
    return t_gan.HiFTDraws(torch.as_tensor(phase), torch.as_tensor(noise))


@pytest.mark.parametrize("with_pitch", [True, False])
def test_hift_iteration_matches_jax(hift, monkeypatch, with_pitch):
    """One disc step then one gen step (with and without the f0 loss):
    every metric, both models' gradients and the parameters after each
    AdamW step, at the tolerances above."""
    gen, disc, gv, dv, batch = hift
    if not with_pitch:
        batch = {k: v for k, v in batch.items() if k != "pitch"}
    opt = dict(lr=LR, warmup_steps=0, grad_clip=1e3)
    key = jax.random.PRNGKey(6)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jg, jd = j_gan.make_hift_steps(gen, disc)
    d_caught, dm = jax.jit(jd)(capture(dv["params"]), gv["params"], jb, key)
    d_new = jax_update(dv["params"], d_caught.params, **opt)
    g_caught, gm = jax.jit(jg)(capture(gv["params"]), d_new, jb, key)
    g_new = jax_update(gv["params"], g_caught.params, **opt)

    g = t_io.load_flax_params(t_h.HiFTGenerator(
        port_config(HIFT_CFG, t_h.HiFTConfig)), gv)
    d = t_io.load_flax_params(t_disc.CosyVoiceDiscriminator(**HIFT_DISC), dv)
    seen = torch_grads(monkeypatch)
    g_state = t_steps.make_train_state(g, t_sched.make_optimizer(**opt))
    d_state = t_steps.make_train_state(d, t_sched.make_optimizer(**opt))
    tg, td = t_gan.make_hift_steps(g, d, device="cpu")
    draws = jax_hift_draws(key, HIFT_CFG, 2, 24)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    d_state, tdm = td(d_state, tb, draws)
    g_state, tgm = tg(g_state, tb, draws)
    assert ("gen/f0" in tgm) == with_pitch
    assert_metrics_close({**tdm, **tgm}, {**dm, **gm})
    assert_grads_close(d, seen[id(d_state)], d_caught.params)
    assert_grads_close(g, seen[id(g_state)], g_caught.params)
    assert_update_close(d, seen[id(d_state)], d_new)
    assert_update_close(g, seen[id(g_state)], g_new)


def test_hift_steps_refuse_missing_card():
    """Without device="cpu" make_hift_steps asks for the card and raises."""
    with pytest.raises(RuntimeError, match="no CUDA"):
        t_gan.make_hift_steps(t_h.HiFTGenerator(port_config(
            HIFT_CFG, t_h.HiFTConfig)), t_disc.CosyVoiceDiscriminator())


# --- data ---------------------------------------------------------------------

def _gan_corpus(tmp_path, rng, n=5):
    """wavs at 16 and 24 kHz (one at 2.5 s, peak above 1 after the
    resample's gain is applied) with .txt and _fsq, one too short for
    the filter."""
    from tests.test_cli import write_wav

    paths = []
    for i in range(n):
        sr = 16000 if i % 2 else 24000
        sec = 0.5 if i == n - 1 else 1.3 + 0.3 * i
        audio = synthetic_audio(rng, sec, sr)
        p = tmp_path / f"g{i}.wav"
        write_wav(p, audio, sr)
        (tmp_path / f"g{i}.txt").write_text(f"gan {i}")
        np.save(tmp_path / f"g{i}_fsq.npy",
                rng.integers(0, 6561, int(sec * 25)).astype(np.int32))
        paths.append(str(p))
    lst = tmp_path / "gan.list"
    lst.write_text("\n".join(paths))
    return lst


@pytest.mark.parametrize("use_native", [True, False])
def test_audio_folder_crops_identical(tmp_path, rng, use_native):
    """The file list, and three batches of the endless stream (random
    files and offsets from the seed, 16 kHz files resampled, a file
    shorter than a crop zero-padded) identical."""
    from tests.test_cli import write_wav

    _gan_corpus(tmp_path, rng)
    (tmp_path / "sub").mkdir()
    write_wav(tmp_path / "sub" / "short.wav",
              synthetic_audio(rng, 0.1, 24000), 24000)
    kw = dict(duration=0.38, sample_rate=24000, seed=7,
              use_native=use_native)
    ours = t_af.AudioFolder(str(tmp_path), **kw)
    ref = j_af.AudioFolder(str(tmp_path), **kw)
    assert ours.files == ref.files and len(ours) == 6
    for _, a, b in zip(range(3), ours.infinite_batches(4),
                       ref.infinite_batches(4)):
        assert a.shape == (4, 9120)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("with_pitch", [True, False])
def test_gan_data_chain_identical(tmp_path, rng, with_pitch):
    """train_hift's --train_data chain (opener without latents, filter,
    resample, truncate, compute_fbank, extract_pitch, shuffle,
    static_batch, padding_gan) under one random.seed on both sides:
    identical batches."""
    lst = _gan_corpus(tmp_path, rng)
    items = [{"src": w} for w in lst.read_text().splitlines()]
    out = {}
    for name, dp in (("jax", j_dp), ("port", t_dp)):
        stages = [lambda it, dp=dp: dp.individual_file_opener(
                      it, require_latent=False),
                  dp.filter_lengths, lambda it, dp=dp: dp.resample(it, 24000),
                  lambda it, dp=dp: dp.truncate(it, 24480), dp.compute_fbank]
        if with_pitch:
            stages.append(lambda it, dp=dp: dp.extract_pitch(it, 24000, 480))
        stages += [lambda it, dp=dp: dp.shuffle(it, 1000),
                   lambda it, dp=dp: dp.static_batch(it, 2, drop_last=True),
                   lambda it, dp=dp: dp.padding_gan(it, 480)]
        source = dp.DataList(items)
        source.set_epoch(1)
        random.seed(11)
        out[name] = list(dp.build_dataset(source, stages))
    assert len(out["port"]) == len(out["jax"]) == 2
    for o, r in zip(out["port"], out["jax"]):
        assert o.keys() == r.keys()
        assert ("pitch" in o) == with_pitch
        for k in r:
            assert o[k].dtype == r[k].dtype, k
            np.testing.assert_array_equal(o[k], r[k], err_msg=k)


def test_padding_gan_identical(rng):
    """Unequal feature lengths: cut to the shortest; the YIN frames short
    of it padded with 0."""
    batch = [{"speech_feat": rng.standard_normal((n, 80)).astype(np.float32),
              "audio": rng.standard_normal(n * 480 + 7).astype(np.float32),
              "pitch_feat": rng.uniform(0, 300, n - 2).astype(np.float32)}
             for n in (51, 49, 50)]
    ours = next(t_dp.padding_gan([batch]))
    ref = next(j_dp.padding_gan([batch]))
    assert ours.keys() == ref.keys() and ours["pitch"].shape == (3, 49)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
