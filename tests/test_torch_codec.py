"""DAC-VAE, S3 tokenizer V2 and speaker encoder of the port against the
JAX package.

CPU, float32, tiny geometry of tests/test_pipeline.py with jittered
JAX-initialized weights. The DAC decode covers all five decoder strides
(5, 4, 4, 3, 2), so the transposed-conv weight map (no kernel flip) is
settled here. Tolerances: float32 sums in other orders through the
stated depth.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minimax_speech_torch.models import dac_vae as t_dac
from minimax_speech_torch.models import s3tokenizer as t_s3
from minimax_speech_torch.models import speaker_encoder as t_spk
from minimax_speech_torch.utils import params_io as t_io
from minimax_speech_tpu.models import dac_vae as j_dac
from minimax_speech_tpu.models import s3tokenizer as j_s3
from minimax_speech_tpu.models import speaker_encoder as j_spk
from minimax_speech_tpu.ops import mel as j_mel
from tests.conftest import synthetic_audio
from tests.test_torch_bridge import jitter, tiny_port_cfg


@pytest.fixture(scope="module")
def dac():
    jcfg, pcfg = tiny_port_cfg()
    model = j_dac.DACVAE(jcfg.dac)
    dummy = jnp.zeros((1, jcfg.dac.hop_length * 4, 1))
    variables = jitter(jax.jit(model.init)(jax.random.PRNGKey(3), dummy),
                       seed=3)
    port = t_io.load_flax_params(t_dac.DACVAE(pcfg.dac).eval(), variables)
    return model, variables, port


def test_dac_encode_mu_matches(dac, rng):
    """mu after the 5-block strided encoder: 1e-4 relative to its scale."""
    model, variables, port = dac
    audio = np.stack([synthetic_audio(rng, 0.1, 24000)] * 2)[..., None]
    audio[1] *= 0.3
    _, mu_j, _ = model.apply(variables, jnp.asarray(audio),
                             method=j_dac.DACVAE.encode)
    with torch.no_grad():
        mu_t = port.encode(torch.as_tensor(audio)).numpy()
    mu_j = np.asarray(mu_j)
    assert mu_t.shape == mu_j.shape == (2, 5, 80)
    np.testing.assert_allclose(mu_t, mu_j, atol=1e-4 * np.abs(mu_j).max())


def test_dac_decode_matches_over_all_strides(dac, rng):
    """Decode through the transposed convs of strides 5, 4, 4, 3, 2 (the
    odd ones with output_padding 1): 2e-5 on audio in [-1, 1]."""
    model, variables, port = dac
    z = rng.standard_normal((2, 7, 80)).astype(np.float32)
    ref = np.asarray(model.apply(variables, jnp.asarray(z),
                                 method=j_dac.DACVAE.decode))
    with torch.no_grad():
        ours = port.decode(torch.as_tensor(z)).numpy()
    assert ours.shape == ref.shape == (2, 7 * 480, 1)
    assert np.abs(ref).max() > 0.05  # not a silent decoder
    np.testing.assert_allclose(ours, ref, atol=2e-5)


def test_pad_to_hop_identical(rng):
    a = rng.standard_normal((2, 1001)).astype(np.float32)
    np.testing.assert_array_equal(t_dac.pad_to_hop(a, 480),
                                  j_dac.pad_to_hop(a, 480))


def test_s3_codes_match(rng):
    """Codes equal except where the port's |tanh(h) * 0.999| is within
    1e-5 of a digit boundary 0.5 (float32 noise there flips a digit)."""
    jcfg, pcfg = tiny_port_cfg()
    model = j_s3.S3TokenizerV2(jcfg.s3)
    variables = jitter(jax.jit(model.init)(
        jax.random.PRNGKey(4), jnp.zeros((1, 64, 128)), jnp.array([64])),
        seed=4)
    port = t_io.load_flax_params(t_s3.S3TokenizerV2(pcfg.s3).eval(),
                                 variables)
    audio = synthetic_audio(rng, 1.2, 16000)
    mel = np.asarray(j_mel.whisper_log_mel(jnp.asarray(audio))).T
    mels = np.zeros((2, 128, 128), np.float32)
    mels[0, :120], mels[1, :90] = mel, mel[:90]
    lens = np.array([120, 90], np.int32)
    codes_j, len_j = model.apply(variables, jnp.asarray(mels),
                                 jnp.asarray(lens))
    with torch.no_grad():
        mt, lt = torch.as_tensor(mels), torch.as_tensor(lens)
        codes_t, len_t = port(mt, lt)
        hidden, _ = port.encoder(mt, lt)
        h8 = torch.tanh(port.project_down(hidden)) * 0.9990000128746033
    np.testing.assert_array_equal(len_t.numpy(), np.asarray(len_j))
    near = (np.abs(np.abs(h8.numpy()) - 0.5) < 1e-5).any(-1)
    for i, n in enumerate(np.asarray(len_j)):
        same = codes_t.numpy()[i, :n] == np.asarray(codes_j)[i, :n]
        assert (same | near[i, :n]).all()
        assert same.mean() > 0.9


@pytest.mark.parametrize("mean_pooling", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_speaker_encoder_matches(rng, masked, mean_pooling):
    """Unit-norm 12-d embedding: 1e-5."""
    _, pcfg = tiny_port_cfg()
    scfg = dataclasses.replace(pcfg.lm.speaker, mean_pooling=mean_pooling)
    model = j_spk.LearnableSpeakerEncoder(j_spk.SpeakerEncoderConfig(
        **vars(scfg)))
    mel = rng.standard_normal((2, 30, 80)).astype(np.float32)
    mask = (np.arange(30)[None] < np.array([[30], [17]])).astype(np.float32)
    variables = jitter(model.init(jax.random.PRNGKey(5), jnp.asarray(mel)),
                       seed=5)
    port = t_io.load_flax_params(t_spk.LearnableSpeakerEncoder(scfg).eval(),
                                 variables)
    m_j = jnp.asarray(mask) if masked else None
    m_t = torch.as_tensor(mask) if masked else None
    ref = np.asarray(model.apply(variables, jnp.asarray(mel), m_j))
    with torch.no_grad():
        ours = port(torch.as_tensor(mel), m_t).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-5)
