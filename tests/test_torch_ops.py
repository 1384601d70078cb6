"""Port ops against the JAX package's ops on the CPU, float32.

Masks, FSQ codes and sampled ids must be identical; RoPE and the mel
frontends agree to float32 rounding of the same arithmetic (different
FFT and transcendental implementations), stated per test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minimax_speech_torch.ops import fsq as t_fsq
from minimax_speech_torch.ops import masks as t_masks
from minimax_speech_torch.ops import mel as t_mel
from minimax_speech_torch.ops import rope as t_rope
from minimax_speech_torch.ops import sampling as t_sampling
from minimax_speech_tpu.ops import fsq as j_fsq
from minimax_speech_tpu.ops import masks as j_masks
from minimax_speech_tpu.ops import mel as j_mel
from minimax_speech_tpu.ops import rope as j_rope
from minimax_speech_tpu.ops import sampling as j_sampling
from tests.conftest import synthetic_audio


@pytest.mark.parametrize("chunk,left", [(0, -1), (3, -1), (3, 1), (4, 0)])
def test_masks_identical(chunk, left):
    lengths = np.array([7, 4, 9], np.int32)
    pad_j = j_masks.make_non_pad_mask(jnp.asarray(lengths), 9)
    pad_t = t_masks.make_non_pad_mask(torch.as_tensor(lengths), 9)
    np.testing.assert_array_equal(np.asarray(pad_j), pad_t.numpy())
    m_j = j_masks.add_optional_chunk_mask(pad_j, chunk, left)
    m_t = t_masks.add_optional_chunk_mask(pad_t, chunk, left)
    np.testing.assert_array_equal(np.asarray(m_j), m_t.numpy())
    np.testing.assert_array_equal(
        np.asarray(j_masks.mask_to_bias(m_j)), t_masks.mask_to_bias(m_t))


def test_rope_matches(rng):
    """cos/sin of float32 angles (positions up to 600, theta 1e6 as in
    Qwen2): |err| <= 2e-6, float32 rounding of cos/sin of the same angle."""
    pos = rng.integers(0, 600, 37).astype(np.float32)
    cj, sj = j_rope.rope_cos_sin(0, 64, 1e6, positions=jnp.asarray(pos))
    ct, st = t_rope.rope_cos_sin(0, 64, 1e6, positions=torch.as_tensor(pos))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=2e-6)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=2e-6)
    q = rng.standard_normal((2, 37, 3, 64)).astype(np.float32)
    k = rng.standard_normal((2, 37, 3, 64)).astype(np.float32)
    qj, kj = j_rope.apply_rope(jnp.asarray(q), jnp.asarray(k), cj, sj)
    qt, kt = t_rope.apply_rope(torch.as_tensor(q), torch.as_tensor(k), ct, st)
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), atol=2e-5)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), atol=2e-5)


def test_fsq_codes_exact(rng):
    h = (rng.standard_normal((4, 50, 8)) * 2).astype(np.float32)
    # digit boundaries: tanh(x)*0.999 = +-0.5 exactly at atanh(0.5/0.999)
    h[0, :8] = np.float32(np.arctanh(0.5 / 0.9990000128746033))
    codes_j = np.asarray(j_fsq.fsq_encode(jnp.asarray(h)))
    codes_t = t_fsq.fsq_encode(torch.as_tensor(h))
    assert codes_t.dtype == torch.int32
    np.testing.assert_array_equal(codes_t.numpy(), codes_j)
    assert codes_j.max() < 6561 and codes_j.min() >= 0


def test_mel_filterbank_identical():
    np.testing.assert_array_equal(t_mel.mel_filterbank(16000, 400, 128),
                                  j_mel.mel_filterbank(16000, 400, 128))
    np.testing.assert_array_equal(
        t_mel.mel_filterbank(24000, 1920, 80, 0.0, 8000.0),
        j_mel.mel_filterbank(24000, 1920, 80, 0.0, 8000.0))


def test_whisper_log_mel_matches(rng):
    """Same frames, window and filterbank; the FFTs differ (pocketfft in
    torch, XLA's on the JAX side), so the log10 features agree to 1e-4 on
    a scale of ~1."""
    audio = synthetic_audio(rng, 1.3, 16000)
    ours = t_mel.whisper_log_mel(torch.as_tensor(audio)).numpy()
    ref = np.asarray(j_mel.whisper_log_mel(jnp.asarray(audio)))
    assert ours.shape == ref.shape == (128, 130)
    np.testing.assert_allclose(ours, ref, atol=1e-4)
    batch = np.stack([audio, audio[::-1].copy()])
    ours_b = t_mel.whisper_log_mel(torch.as_tensor(batch)).numpy()
    np.testing.assert_allclose(ours_b[0], ours, atol=1e-6)


def test_hifigan_log_mel_np_identical(rng):
    audio = synthetic_audio(rng, 0.7, 24000)
    np.testing.assert_array_equal(t_mel.hifigan_log_mel_np(audio),
                                  j_mel.hifigan_log_mel_np(audio))


def _logp(rng, b=3, v=300, sharp=4.0):
    logits = rng.standard_normal((b, v)).astype(np.float32) * sharp
    return np.array(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))


@pytest.mark.parametrize("top_k", [25, 7])
def test_nucleus_ids_identical(rng, top_k):
    for trial in range(20):
        logp = _logp(rng)
        g = np.array(jax.random.gumbel(jax.random.PRNGKey(trial),
                                         (3, top_k)))
        ids_j = np.asarray(j_sampling.nucleus_gumbel_max(
            jnp.asarray(g), jnp.asarray(logp), 0.8, top_k))
        ids_t = t_sampling.nucleus_gumbel_max(
            torch.as_tensor(g), torch.as_tensor(logp), 0.8, top_k)
        np.testing.assert_array_equal(ids_t.numpy(), ids_j)


def test_ras_ids_identical_with_fallback(rng):
    """RAS with the fallback table fed as the JAX categorical draw
    (argmax(logp + gumbel(step_key))): rows whose nucleus id repeats in
    `recent` take the fallback in both packages."""
    hits = 0
    for trial in range(20):
        logp = _logp(rng, sharp=6.0)
        g_top = np.array(jax.random.gumbel(jax.random.PRNGKey(trial),
                                             (3, 25)))
        step_key = jax.random.PRNGKey(100 + trial)
        g_fb = np.array(jax.random.gumbel(step_key, logp.shape))
        top = np.asarray(j_sampling.nucleus_gumbel_max(
            jnp.asarray(g_top), jnp.asarray(logp)))
        recent = np.full((3, 10), -1, np.int32)
        recent[0, :2] = top[0]          # repeats: fallback row
        recent[2, 5] = top[2]
        ids_j = np.asarray(j_sampling.ras_sample_batch_pregen(
            step_key, jnp.asarray(g_top), jnp.asarray(logp),
            jnp.asarray(recent)))
        ids_t = t_sampling.ras_sample_batch_pregen(
            torch.as_tensor(g_top), torch.as_tensor(g_fb),
            torch.as_tensor(logp), torch.as_tensor(recent))
        np.testing.assert_array_equal(ids_t.numpy(), ids_j)
        hits += int((ids_j != top).any())
    assert hits > 0  # the fallback branch was exercised


def test_gumbel_draws_are_standard():
    g = t_sampling.gumbel((200000,), torch.Generator().manual_seed(0))
    assert np.isfinite(g.numpy()).all()
    assert abs(float(g.mean()) - 0.5772) < 0.01  # Euler-Mascheroni
    assert abs(float(g.var()) - np.pi ** 2 / 6) < 0.03
