"""The `.dacz` codec file of the port against the JAX package's.

CPU, float32, the tiny DAC-VAE of tests/test_codec_file.py (rates 2-4-5,
hop 40) with jittered JAX-initialised weights in both packages, 0.25 s
windows with 4000 samples of overlap. Limits:
- compress: the float16 latents. mu agrees with JAX's to 1e-4 of its
  largest value (tests/test_torch_codec.py's limit), and such a
  difference can round to a neighbouring float16: each entry within that
  limit plus one float16 spacing at its value. The share of equal
  entries (measured 0.9974-0.9984, asserted at least 0.99) and the
  largest distance in float16 ulps (measured 2) are printed; the
  metadata identical (input_db to 1e-9 relative);
- decompress of one artifact: audio within 1e-5 of its largest sample;
- the artifact: written by either package, read by the other, the same
  fields and bytes;
- the CLI at the default DAC-VAE (random weights, seed 0): its .dacz and
  wav equal the class API's on the same model, and JAX's reader loads
  its .dacz.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minimax_speech_torch.cli import codec as t_cli
from minimax_speech_torch.data.pipeline import _load_audio
from minimax_speech_torch.infer import codec_file as t_cf
from minimax_speech_torch.models import dac_vae as t_dac
from minimax_speech_torch.utils import params_io as t_io
from minimax_speech_tpu.infer import codec_file as j_cf
from minimax_speech_tpu.models import dac_vae as j_dac
from tests.conftest import synthetic_audio
from tests.test_cli import write_wav
from tests.test_codec_file import TINY
from tests.test_torch_bridge import jitter
from tests import torch_cpu

torch_cpu.share_cores()

WIN, OVERLAP = 0.25, 4000


@pytest.fixture(scope="module")
def codecs():
    model = j_dac.DACVAE(TINY)
    variables = jitter(jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, TINY.hop_length * 4, 1))),
        seed=2)
    port = t_io.load_flax_params(t_dac.DACVAE(t_dac.DACVAEConfig(**{
        f.name: getattr(TINY, f.name)
        for f in dataclasses.fields(t_dac.DACVAEConfig)})), variables)
    return (j_cf.DACVAECodec(model, variables, win_duration=WIN,
                             overlap=OVERLAP),
            t_cf.DACVAECodec(port, win_duration=WIN, overlap=OVERLAP))


def _f16_ulps(a, b):
    """Distance in float16 ulps (the sign-magnitude integer order)."""
    def key(x):
        i = x.astype(np.float16).view(np.int16).astype(np.int32)
        return np.where(i < 0, -(i & 0x7FFF), i)
    return np.abs(key(a) - key(b))


@pytest.mark.parametrize("sr,norm", [(24000, -16.0), (16000, None)])
def test_compress_matches_jax(codecs, sr, norm):
    """1.3 s at 24 kHz normalised to -16 dB, and at 16 kHz (resampled)
    without normalisation: several windows each."""
    ref_codec, ours_codec = codecs
    audio = synthetic_audio(np.random.default_rng(1), 1.3, sr)
    ref = ref_codec.compress(audio, sr, normalize_db=norm)
    ours = ours_codec.compress(audio, sr, normalize_db=norm)
    assert ours.latents.dtype == np.float16
    assert ours.latents.shape == ref.latents.shape
    ulps = _f16_ulps(ours.latents, ref.latents)
    equal = float((ulps == 0).mean())
    print(f"float16 latents: {equal:.4f} equal, largest {ulps.max()} ulp")
    assert equal >= 0.99
    a, b = ours.latents.astype(np.float32), ref.latents.astype(np.float32)
    limit = 1e-4 * np.abs(b).max() + np.spacing(np.abs(ref.latents)) \
        .astype(np.float32)
    assert (np.abs(a - b) <= limit).all()
    for k in ("original_length", "sample_rate", "chunk_length", "channels",
              "version"):
        assert getattr(ours, k) == getattr(ref, k), k
    np.testing.assert_allclose(ours.input_db, ref.input_db, rtol=1e-9)


def test_decompress_matches_jax_and_artifacts_cross(codecs, tmp_path):
    """One .dacz written by JAX decodes in both packages alike; a .dacz
    written by the port loads in JAX with the same fields and latents,
    and JAX's in the port's loader."""
    ref_codec, ours_codec = codecs
    audio = synthetic_audio(np.random.default_rng(2), 0.9, 16000)
    jpath = ref_codec.compress(audio, 16000).save(tmp_path / "j")
    ref = ref_codec.decompress(str(jpath))
    ours = ours_codec.decompress(str(jpath))
    assert ours.shape == ref.shape == audio.shape
    np.testing.assert_allclose(ours, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    tpath = ours_codec.compress(audio, 16000).save(tmp_path / "t")
    assert tpath.suffix == ".dacz"
    for path in (jpath, tpath):
        a, b = t_cf.DACVAEFile.load(path), j_cf.DACVAEFile.load(path)
        assert dataclasses.asdict(a).keys() == dataclasses.asdict(b).keys()
        for k, v in dataclasses.asdict(b).items():
            np.testing.assert_array_equal(getattr(a, k), v, err_msg=k)
    with pytest.raises(RuntimeError, match="version"):
        bad = t_cf.DACVAEFile.load(tpath)
        bad.version = "other"
        t_cf.DACVAEFile.load(bad.save(tmp_path / "bad"))


def test_chunked_latents_match_full_encode(codecs):
    """The overlap-cropped windows against one full-signal encode, away
    from the signal's edges (JAX's test and limits)."""
    _, ours_codec = codecs
    audio = synthetic_audio(np.random.default_rng(3), 1.3, 24000)
    f = ours_codec.compress(audio, 24000, normalize_db=None)
    full = ours_codec.encode_mu(t_dac.pad_to_hop(audio, ours_codec.hop))
    assert f.latents.shape[0] == full.shape[0]
    edge = ours_codec.ov_lat // 2
    np.testing.assert_allclose(f.latents.astype(np.float32)[edge:-edge],
                               full[edge:-edge], atol=5e-3, rtol=5e-2)


def test_codec_cli_roundtrip(tmp_path):
    """compress then decompress through the CLI at the default DAC-VAE:
    the same .dacz and wav as the class API on the seed-0 model; JAX's
    DACVAEFile reads the CLI's artifact."""
    audio = synthetic_audio(np.random.default_rng(4), 0.4, 16000)
    write_wav(tmp_path / "a.wav", audio, 16000)
    args = ["--win", "0.2", "--overlap", "2400", "--device", "cpu"]
    (dacz,) = t_cli.main(["compress", "--inputs", str(tmp_path / "a.wav"),
                          *args])
    (wav,) = t_cli.main(["decompress", "--inputs", str(dacz), "--out_dir",
                         str(tmp_path), *args])
    model = t_io.init_params(t_dac.DACVAE(t_dac.DACVAEConfig()),
                             torch.Generator().manual_seed(0))
    codec = t_cf.DACVAECodec(model, win_duration=0.2, overlap=2400)
    loaded, sr = _load_audio(str(tmp_path / "a.wav"))
    want = codec.compress(loaded, sr)
    got = t_cf.DACVAEFile.load(dacz)
    np.testing.assert_array_equal(got.latents, want.latents)
    assert j_cf.DACVAEFile.load(dacz).original_length == len(audio)
    out, out_sr = _load_audio(str(wav))
    assert out_sr == 16000 and out.shape == audio.shape
    pcm = np.clip(codec.decompress(want), -1, 1) * 32767
    np.testing.assert_array_equal(np.round(out * 32768),
                                  pcm.astype(np.int16))
