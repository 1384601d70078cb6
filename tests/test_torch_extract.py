"""Offline feature extraction in the port against the JAX package, on the
CPU: S3TokenizerV1 and the long-audio windowing (models/s3tokenizer.py),
the four CLIs extract_fsq, extract_dac_latents, extract_embedding and
eval_dac, each run by both packages on one corpus with one set of
random weights (JAX's init, jittered, written as .npz), and the host
audio metrics (utils/audio_metrics.py).

Tolerances: tokens and codes identical; latents, embeddings and latent
stats within 1e-5 of their largest; SI-SDR, L1 and mel distance 1e-5
relative. STOI on the same inputs 1e-4 relative: the JAX package's
10 kHz resampler passes 0-945 Hz only (utils/audio_metrics.py's
docstring), so STOI's upper six bands read its leakage, 46-80 dB down,
which float32 rounding moves (2.9e-5 measured between the two packages
on 2.5 s of speech-like audio). eval_dac's STOI 5e-3 relative: a random
codec's output is noise (SI-SDR about -58 dB), and its STOI (about 0.13)
turns the reconstructions' 1e-6 differences into 1.7e-3 (measured).
"""
import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minimax_speech_torch.cli import eval_dac as t_eval
from minimax_speech_torch.cli import extract_dac_latents as t_lat
from minimax_speech_torch.cli import extract_embedding as t_emb
from minimax_speech_torch.cli import extract_fsq as t_fsq
from minimax_speech_torch.models import s3tokenizer as t_s3
from minimax_speech_torch.utils import audio_metrics as t_am
from minimax_speech_torch.utils import params_io as t_io
from minimax_speech_tpu import config as j_cfg
from minimax_speech_tpu.cli import eval_dac as j_eval
from minimax_speech_tpu.cli import extract_dac_latents as j_lat
from minimax_speech_tpu.cli import extract_embedding as j_emb
from minimax_speech_tpu.cli import extract_fsq as j_fsq
from minimax_speech_tpu.models import dac_vae as j_dac
from minimax_speech_tpu.models import s3tokenizer as j_s3
from minimax_speech_tpu.models import speaker_encoder as j_spk
from minimax_speech_tpu.utils import audio_metrics as j_am
from minimax_speech_tpu.utils import params_io as j_io
from tests.conftest import synthetic_audio
from tests.test_cli import write_wav
from tests.test_torch_bridge import jitter
from tests import torch_cpu

torch_cpu.share_cores()

TINY_S3 = dict(n_state=32, n_head=4, n_layer=1)
TINY_YAML = str(Path(__file__).resolve().parents[1] / "configs" / "tiny.yaml")


def _tiny_s3_config(real):
    """S3TokenizerConfig's stand-in: the v1 CLIs' default geometry cut to
    TINY_S3 (the codebook's size as asked)."""
    def make(codebook_size=real().codebook_size, **kw):
        return real(**{**TINY_S3, **kw, "codebook_size": codebook_size})
    return make


@pytest.fixture(scope="module")
def v1():
    """(JAX S3TokenizerV1 at TINY_S3, stride 2, its jittered variables)."""
    model = j_s3.S3TokenizerV1(j_s3.S3TokenizerConfig(codebook_size=4096,
                                                      **TINY_S3), stride=2)
    variables = jitter(jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 128)), jnp.array([64])),
        seed=4)
    return model, variables


def _port_v1(variables, stride=2):
    return t_io.load_flax_params(t_s3.S3TokenizerV1(t_s3.S3TokenizerConfig(
        codebook_size=4096, **TINY_S3), stride=stride), variables)


@pytest.mark.parametrize("frames", [7000, 2500])
def test_v1_quantize_long_identical(v1, rng, frames):
    """quantize_long over three windows (and their merge) and over one:
    identical tokens; the batched call's codes and lengths identical."""
    model, variables = v1
    port = _port_v1(variables)
    mel = (rng.standard_normal((frames, 128)) * 0.5).astype(np.float32)
    apply = jax.jit(model.apply)
    ref = j_s3.quantize_long(lambda p, a, b: apply(p, a, b), variables, mel,
                             frames)
    ours = t_s3.quantize_long(port, mel, frames)
    assert len(ours) == len(ref) == (1750 if frames == 7000 else 625)
    assert ours == ref
    lens = np.array([3000, 1711], np.int32)
    batch = (rng.standard_normal((2, 3000, 128)) * 0.5).astype(np.float32)
    codes, code_len = apply(variables, jnp.asarray(batch), jnp.asarray(lens))
    with torch.no_grad():
        tc, tl = port(torch.as_tensor(batch), torch.as_tensor(lens))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(code_len))
    for i, n in enumerate(np.asarray(code_len)):
        np.testing.assert_array_equal(tc[i, :n].numpy(),
                                      np.asarray(codes)[i, :n])


def test_windowing_identical():
    mel = np.arange(9000 * 2, dtype=np.float32).reshape(9000, 2)
    for n in (100, 3000, 3001, 5600, 8999):
        ours, ref = t_s3.split_windows(mel, n), j_s3.split_windows(mel, n)
        assert len(ours) == len(ref)
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)
    segs = [list(range(i * 1000, i * 1000 + 750)) for i in range(3)]
    assert t_s3.merge_window_tokens(segs) == j_s3.merge_window_tokens(segs)


def _corpus(root, rng, sr, secs):
    root.mkdir(parents=True, exist_ok=True)
    for i, s in enumerate(secs):
        write_wav(root / f"c{i}.wav", synthetic_audio(rng, s, sr), sr)
    return root


def _twins(tmp_path, src):
    """Two copies of a corpus: each CLI writes beside the wavs."""
    out = []
    for name in ("jax", "port"):
        shutil.copytree(src, tmp_path / name)
        out.append(tmp_path / name)
    return out


def _write_tree(path, tree):
    j_io.save_params(str(path), jax.tree_util.tree_map(np.asarray, tree))
    return str(path)


def test_extract_fsq_v2_long_file_identical(tmp_path, rng, monkeypatch):
    """v2 at configs/tiny.yaml's s3 geometry over wavs at 16 and 24 kHz,
    one of 35 s (two windows) and a broken one (listed as failed, in the
    working directory, by both): identical token files."""
    monkeypatch.chdir(tmp_path)
    src = _corpus(tmp_path / "src", rng, 16000, (35.0, 1.3))
    write_wav(src / "c2.wav", synthetic_audio(rng, 2.1, 24000), 24000)
    (src / "c3.wav").write_bytes(b"RIFF")
    cfg = j_cfg.load_tts_config(TINY_YAML).s3
    model = j_s3.S3TokenizerV2(cfg)
    ckpt = _write_tree(tmp_path / "s3.npz", jitter(jax.jit(model.init)(
        jax.random.PRNGKey(1), jnp.zeros((1, 64, 128)), jnp.array([64])),
        seed=5))
    jdir, pdir = _twins(tmp_path, src)
    common = ["--ckpt", ckpt, "--config", TINY_YAML]
    with pytest.raises(RuntimeError, match="no CUDA"):
        t_fsq.main(["--dir", str(pdir)] + common)
    j_fsq.main(["--dir", str(jdir)] + common)
    t_fsq.main(["--dir", str(pdir), "--device", "cpu"] + common)
    for i, n in enumerate((875, None, None)):
        ours = np.load(pdir / f"c{i}_fsq.npy")
        ref = np.load(jdir / f"c{i}_fsq.npy")
        assert ours.dtype == ref.dtype == np.int32
        if n:
            assert len(ours) == n  # 35 s at 25 Hz: two windows merged
        np.testing.assert_array_equal(ours, ref)
    assert not (pdir / "c3_fsq.npy").exists()
    assert (tmp_path / "failed_files_rank0.txt").read_text() == str(
        pdir / "c3.wav")


@pytest.mark.parametrize("version", ["v1_25hz", "v1_50hz"])
def test_extract_fsq_v1_identical(tmp_path, rng, monkeypatch, version):
    """v1 (the CLI's default geometry cut to TINY_S3 on both sides), 25
    and 50 Hz, --skip_existing and --process_index/count 1 of 2:
    identical token files for this share, the other share untouched."""
    for mod in (j_s3, t_s3):
        monkeypatch.setattr(mod, "S3TokenizerConfig",
                            _tiny_s3_config(mod.S3TokenizerConfig))
    src = _corpus(tmp_path / "src", rng, 16000, (1.5, 2.2, 0.9, 3.1))
    stride = 2 if version == "v1_25hz" else 1
    model = j_s3.S3TokenizerV1(j_s3.S3TokenizerConfig(codebook_size=4096),
                               stride=stride)
    ckpt = _write_tree(tmp_path / "v1.npz", jitter(jax.jit(model.init)(
        jax.random.PRNGKey(2), jnp.zeros((1, 64, 128)), jnp.array([64])),
        seed=6))
    jdir, pdir = _twins(tmp_path, src)
    np.save(pdir / "c3_fsq.npy", np.array([7], np.int32))
    np.save(jdir / "c3_fsq.npy", np.array([7], np.int32))
    args = ["--ckpt", ckpt, "--model_version", version, "--skip_existing",
            "--process_index", "1", "--process_count", "2"]
    j_fsq.main(["--dir", str(jdir)] + args)
    t_fsq.main(["--dir", str(pdir), "--device", "cpu"] + args)
    assert np.load(pdir / "c3_fsq.npy").tolist() == [7]
    assert not (pdir / "c0_fsq.npy").exists()
    ours, ref = np.load(pdir / "c1_fsq.npy"), np.load(jdir / "c1_fsq.npy")
    assert len(ours) == int(2.2 * 100) // (2 * stride)
    np.testing.assert_array_equal(ours, ref)


@pytest.fixture(scope="module")
def tiny_dac(tmp_path_factory):
    """configs/tiny.yaml's DAC-VAE: JAX's init, jittered, as .npz."""
    cfg = j_cfg.load_tts_config(TINY_YAML).dac
    model = j_dac.DACVAE(cfg)
    tree = jitter(jax.jit(model.init)(jax.random.PRNGKey(3),
                                      jnp.zeros((1, cfg.hop_length * 4, 1))),
                  seed=7)
    return _write_tree(tmp_path_factory.mktemp("dac") / "dac.npz", tree)


def test_extract_dac_latents_and_stats_match(tmp_path, rng, tiny_dac,
                                            monkeypatch):
    """configs/tiny.yaml's codec over three 24 kHz wavs (and one at 16
    kHz, failed and listed by both): z, mu and logs within 1e-5 of their
    largest,
    z equal to mu; the decode check run on every file; the latent stats
    (mean, std over frames) within 1e-5, the frame count equal."""
    monkeypatch.chdir(tmp_path)
    src = _corpus(tmp_path / "src", rng, 24000, (1.1, 0.7, 1.6))
    write_wav(src / "c3.wav", synthetic_audio(rng, 0.5, 16000), 16000)
    jdir, pdir = _twins(tmp_path, src)
    args = ["--ckpt", tiny_dac, "--config", TINY_YAML,
            "--verify_fraction", "1.0"]
    j_lat.main(["--dir", str(jdir), "--stats_out",
                str(tmp_path / "j.json")] + args)
    t_lat.main(["--dir", str(pdir), "--stats_out", str(tmp_path / "t.json"),
                "--device", "cpu"] + args)
    for i in range(3):
        ours, ref = np.load(pdir / f"c{i}_latent2x.npz"), \
            np.load(jdir / f"c{i}_latent2x.npz")
        assert sorted(ours.files) == sorted(ref.files) == ["logs", "mu", "z"]
        for k in ref.files:
            np.testing.assert_allclose(ours[k], ref[k], rtol=0, atol=1e-5 * (
                np.abs(ref[k]).max()), err_msg=k)
        np.testing.assert_array_equal(ours["z"], ours["mu"])
    assert not (pdir / "c3_latent2x.npz").exists()
    assert (tmp_path / "failed_latents_rank0.txt").read_text() == str(
        pdir / "c3.wav")
    ours = json.loads((tmp_path / "t.json").read_text())
    ref = json.loads((tmp_path / "j.json").read_text())
    assert ours["frames"] == ref["frames"] == sum(
        len(np.load(pdir / f"c{i}_latent2x.npz")["mu"]) for i in range(3))
    for k in ("mean", "std"):
        r = np.array(ref[k])
        np.testing.assert_allclose(ours[k], r, rtol=0,
                                   atol=1e-5 * np.abs(r).max(), err_msg=k)


def test_extract_embedding_matches(tmp_path, rng):
    """The default speaker encoder from the speaker_encoder subtree of an
    LM-style .npz, over wavs at 24 and 16 kHz: embeddings within 1e-5;
    then --campplus (a random CAM++ written as campplus.onnx) over the
    same wavs against JAX's CLI: x-vectors within 1e-5."""
    src = _corpus(tmp_path / "src", rng, 24000, (1.2, 0.8))
    write_wav(src / "c2.wav", synthetic_audio(rng, 0.9, 16000), 16000)
    enc = j_spk.LearnableSpeakerEncoder(j_spk.SpeakerEncoderConfig())
    tree = jitter(jax.jit(enc.init)(jax.random.PRNGKey(4),
                                    jnp.zeros((1, 16, 80))), seed=8)
    ckpt = _write_tree(tmp_path / "llm.npz",
                       {"params": {"speaker_encoder": tree["params"]}})
    jdir, pdir = _twins(tmp_path, src)
    j_emb.main(["--dir", str(jdir), "--ckpt", ckpt])
    t_emb.main(["--dir", str(pdir), "--ckpt", ckpt, "--device", "cpu"])
    for i in range(3):
        ours, ref = np.load(pdir / f"c{i}_spk.npy"), \
            np.load(jdir / f"c{i}_spk.npy")
        assert ours.shape == ref.shape == (192,)
        np.testing.assert_allclose(ours, ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())
    import chip_smoke
    from tests.test_campplus import TorchCAMPPlus

    torch.manual_seed(1)
    cp = chip_smoke.write_onnx(tmp_path / "campplus.onnx", {
        k: v.numpy() for k, v in TorchCAMPPlus(
            80, 192, 32, 4, 128, 32, (12, 24, 16), (1, 2, 2)).state_dict()
        .items()})
    j_emb.main(["--dir", str(jdir), "--campplus", str(cp)])
    t_emb.main(["--dir", str(pdir), "--campplus", str(cp), "--device",
                "cpu"])
    for i in range(3):
        ours, ref = np.load(pdir / f"c{i}_spk.npy"), \
            np.load(jdir / f"c{i}_spk.npy")
        assert ours.shape == ref.shape == (192,)
        np.testing.assert_allclose(ours, ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())


def test_eval_dac_metrics_match(tmp_path, rng, tiny_dac):
    """configs/tiny.yaml's codec over two speech-like wavs (one at 16 kHz,
    resampled): the four mean metrics at the tolerances above, the file
    count equal."""
    src = tmp_path / "src"
    src.mkdir()
    for i, (sec, sr) in enumerate(((2.5, 24000), (2.0, 16000))):
        t = np.arange(int(sec * sr)) / sr
        x = (0.4 * np.sin(2 * np.pi * (180 + 40 * i) * t)
             * (1 + np.sin(2 * np.pi * 3 * t))
             + 0.05 * rng.standard_normal(t.shape))
        write_wav(src / f"e{i}.wav", x, sr)
    args = ["--ckpt", tiny_dac, "--wav_dir", str(src), "--config",
            TINY_YAML]
    ref = j_eval.main(args)
    ours = t_eval.main(args + ["--device", "cpu"])
    assert ours.keys() == ref.keys() and ours["n_files"] == ref["n_files"] == 2
    np.testing.assert_allclose(ours["stoi"], ref["stoi"], rtol=5e-3)
    for k in ("si_sdr_db", "l1", "mel_l1"):
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-5, err_msg=k)


def test_audio_metrics_match(rng):
    """The four host metrics on a speech-like 2.5 s pair; the resampler's
    output against JAX's within 1e-6 of its largest."""
    t = np.arange(int(2.5 * 24000)) / 24000
    ref_audio = (0.5 * np.sin(2 * np.pi * 220 * t)
                 * (1 + np.sin(2 * np.pi * 3 * t))
                 + 0.05 * rng.standard_normal(t.shape)).astype(np.float32)
    est = (ref_audio + 0.1 * rng.standard_normal(t.shape)).astype(np.float32)
    np.testing.assert_allclose(t_am.stoi(ref_audio, est, 24000),
                               j_am.stoi(ref_audio, est, 24000), rtol=1e-4)
    for f in ("si_sdr", "l1_distance"):
        assert getattr(t_am, f)(ref_audio, est) == pytest.approx(
            getattr(j_am, f)(ref_audio, est), rel=1e-5)
    assert t_am.mel_distance(ref_audio, est) == pytest.approx(
        j_am.mel_distance(ref_audio, est), rel=1e-5)
    x = np.asarray(ref_audio, np.float64)
    r = j_am._resample(x, 24000, 10000)
    np.testing.assert_allclose(t_am._resample(x, 24000, 10000), r, rtol=0,
                               atol=1e-6 * np.abs(r).max())
