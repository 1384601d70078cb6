"""The port's Matcha CLIs (cli/matcha.py, cli/train_matcha.py) end to end
with --device cpu, against the JAX package's.

cli/matcha.py: both CLIs read the same random default-width checkpoints
(.npz written by the JAX package's save_params) at temperature 0, so no
noise enters; --batched over two texts of other lengths. Each
utterance's mel within 1e-4 of its peak, its PCM within 2 LSB (the
denoised audio as int16). cli/train_matcha.py: the corpus statistics
(matcha_stats.json) against JAX's host mel and text pipeline within 1e-6
relative, the metrics rows JAX's keys, and matcha.npz the JAX
initialiser's tree, path for path and shape for shape. The two draw
their initial weights and noise from different generators, so their
losses are compared in test_torch_matcha.py on shared draws, not here.
"""
import functools
import json
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from minimax_speech_torch.cli import matcha as t_cli
from minimax_speech_torch.cli import train_matcha as t_train
from minimax_speech_torch.utils import params_io as t_io
from minimax_speech_tpu.cli import matcha as j_cli
from minimax_speech_tpu.data.pipeline import _load_audio
from minimax_speech_tpu.infer.api import _resample
from minimax_speech_tpu.infer.matcha_text import process_text
from minimax_speech_tpu.models import matcha as j_m
from minimax_speech_tpu.models import matcha_hifigan as j_voc
from minimax_speech_tpu.ops.mel import hifigan_log_mel_np
from minimax_speech_tpu.utils.params_io import save_params
from tests.test_torch_legacy import random_variables
from tests import torch_cpu

torch_cpu.share_cores()

TEXTS = ["Hi there.", "One more, longer sentence here!"]


def _pcm(path):
    with wave.open(str(path)) as w:
        return np.frombuffer(w.readframes(w.getnframes()), np.int16)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """Random default-width Matcha and HiFi-GAN checkpoints (the vocoder's
    weight-norm g at its v's norm, as its initialiser sets it)."""
    root = tmp_path_factory.mktemp("matcha_ckpt")
    model = j_m.MatchaTTS(j_m.MatchaConfig())
    save_params(root / "matcha.npz", random_variables(functools.partial(
        model.init, jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
        jnp.array([8]), jnp.zeros((1, 16, 80)), jnp.array([16]),
        jax.random.PRNGKey(1)), seed=12))
    voc = random_variables(functools.partial(
        j_voc.MatchaHiFiGAN().init, jax.random.PRNGKey(0),
        jnp.zeros((1, 8, 80))), seed=13)

    def fix(tree):
        if "v" in tree:
            k, c = tree["v"].shape[:2]
            tree["v"] *= 10.0 / np.sqrt(k * c)
            tree["g"] = np.sqrt((tree["v"] ** 2).sum(axis=(0, 1)))
            return
        for sub in tree.values():
            fix(sub)

    fix(voc)
    save_params(root / "voc.npz", voc)
    return root


def test_matcha_cli_matches_jax_cli(ckpts, tmp_path):
    """--batched over TEXTS at temperature 0, 2 steps, 96 frames: the
    same utterances from both CLIs."""
    texts = tmp_path / "texts.txt"
    texts.write_text("\n".join(TEXTS))
    args = ["--file", str(texts), "--ckpt", str(ckpts / "matcha.npz"),
            "--vocoder_ckpt", str(ckpts / "voc.npz"), "--batched",
            "--temperature", "0", "--steps", "2", "--max_frames", "96",
            "--cleaners", "english_cleaners2"]
    j_cli.main(args + ["--output_folder", str(tmp_path / "jax")])
    summary = t_cli.main(args + ["--output_folder", str(tmp_path / "port"),
                                 "--device", "cpu"])
    assert summary["n"] == len(TEXTS) and summary["rtf_mean"] > 0
    for i in range(len(TEXTS)):
        name = f"utterance_{i:03d}"
        mel = np.load(tmp_path / "port" / f"{name}_mel.npy")
        ref = np.load(tmp_path / "jax" / f"{name}_mel.npy")
        assert mel.shape == ref.shape and mel.shape[0] > 0
        assert np.abs(mel - ref).max() <= 1e-4 * np.abs(ref).max()
        pcm, ref_pcm = (_pcm(tmp_path / d / f"{name}.wav")
                        for d in ("port", "jax"))
        assert len(pcm) == len(ref_pcm) == mel.shape[0] * 256
        assert np.abs(pcm.astype(int) - ref_pcm).max() <= 2


def test_matcha_cli_random_init_unbatched(tmp_path):
    """--random_init (hidden 64, 2 layers) per text: a wav and a finite
    mel per utterance; without --device, the CLI asks for cuda and
    raises here, where there is none."""
    out = tmp_path / "out"
    summary = t_cli.main(["--text", "Hello there.", "--random_init",
                          "--steps", "2", "--max_frames", "64",
                          "--output_folder", str(out), "--device", "cpu"])
    assert summary["n"] == 1
    mel = np.load(out / "utterance_000_mel.npy")
    assert mel.shape[1] == 80 and np.isfinite(mel).all()
    assert len(_pcm(out / "utterance_000.wav")) == mel.shape[0] * 256
    with pytest.raises(RuntimeError, match="CUDA"):
        t_cli.main(["--text", "Hi.", "--random_init",
                    "--output_folder", str(out)])


def _write_wav(path, audio, sr):
    pcm = (np.clip(audio, -1, 1) * 32767).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def test_train_matcha_cli(tmp_path):
    """Two utterances (one at 16 kHz, resampled), 2 epochs of batch 2 at
    the default width: the statistics JAX's pipeline gives, a metrics row
    per step with JAX's keys, finite losses, and a matcha.npz with the
    JAX initialiser's paths and shapes; make_matcha_train_step refuses to run
    on the CPU unasked."""
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    paths = []
    for i, (text, f0, sr) in enumerate([("hello world", 220.0, 22050),
                                        ("good morning", 330.0, 16000)]):
        t = np.arange(int(0.5 * sr)) / sr
        w = corpus / f"u{i}.wav"
        _write_wav(w, 0.4 * np.sin(2 * np.pi * f0 * t), sr)
        w.with_suffix(".txt").write_text(text)
        paths.append(str(w))
    lst = corpus / "data.list"
    lst.write_text("\n".join(paths))
    model_dir = tmp_path / "exp"
    steps_n = t_train.main([
        "--train_data", str(lst), "--model_dir", str(model_dir),
        "--num_epochs", "2", "--batch_size", "2", "--lr", "2e-3",
        "--warmup_steps", "1", "--log_interval", "1",
        "--cleaners", "transliteration_cleaners", "--device", "cpu"])
    assert steps_n == 2

    mels = []
    for p in paths:
        audio, sr = _load_audio(p)
        mels.append(hifigan_log_mel_np(
            _resample(audio, sr, 22050), n_fft=1024, n_mels=80, sr=22050,
            hop=256, win_length=1024).T)
        assert process_text(open(p[:-4] + ".txt").read().strip(),
                            ("transliteration_cleaners",))
    allm = np.concatenate(mels)
    stats = json.loads((model_dir / "matcha_stats.json").read_text())
    np.testing.assert_allclose([stats["mel_mean"], stats["mel_std"]],
                               [allm.mean(), allm.std()], rtol=1e-6)

    rows = [json.loads(r) for r in
            (model_dir / "matcha_metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2]
    for r in rows:
        assert r.keys() == {"step", "epoch", "loss", "dur", "prior", "cfm",
                            "elapsed_s"}
        assert np.isfinite(r["loss"])
        np.testing.assert_allclose(r["loss"], r["dur"] + r["prior"]
                                   + r["cfm"], rtol=1e-5)

    shapes = jax.eval_shape(functools.partial(
        j_m.MatchaTTS(j_m.MatchaConfig()).init, jax.random.PRNGKey(0),
        jnp.zeros((1, 32), jnp.int32), jnp.array([32]),
        jnp.zeros((1, 64, 80)), jnp.array([64]), jax.random.PRNGKey(1)))
    want = {path: s.shape for path, s in t_io._flatten(shapes).items()}
    got = t_io._flatten(t_io.load_params(str(model_dir / "matcha.npz")))
    assert {k: v.shape for k, v in got.items()} == want

    from minimax_speech_torch.models.matcha import MatchaTTS
    from minimax_speech_torch.train import steps
    with pytest.raises(RuntimeError, match="CUDA"):
        steps.make_matcha_train_step(MatchaTTS())
