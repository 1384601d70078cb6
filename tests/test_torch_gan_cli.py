"""The port's codec and vocoder GAN training CLIs (cli/train_dac.py,
cli/train_hift.py) on the CPU at the tiny geometry of configs/tiny.yaml:
iterations, metrics, checkpoints, resume and the DAC export, which the
JAX package's load_params and DACVAE read (its decode within 1e-5 of
the port's).
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minimax_speech_torch.cli import train_dac as t_train_dac
from minimax_speech_torch.cli import train_hift as t_train_hift
from minimax_speech_torch.models import dac_vae as t_dac
from minimax_speech_torch.utils import params_io as t_io
from minimax_speech_tpu.models import dac_vae as j_dac
from minimax_speech_tpu.utils import params_io as j_io
from tests.test_torch_hift_train import _gan_corpus
from tests import torch_cpu

torch_cpu.share_cores()


def _metrics(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_train_dac_cli_resume_and_export(tmp_path, rng):
    """2 iterations at the tiny dac geometry, a decode sample; a second
    call to 3 resumes at step 2 (both checkpoints) and exports, and JAX's
    load_params and DACVAE read the export: its decode equals the
    port's within 1e-5. Without --device the CLI raises (no GPU here).
    Then 2 iterations with a chain of transforms at --augment_prob 0.5:
    each batch the step trains on is JAX's CLI's transform of the same
    crops on the same key (PRNGKey(10_000_019 + iteration)), within 2e-5
    of its largest sample (tests/test_torch_audiotools.py's limit), the
    port's apply given JAX's draws; the port's own draws run too."""
    _gan_corpus(tmp_path, rng)
    exp = tmp_path / "exp"
    args = ["--train_folders", str(tmp_path), "--model_dir", str(exp),
            "--config", "configs/tiny.yaml", "--batch_size", "2",
            "--log_interval", "1", "--save_iters", "2", "--sample_freq",
            "1", "--prefetch", "0"]
    with pytest.raises(RuntimeError, match="no CUDA"):
        t_train_dac.main(args + ["--num_iters", "1"])
    _chained_run(tmp_path, args)
    t_train_dac.main(args + ["--num_iters", "2", "--device", "cpu"])
    assert (exp / "sample_1.npy").exists()
    assert sorted(p.name for p in (exp / "ckpt_g").iterdir()) == ["2"]
    assert [r["step"] for r in _metrics(exp / "dac_metrics.jsonl")] == [0, 1]
    npz = tmp_path / "dac.npz"
    t_train_dac.main(args + ["--num_iters", "3", "--device", "cpu",
                             "--export_npz", str(npz)])
    assert [r["step"] for r in _metrics(exp / "dac_metrics.jsonl")] == [
        0, 1, 2]
    assert sorted(p.name for p in (exp / "ckpt_d").iterdir()) == ["2", "3"]
    from minimax_speech_torch import config as t_cfg
    from minimax_speech_tpu import config as j_cfg
    variables = j_io.load_params(str(npz))
    jm = j_dac.DACVAE(j_cfg.load_tts_config("configs/tiny.yaml").dac)
    port = t_io.load_flax_params(t_dac.DACVAE(t_cfg.load_tts_config(
        "configs/tiny.yaml").dac), variables)
    z = rng.standard_normal((1, 3, 80)).astype(np.float32)
    ref = np.asarray(jm.apply(variables, jnp.asarray(z),
                              method=j_dac.DACVAE.decode))
    with torch.no_grad():
        ours = port.decode(torch.as_tensor(z)).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-5)


def _chained_run(tmp_path, args):
    import jax

    from minimax_speech_torch.utils import audio_transforms as t_at
    from minimax_speech_tpu.utils import audio_signal as j_as
    from minimax_speech_tpu.utils import audio_transforms as j_at
    from tests.test_torch_audiotools import jax_draws

    seen, build = [], t_at.build_transform

    def replay(**kw):
        ours, ref = build(**kw), j_at.build_transform(**kw)

        def call(gen, sig):
            key = jax.random.PRNGKey(gen.initial_seed())
            jsig = j_as.AudioSignal(sig.audio_data.numpy(), sig.sample_rate)
            own = ours(gen, sig).audio_data
            assert own.shape == sig.audio_data.shape
            assert torch.isfinite(own).all()
            out = ours.apply(jax_draws(ref, key, jsig), sig)
            seen.append((gen.initial_seed(), out.audio_data.numpy(),
                         np.asarray(ref(key, jsig).audio_data)))
            return out
        return call

    with pytest.MonkeyPatch.context() as m:
        m.setattr(t_at, "build_transform", replay)
        t_train_dac.main(args[:3] + [str(tmp_path / "chain")] + args[4:] + [
            "--num_iters", "2", "--device", "cpu", "--preprocess",
            "VolumeNorm", "--augment", "LowPass", "Equalizer",
            "BackgroundNoise", "--postprocess", "RescaleAudio",
            "--augment_prob", "0.5"])
    assert [s for s, _, _ in seen] == [t_train_dac.TRANSFORM_SEED + i
                                       for i in range(2)]
    for _, ours, ref in seen:
        np.testing.assert_allclose(ours, ref, rtol=0,
                                   atol=2e-5 * np.abs(ref).max())


def test_train_hift_cli_list_and_folders(tmp_path, rng):
    """--train_data with --with_pitch at the tiny hift geometry: 2
    iterations (every gen/* metric, gen/f0 included), then a resume to 3;
    --train_folders for 1 iteration."""
    lst = _gan_corpus(tmp_path, rng)
    exp = tmp_path / "exp"
    args = ["--train_data", str(lst), "--with_pitch", "--model_dir",
            str(exp), "--config", "configs/tiny.yaml", "--batch_size", "2",
            "--duration", "0.5", "--log_interval", "1", "--save_iters", "5",
            "--prefetch", "0", "--device", "cpu"]
    t_train_hift.main(args + ["--num_iters", "2"])
    rows = _metrics(exp / "hift_metrics.jsonl")
    assert [r["step"] for r in rows] == [0, 1]
    assert {"gen/loss", "gen/adv", "gen/feat", "gen/mel", "gen/tpr",
            "gen/f0", "disc/loss"} <= rows[0].keys()
    assert all(np.isfinite(v) for r in rows for v in r.values())
    t_train_hift.main(args + ["--num_iters", "3"])
    assert [r["step"] for r in _metrics(exp / "hift_metrics.jsonl")] == [
        0, 1, 2]
    assert sorted(p.name for p in (exp / "ckpt_g").iterdir()) == ["2", "3"]
    folders = ["--train_folders", str(tmp_path), "--model_dir",
               str(tmp_path / "exp2"), "--config", "configs/tiny.yaml",
               "--batch_size", "2", "--duration", "0.5", "--num_iters", "1",
               "--prefetch", "0", "--device", "cpu"]
    t_train_hift.main(folders)
    assert (tmp_path / "exp2" / "ckpt_d" / "1").exists()
