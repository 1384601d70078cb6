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


def _metrics(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_train_dac_cli_resume_and_export(tmp_path, rng):
    """2 iterations at the tiny dac geometry, a decode sample; a second
    call to 3 resumes at step 2 (both checkpoints) and exports, and JAX's
    load_params and DACVAE read the export: its decode equals the
    port's within 1e-5. Without --device the CLI raises (no GPU here);
    a transform other than Identity raises NotImplementedError."""
    _gan_corpus(tmp_path, rng)
    exp = tmp_path / "exp"
    args = ["--train_folders", str(tmp_path), "--model_dir", str(exp),
            "--config", "configs/tiny.yaml", "--batch_size", "2",
            "--log_interval", "1", "--save_iters", "2", "--sample_freq",
            "1", "--prefetch", "0"]
    with pytest.raises(RuntimeError, match="no CUDA"):
        t_train_dac.main(args + ["--num_iters", "1"])
    with pytest.raises(NotImplementedError, match="item 6"):
        t_train_dac.main(args + ["--augment", "BackgroundNoise"])
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
