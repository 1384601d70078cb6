"""The four flowae CLIs of the port against the JAX package's, end to
end on the CPU: train_flowae (dito, then zdm on the autoencoder),
dito_infer, train_flowae_image (dito, then a class-conditional zdm) and
image_dito, at tiny geometries on synthetic data.

What the two packages' runs share is held equal: the datasets, the
files each run writes, the .npz trees; each package's .npz loads in the
other (the autoencoders encode within 1e-5 of the peak, the priors
sample the same). The inference CLIs take their start noise from
`start_noises`, which the tests replace by JAX's draws: then
dito_infer's reconstruction matches JAX's within 1e-4 of the peak (PCM
within that and 1 LSB) and image_dito's grids within one 8-bit level.
Training draws differ between the packages (JAX keys, torch
generators), so the trained weights are not compared; the steps are,
in test_torch_flowae.py and test_torch_flowae_image.py.
"""
import argparse
import functools
import json
import re
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minimax_speech_torch.cli import dito_infer as t_infer
from minimax_speech_torch.cli import image_dito as t_imdito
from minimax_speech_torch.cli import train_flowae as t_train
from minimax_speech_torch.cli import train_flowae_image as t_train_img
from minimax_speech_torch.cli.synthesize import write_wav
from minimax_speech_torch.flowae import dito as t_dito
from minimax_speech_torch.utils import params_io as t_io
from minimax_speech_tpu.cli import dito_infer as j_infer
from minimax_speech_tpu.cli import image_dito as j_imdito
from minimax_speech_tpu.cli import train_flowae as j_train
from minimax_speech_tpu.cli import train_flowae_image as j_train_img
from minimax_speech_tpu.flowae import dito as j_dito
from minimax_speech_tpu.utils import params_io as j_io
from tests.test_torch_legacy import _peak_close, random_variables
from tests import torch_cpu

torch_cpu.share_cores()

AUDIO = ["--synthetic", "--steps", "1", "--eval_every", "0",
         "--save_every", "0", "--max_clips", "4", "--crop_len", "256",
         "--batch", "2", "--eval_batches", "1", "--eval_n_steps", "1",
         "--n_vis", "1", "--z_dim", "4", "--enc_channels", "8",
         "--hidden", "16", "--depth", "1", "--heads", "2"]
IMAGE = ["--synthetic", "--steps", "1", "--eval_every", "0",
         "--save_every", "0", "--max_images", "4", "--image_size", "16",
         "--batch", "2", "--eval_n_steps", "1", "--c0", "8", "--hidden",
         "16", "--depth", "1", "--heads", "2", "--renderer", "dit"]
CPU = ["--device", "cpu"]


def files(d):
    """Every file under d, relative; the random clip index of the AE's
    visuals masked."""
    return sorted(re.sub(r"(original|recons)_\d+", r"\1_i",
                         str(p.relative_to(d)))
                  for p in d.rglob("*") if p.is_file() and "ckpt" not in
                  p.parts)


def tree_shapes(path):
    return {k: v.shape for k, v in np.load(path).items()}


def read_pcm(path):
    with wave.open(str(path)) as w:
        return np.frombuffer(w.readframes(w.getnframes()), np.int16)


@pytest.mark.parametrize("main,argv", [
    (t_train.main, ["--save_dir", "x"]),
    (t_infer.main, ["--wav", "x.wav", "--random_init"]),
    (t_train_img.main, ["--save_dir", "x"]),
    (t_imdito.main, ["--ae_params", "x.npz", "--output", "x.png"])])
def test_cli_defaults_to_cuda(main, argv, tmp_path, monkeypatch):
    """Every flowae CLI runs on --device cuda unless told otherwise: here,
    with no GPU, it raises before it reads or writes anything."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
    assert list(tmp_path.iterdir()) == []


def test_train_flowae_matches_jax_and_interchanges(tmp_path):
    """--model dito then --model zdm in both packages: the same synthetic
    clips, the same files written, the same ae_params.npz tree; each
    package's prior trains on the other's autoencoder, which encodes as
    the writer's does. --model glpto is refused with JAX's message."""
    j, p = tmp_path / "jax", tmp_path / "port"
    j_train.main(["--model", "dito", "--save_dir", str(j / "ae")] + AUDIO)
    t_train.main(["--model", "dito", "--save_dir", str(p / "ae")] + AUDIO
                 + CPU)
    ns = argparse.Namespace(seed=0, crop_len=256, max_clips=4, wav_dir=None)
    np.testing.assert_array_equal(t_train.build_dataset(ns),
                                  j_train.build_dataset(ns))
    assert files(j / "ae") == files(p / "ae")
    assert tree_shapes(j / "ae" / "ae_params.npz") == \
        tree_shapes(p / "ae" / "ae_params.npz")
    jc = json.loads((j / "ae" / "config.json").read_text())
    pc = json.loads((p / "ae" / "config.json").read_text())
    assert pc.pop("device") == "cpu"
    assert {**jc, "save_dir": None} == {**pc, "save_dir": None}
    rows = [json.loads(r) for r in (p / "ae" / "dito_metrics.jsonl")
            .read_text().splitlines()]
    jrows = [json.loads(r) for r in (j / "ae" / "dito_metrics.jsonl")
             .read_text().splitlines()]
    assert [set(r) for r in rows] == [set(r) for r in jrows]
    assert all(np.isfinite(v) for r in rows for v in r.values())

    # each package's autoencoder in the other's prior
    j_train.main(["--model", "zdm", "--save_dir", str(j / "zdm"),
                  "--ae_params", str(p / "ae" / "ae_params.npz")] + AUDIO)
    t_train.main(["--model", "zdm", "--save_dir", str(p / "zdm"),
                  "--ae_params", str(j / "ae" / "ae_params.npz")] + AUDIO
                 + CPU)
    assert files(j / "zdm") == files(p / "zdm")
    x = t_train.build_dataset(ns)[:2]
    cfg = t_dito.DiToConfig(z_dim=4, enc_channels=8, enc_strides=(4, 4),
                            renderer=t_dito.DiTConfig(
                                hidden=16, depth=1, num_heads=2, patch=16,
                                in_channels=1, out_channels=1, cond_dim=4))
    jcfg = j_dito.DiToConfig(z_dim=4, enc_channels=8, enc_strides=(4, 4),
                             renderer=j_dito.DiTConfig(
                                 hidden=16, depth=1, num_heads=2, patch=16,
                                 in_channels=1, out_channels=1, cond_dim=4))
    for src in (j, p):
        tree = t_io.load_params(str(src / "ae" / "ae_params.npz"))
        with torch.no_grad():
            mu = t_dito.dito_from_tree(cfg, tree).encode(
                torch.from_numpy(x))[1]
        _peak_close(mu.numpy(), j_dito.DiToAudio(jcfg).apply(
            j_io.load_params(str(src / "ae" / "ae_params.npz")), x,
            method=j_dito.DiToAudio.encode)[1], 1e-5)
    t_train.main(["--model", "dito", "--save_dir", str(p / "ae"),
                  "--resume"] + AUDIO[:1] + ["--steps", "2"] + AUDIO[3:]
                 + CPU)  # from ckpt/1 to step 2
    assert sorted(q.name for q in (p / "ae" / "ckpt").iterdir()) == \
        ["1", "2"]
    assert [json.loads(r)["step"] for r in (p / "ae" / "dito_metrics.jsonl")
            .read_text().splitlines()][-2:] == [1, 2]
    with pytest.raises(SystemExit, match="glpto"):
        t_train.main(["--model", "glpto", "--save_dir", str(p / "g")] + CPU)


@pytest.fixture(scope="module")
def dito_default_npz(tmp_path_factory):
    """Random DiToConfig() weights (the CLI's model) for 1024-sample
    clips, written by the JAX package."""
    d = tmp_path_factory.mktemp("dito")
    model = j_dito.DiToAudio(j_dito.DiToConfig())
    v = random_variables(functools.partial(
        model.init, jax.random.PRNGKey(0), jnp.zeros((1, 1024, 1)),
        jax.random.PRNGKey(1), 0.0, method=j_dito.DiToAudio.loss), seed=21)
    j_io.save_params(str(d / "jax.npz"), v)
    return d / "jax.npz"


def jax_noises(shapes, seed):
    """The start noises the JAX CLIs draw from PRNGKey(seed): one decode
    draws from the key, a prior then renderer from its split."""
    key = jax.random.PRNGKey(seed)
    keys = [key] if len(shapes) == 1 else jax.random.split(key)
    return [torch.from_numpy(np.array(jax.random.normal(k, s)))
            for k, s in zip(keys, shapes)]


def test_dito_infer_matches_jax_both_ways(tmp_path, dito_default_npz,
                                          monkeypatch, capsys):
    """dito_infer --ckpt with a JAX-written and a port-written .npz: the
    latents within 1e-5 of the peak of JAX's dito_infer's on the same
    file, the reconstruction (JAX's start noise) within 1e-4 of the peak,
    as PCM within that and 1 LSB; the printed MSE and SNR agree."""
    rng = np.random.default_rng(5)
    t = np.arange(1100) / 24000
    write_wav(str(tmp_path / "in.wav"), 0.4 * np.sin(2 * np.pi * 330 * t)
              + 0.05 * rng.standard_normal(t.shape), 24000)
    port_npz = tmp_path / "port.npz"
    t_io.save_params(str(port_npz), t_io.init_params(
        t_dito.DiToAudio(t_dito.DiToConfig(), 1024),
        torch.Generator().manual_seed(3)))
    monkeypatch.setattr(t_infer, "start_noises", jax_noises)
    for npz in (dito_default_npz, port_npz):
        outs = {}
        for pkg, main in (("jax", j_infer.main), ("port", t_infer.main)):
            out = tmp_path / f"{pkg}_{npz.stem}"
            main(["--wav", str(tmp_path / "in.wav"), "--ckpt", str(npz),
                  "--out", f"{out}.wav", "--latents_out", f"{out}.npy",
                  "--n_steps", "2", "--seed", "4"]
                 + (CPU if pkg == "port" else []))
            outs[pkg] = (np.load(f"{out}.npy"), read_pcm(f"{out}.wav"),
                         capsys.readouterr().out.strip().splitlines()[-1])
        (jz, jpcm, jline), (pz, ppcm, pline) = outs["jax"], outs["port"]
        assert pz.shape == jz.shape == (16, 32)
        _peak_close(pz, jz, 1e-5)
        assert ppcm.shape == jpcm.shape == (1024,)
        lsb = np.abs(ppcm.astype(int) - jpcm).max()
        assert lsb <= 1e-4 * np.abs(jpcm).max() + 1, lsb
        nums = [re.findall(r"[-\d.]+(?=dB|\))", s) for s in (jline, pline)]
        assert nums[0] == nums[1], (jline, pline)


def test_image_clis_match_jax_and_interchange(tmp_path, monkeypatch):
    """train_flowae_image --model dito then --model zdm --class_cond in
    both packages: the same files, the same .npz trees; image_dito
    --sample with the other package's .npz files and JAX's start noises
    writes the grid JAX's image_dito writes within one 8-bit level, and
    --input --compare likewise. The default UNet renderer through the
    port's CLIs on the same data."""
    from PIL import Image
    j, p = tmp_path / "jax", tmp_path / "port"
    for pkg, main, extra in (("jax", j_train_img.main, []),
                             ("port", t_train_img.main, CPU)):
        d = j if pkg == "jax" else p
        main(["--model", "dito", "--save_dir", str(d / "ae")] + IMAGE
             + extra)
        main(["--model", "zdm", "--class_cond", "--save_dir",
              str(d / "zdm"), "--ae_params", str(d / "ae" /
                                                  "ae_params.npz")]
             + IMAGE + extra)
    for sub, npz in (("ae", "ae_params.npz"), ("zdm", "zdm_params.npz")):
        assert files(j / sub) == files(p / sub)
        assert tree_shapes(j / sub / npz) == tree_shapes(p / sub / npz)
    monkeypatch.setattr(t_imdito, "start_noises", jax_noises)
    geo = ["--image_size", "16", "--c0", "8", "--hidden", "16", "--depth",
           "1", "--heads", "2", "--renderer", "dit", "--n_steps", "2"]
    for src in (j, p):  # the files of `src` through both packages' CLIs
        args = ["--ae_params", str(src / "ae" / "ae_params.npz")] + geo
        cases = (["--sample", "3", "--n_classes", "2", "--zdm_params",
                  str(src / "zdm" / "zdm_params.npz")],
                 ["--input", str(src / "ae" / "recon_1.png"), "--compare"])
        for case in cases:
            grids = []
            for main, extra in ((j_imdito.main, []), (t_imdito.main, CPU)):
                out = tmp_path / f"g{len(grids)}.png"
                main(args + case + ["--output", str(out)] + extra)
                grids.append(np.asarray(Image.open(out)).astype(int))
            assert grids[0].shape == grids[1].shape
            assert np.abs(grids[0] - grids[1]).max() <= 1
    unet = [a for a in IMAGE if a not in ("--renderer", "dit")]
    t_train_img.main(["--model", "dito", "--save_dir", str(p / "u")] + unet
                     + CPU)
    t_imdito.main(["--ae_params", str(p / "u" / "ae_params.npz"), "--input",
                   str(p / "u" / "recon_1.png"), "--output",
                   str(p / "u.png"), "--image_size", "16", "--c0", "8",
                   "--n_steps", "1"] + CPU)
    assert Image.open(p / "u.png").size == (16, 16)
