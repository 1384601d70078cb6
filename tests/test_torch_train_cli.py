"""The port's LM data pipeline and training CLI, on the CPU.

The data stages against the JAX package's with Python's `random` seeded
the same way (int arrays equal, reference mels to 1e-4: the two hosts'
float32 STFTs sum in other orders), the CLI for one epoch on a tiny
synthetic corpus (configs/tiny.yaml, --device cpu): metrics, checkpoint,
resume, the two run-key fixes, and an --export_npz that JAX's SpeechLM
loads.
"""
import json
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minimax_speech_torch.cli import train as t_cli
from minimax_speech_torch.data import pipeline as t_dp
from minimax_speech_torch.infer import frontend as t_fe
from minimax_speech_tpu.data import pipeline as j_dp
from minimax_speech_tpu.infer import frontend as j_fe
from tests.test_train_cli import make_corpus


def _chain(dp, tokenizer, lst, frames=300):
    items = [{"src": line} for line in lst.read_text().splitlines()]
    return [
        lambda it: dp.individual_file_opener(it),
        lambda it: dp.tokenize(it, tokenizer),
        dp.filter_lengths, dp.resample, dp.extract_reference_mel,
        lambda it: dp.shuffle(it, 1000),
        lambda it: dp.sort_by_len(it, 500),
        lambda it: dp.dynamic_batch(it, frames),
        lambda it: dp.padding_llm(it, bistream_prob=0.5),
    ], dp.DataList(items)


def test_lm_batches_match_jax(tmp_path, rng):
    lst = make_corpus(tmp_path, rng, n=6)
    out = {}
    for name, dp, tok in (("jax", j_dp, j_fe.get_tokenizer(None)),
                          ("port", t_dp, t_fe.get_tokenizer(None))):
        stages, source = _chain(dp, tok, lst)
        source.set_epoch(3)
        random.seed(11)
        out[name] = list(dp.build_dataset(source, stages))
    assert len(out["port"]) == len(out["jax"]) > 1
    for ours, ref in zip(out["port"], out["jax"]):
        assert ours.keys() == ref.keys()
        for k in ref:
            if k == "reference_mel":
                np.testing.assert_allclose(ours[k], ref[k], atol=1e-4)
            else:
                np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


def test_byte_tokenizer_and_unported_paths(tmp_path):
    ref = j_fe.ByteTokenizer()
    ours = t_fe.get_tokenizer(None)
    text = "héllo, 世界"
    assert ours.encode(text) == ref.encode(text)
    assert ours.decode(ours.encode(text)) == text
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_fe.get_tokenizer("some/qwen")
    mp3 = tmp_path / "a.mp3"
    mp3.write_bytes(b"ID3\x04" + bytes(32))
    with pytest.raises(NotImplementedError, match="mp3"):
        list(t_dp.individual_file_opener([{"src": str(mp3)}]))
    for extra in (["--model", "flow"], ["--model", "llm", "--dpo"],
                  ["--model", "llm", "--distributed"],
                  ["--model", "llm", "--tp", "2"]):
        args = t_cli.parse_args(extra + ["--train_data", "x",
                                         "--model_dir", "y"])
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            t_cli.check_ported(args)


def _cli_args(lst, model_dir, *extra):
    return ["--model", "llm", "--config", "configs/tiny.yaml",
            "--train_data", str(lst), "--model_dir", str(model_dir),
            "--device", "cpu", "--max_epoch", "1",
            "--override", "train.save_per_step=2",
            "--override", "train.log_interval=1",
            "--override", "train.warmup_steps=0",
            "--override", "train.max_frames_in_batch=300", *extra]


def test_cli_epoch_checkpoint_resume_and_export(tmp_path, rng):
    lst = make_corpus(tmp_path, rng, n=6)
    model_dir = tmp_path / "exp"
    npz = tmp_path / "lm.npz"
    state = t_cli.main(_cli_args(lst, model_dir, "--cv_data", str(lst),
                                 "--export_npz", str(npz)))
    rows = [json.loads(line) for line in
            (model_dir / "llm_metrics.jsonl").read_text().splitlines()]
    losses = [r["loss"] for r in rows if "loss" in r]
    assert losses and all(np.isfinite(losses))
    assert any("cv/loss" in r for r in rows)
    steps_done = state.step
    assert steps_done >= 2
    ckpts = sorted(int(p.name) for p in (model_dir / "ckpt").iterdir())
    assert ckpts[-1] == steps_done and 2 in ckpts
    es = json.loads((model_dir / "epoch_state.json").read_text())
    assert es["end_steps"] == [steps_done]

    # the same run again: restored at the saved step, the epoch is done
    n_rows = len(rows)
    again = t_cli.main(_cli_args(lst, model_dir))
    assert again.step == steps_done
    new = (model_dir / "llm_metrics.jsonl").read_text().splitlines()[n_rows:]
    assert not any("loss" in json.loads(line) for line in new)
    for a, b in zip(again.module.parameters(), state.module.parameters()):
        torch.testing.assert_close(a, b, atol=0, rtol=0)

    # the exported .npz loads in JAX's SpeechLM and gives the port's loss
    from minimax_speech_torch.models import llm as t_llm
    from minimax_speech_tpu import config as j_cfg
    from minimax_speech_tpu.models import llm as j_llm
    from minimax_speech_tpu.utils.params_io import load_params
    jcfg_lm = j_cfg.build_tts_config(
        j_cfg.load_yaml("configs/tiny.yaml")["model"]).lm
    plan = t_llm.build_lm_plan([np.arange(1, 9)], [np.arange(30)], pad_to=64)
    spk = np.zeros((1, 32), np.float32)
    ref_loss, _ = j_llm.SpeechLM(jcfg_lm).apply(
        load_params(str(npz)), *(jnp.asarray(plan[k]) for k in
                                 ("src_type", "tok_id", "target", "seq_len")),
        jnp.asarray(spk))
    with torch.no_grad():
        loss, _ = state.module(*(torch.as_tensor(plan[k]) for k in (
            "src_type", "tok_id", "target", "seq_len")), torch.as_tensor(spk))
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)


def test_run_key_hashes_data_and_flags(tmp_path):
    a, b = tmp_path / "a.list", tmp_path / "b.list"
    a.write_text("x.wav\n")
    b.write_text("y.wav\n")

    def key(lst, *flags):
        return t_cli.run_key({"lr": 1e-4}, 2, str(lst), t_cli.parse_args(
            ["--model", "llm", "--train_data", str(lst), "--model_dir", "m",
             *flags]))

    base = key(a)
    assert key(a) == base
    assert len({base, key(b), key(a, "--bf16"), key(a, "--dpo"),
                key(a, "--init_ckpt", "w.npz")}) == 5


def test_resume_rolls_back_whole_epochs(tmp_path):
    """Epochs ended at steps 3, 6 and 9; a checkpoint at step 7 covers
    epochs 0 and 1 only, so the run restarts at epoch 2 (the JAX CLI
    subtracts the 2-step lag from the epoch index and restarts at 1)."""
    ep = tmp_path / "epoch_state.json"
    t_cli.write_epoch_state(ep, "k", [3, 6, 9])
    assert [t_cli.resume_epoch(ep, "k", s) for s in (2, 3, 7, 9)] \
        == [0, 1, 2, 3]
    assert t_cli.resume_epoch(ep, "other", 9) == 0
    assert t_cli.resume_epoch(ep, "k", 0) == 0


def test_checkpoint_keeps_newest_and_survives_faults(tmp_path, monkeypatch,
                                                     caplog):
    """Snapshots are renamed into place, the newest max_to_keep stay, a
    failed save logs and returns, and restore falls back past a
    snapshot that does not load."""
    from minimax_speech_torch.train import checkpoint, schedule, steps

    def state():
        torch.manual_seed(0)
        module = torch.nn.Linear(3, 2)
        return steps.make_train_state(module, schedule.make_optimizer())

    mgr = checkpoint.CheckpointManager(str(tmp_path), max_to_keep=2)
    s = state()
    for step in (1, 2, 3):
        with torch.no_grad():
            s.module.weight.fill_(step)
        assert mgr.save(step, s)
    assert mgr.all_steps() == [2, 3]
    assert not mgr.save(3, s)  # an existing step is kept

    def broken(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(checkpoint.torch, "save", broken)
    assert not mgr.save(4, s)
    assert "failed" in caplog.text and mgr.all_steps() == [2, 3]
    monkeypatch.undo()

    (tmp_path / "3" / checkpoint.STATE_FILE).write_bytes(b"truncated")
    fresh, step = mgr.restore(state())
    assert step == fresh.step == 2
    assert float(fresh.module.weight.detach()[0, 0]) == 2.0
