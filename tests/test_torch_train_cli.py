"""The port's data pipeline and training CLI, LM and flow, on the CPU.

The data stages against the JAX package's with Python's `random` seeded
the same way (int arrays equal, reference mels to 1e-4: the two hosts'
float32 STFTs sum in other orders), the CLI for one epoch on a tiny
synthetic corpus (configs/tiny.yaml, --device cpu) with --model llm and
--model flow: metrics, checkpoint, resume, the two run-key fixes, and an
--export_npz that JAX's SpeechLM or FlowModel loads; the executor's
per-step draws.
"""
import json
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minimax_speech_torch.cli import train as t_cli
from minimax_speech_torch.data import pipeline as t_dp
from minimax_speech_torch.infer import frontend as t_fe
from minimax_speech_torch.parallel import mesh as t_mesh
from minimax_speech_tpu.data import pipeline as j_dp
from minimax_speech_tpu.infer import frontend as j_fe
from tests.test_train_cli import make_corpus
from tests import torch_cpu

torch_cpu.share_cores()


def _chain(dp, tokenizer, lst, frames=300, model_kind="llm"):
    items = [{"src": line} for line in lst.read_text().splitlines()]
    pad = dp.padding_flow if model_kind == "flow" else \
        (lambda it: dp.padding_llm(it, bistream_prob=0.5))
    return [
        lambda it: dp.individual_file_opener(it),
        lambda it: dp.tokenize(it, tokenizer),
        dp.filter_lengths, dp.resample, dp.extract_reference_mel,
        lambda it: dp.shuffle(it, 1000),
        lambda it: dp.sort_by_len(it, 500),
        lambda it: dp.dynamic_batch(it, frames),
        pad,
    ], dp.DataList(items)


def test_lm_batches_match_jax(tmp_path, rng):
    _assert_batches_match(tmp_path, rng, "llm")


def test_flow_batches_match_jax(tmp_path, rng):
    """The flow chain, ending in padding_flow: tokens, latents and their
    lengths identical, reference mels to 1e-4."""
    _assert_batches_match(tmp_path, rng, "flow")


def _assert_batches_match(tmp_path, rng, model_kind):
    lst = make_corpus(tmp_path, rng, n=6)
    out = {}
    for name, dp, tok in (("jax", j_dp, j_fe.get_tokenizer(None)),
                          ("port", t_dp, t_fe.get_tokenizer(None))):
        stages, source = _chain(dp, tok, lst, model_kind=model_kind)
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
    with pytest.raises(FileNotFoundError, match="some/qwen"):
        t_fe.get_tokenizer("some/qwen")
    mp3 = tmp_path / "a.mp3"  # an ID3 tag and no frames: skipped, logged
    mp3.write_bytes(b"ID3\x04" + bytes(32))
    assert list(t_dp.individual_file_opener([{"src": str(mp3)}])) == []

    def args(*extra):
        return t_cli.parse_args([*extra, "--train_data", "x",
                                 "--model_dir", "y"])

    # one process drives one GPU: --dp/--tp > 1 need --distributed ranks
    # (cli/launch.py), and --distributed needs its rendezvous
    for extra in (["--model", "llm", "--tp", "2"],
                  ["--model", "flow", "--dp", "2"],
                  ["--model", "llm", "--distributed"],
                  ["--model", "flow", "--distributed", "--tp", "2"]):
        with pytest.raises(ValueError, match="launch|--coordinator"):
            t_cli.check_ported(args(*extra))
    t_cli.check_ported(args("--model", "llm", "--distributed", "--tp", "2",
                            "--coordinator", "127.0.0.1:1",
                            "--num_processes", "2", "--process_id", "0"))
    # dp x tp must be the world size (1 outside torch.distributed)
    for dp, tp in ((2, 1), (1, 2), (2, 2)):
        with pytest.raises(ValueError, match="world size"):
            t_mesh.make_mesh(dp, tp)
    t_cli.check_ported(args("--model", "llm", "--dpo"))
    with pytest.raises(ValueError, match="--model llm"):
        t_cli.check_ported(args("--model", "flow", "--dpo"))


def _cli_args(lst, model_dir, *extra, model="llm"):
    return ["--model", model, "--config", "configs/tiny.yaml",
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


def test_flow_cli_epoch_checkpoint_resume_and_export(tmp_path, rng):
    """--model flow with --latent_stats for one epoch, cv after it (no
    grad: K1's plain version), a second call that resumes at the saved
    step, and an --export_npz that JAX's FlowModel (with the same stats)
    applies: its loss under one JAX key within 1e-5 relative of the
    port's on that key's draws."""
    from minimax_speech_tpu import config as j_cfg
    from minimax_speech_tpu.models import flow as j_flow
    from minimax_speech_tpu.utils.params_io import load_params
    from tests.test_torch_flow_train import flow_batch, jax_flow_draws

    lst = make_corpus(tmp_path, rng, n=6)
    model_dir = tmp_path / "exp"
    npz = tmp_path / "flow.npz"
    stats = tmp_path / "latent_stats.json"
    stats.write_text(json.dumps({"mean": [0.1] * 80, "std": [1.5] * 80}))
    argv = _cli_args(lst, model_dir, "--latent_stats", str(stats),
                     model="flow")
    state = t_cli.main(argv + ["--cv_data", str(lst), "--export_npz",
                               str(npz)])
    rows = [json.loads(line) for line in
            (model_dir / "flow_metrics.jsonl").read_text().splitlines()]
    steps = [r for r in rows if "loss" in r]
    assert steps and all(np.isfinite(r["loss"]) for r in steps)
    assert all(r["grad_norm/encoder"] > 0 and r["grad_norm/estimator"] > 0
               for r in steps)
    assert any("cv/loss" in r and np.isfinite(r["cv/loss"]) for r in rows)
    assert state.module.cfg.latent_std == (1.5,) * 80
    steps_done = state.step
    assert steps_done >= 2
    ckpts = sorted(int(p.name) for p in (model_dir / "ckpt").iterdir())
    assert ckpts[-1] == steps_done and 2 in ckpts

    again = t_cli.main(argv)
    assert again.step == steps_done
    new = (model_dir / "flow_metrics.jsonl").read_text().splitlines()[
        len(rows):]
    assert not any("loss" in json.loads(line) for line in new)
    for a, b in zip(again.module.parameters(), state.module.parameters()):
        torch.testing.assert_close(a, b, atol=0, rtol=0)

    data = j_cfg.apply_overrides(j_cfg.load_yaml("configs/tiny.yaml"), [
        "model.flow.latent_mean=" + json.dumps([0.1] * 80),
        "model.flow.latent_std=" + json.dumps([1.5] * 80)])
    jcfg = j_cfg.build_tts_config(data["model"]).flow
    batch = flow_batch(seed=4)
    emb = np.random.default_rng(4).standard_normal((3, 12)).astype(
        np.float32)
    key = jax.random.PRNGKey(1)
    ref = j_flow.FlowModel(jcfg).apply(
        load_params(str(npz)), *(jnp.asarray(batch[k]) for k in (
            "token", "token_len", "feat", "feat_len")), jnp.asarray(emb), key)
    with torch.no_grad():
        loss = state.module(*(torch.as_tensor(batch[k]) for k in (
            "token", "token_len", "feat", "feat_len")), torch.as_tensor(emb),
            jax_flow_draws(key, state.module.cfg, 3, 18))
    np.testing.assert_allclose(float(loss), float(ref), rtol=1e-5)


def dpo_corpus(tmp_path, rng, n=6):
    """make_corpus with a <stem>_fsq_reject.npy beside every wav but the
    last (its sample is dropped under --dpo), of other lengths than the
    chosen tokens."""
    lst = make_corpus(tmp_path, rng, n=n)
    for wav in lst.read_text().splitlines()[:-1]:
        n_tok = len(np.load(wav[:-4] + "_fsq.npy"))
        np.save(wav[:-4] + "_fsq_reject.npy", rng.integers(
            0, 6561, n_tok + int(rng.integers(-9, 10))).astype(np.int32))
    return lst


def test_dpo_batches_match_jax(tmp_path, rng):
    """The --dpo chain (build_stages(..., dpo=True)) against JAX's: the
    same batches under one random.seed, chosen and _rej plans identical,
    reference mels to 1e-4, the sample without a reject gone."""
    from minimax_speech_tpu.cli import train as j_cli

    lst = dpo_corpus(tmp_path, rng)
    tcfg = {"max_frames_in_batch": 200, "bistream_prob": 0.5}
    items = [{"src": line} for line in lst.read_text().splitlines()]
    out = {}
    for name, cli, dp, tok in (
            ("jax", j_cli, j_dp, j_fe.get_tokenizer(None)),
            ("port", t_cli, t_dp, t_fe.get_tokenizer(None))):
        source = dp.DataList(items)
        source.set_epoch(2)
        random.seed(5)
        out[name] = list(dp.build_dataset(source, cli.build_stages(
            tcfg, tok, "llm", dpo=True)))
    assert len(out["port"]) == len(out["jax"]) > 1
    assert sum(len(b["seq_len"]) for b in out["port"]) == 5
    for ours, ref in zip(out["port"], out["jax"]):
        assert ours.keys() == ref.keys()
        assert "tok_id_rej" in ours
        for k in ref:
            if k == "reference_mel":
                np.testing.assert_allclose(ours[k], ref[k], atol=1e-4)
            else:
                np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


def test_dpo_cli_epoch_resume_and_export(tmp_path, rng):
    """--dpo --ref_ckpt for one epoch with the policy under remat
    (--override model.lm.qwen.remat=true): the four dpo/* metrics in
    every step's row, finite, the rewards not 0 (the reference differs
    from the policy); a second call resumes at the saved step; the
    --export_npz loads in JAX's SpeechLM and gives the port's sequence
    log-probs (1e-5 relative)."""
    from minimax_speech_torch.models import llm as t_llm
    from minimax_speech_torch.utils import params_io as t_io
    from minimax_speech_tpu import config as j_cfg
    from minimax_speech_tpu.models import llm as j_llm
    from minimax_speech_tpu.utils.params_io import load_params

    from minimax_speech_torch import config as t_cfg

    lst = dpo_corpus(tmp_path, rng)
    lm_cfg = t_cfg.build_tts_config(
        t_cfg.load_yaml("configs/tiny.yaml")["model"]).lm
    ref_npz = tmp_path / "ref.npz"
    t_io.save_params(str(ref_npz), t_io.init_params(
        t_llm.SpeechLM(lm_cfg), torch.Generator().manual_seed(9)))
    model_dir = tmp_path / "exp"
    npz = tmp_path / "policy.npz"
    argv = _cli_args(lst, model_dir, "--dpo", "--ref_ckpt", str(ref_npz),
                     "--override", "model.lm.qwen.remat=true")
    state = t_cli.main(argv + ["--export_npz", str(npz)])
    assert state.module.cfg.qwen.remat
    rows = [json.loads(line) for line in
            (model_dir / "llm_metrics.jsonl").read_text().splitlines()]
    steps = [r for r in rows if "dpo/loss" in r]
    keys = {"dpo/loss", "dpo/chosen_reward", "dpo/rejected_reward",
            "dpo/reward_acc"}
    assert len(steps) == state.step >= 2
    assert all(keys <= r.keys() and "loss" not in r for r in steps)
    assert all(np.isfinite([r[k] for k in keys]).all() for r in steps)
    assert any(r["dpo/chosen_reward"] != 0 for r in steps)

    again = t_cli.main(argv)
    assert again.step == state.step
    for a, b in zip(again.module.parameters(), state.module.parameters()):
        torch.testing.assert_close(a, b, atol=0, rtol=0)

    jlm = j_cfg.build_tts_config(
        j_cfg.load_yaml("configs/tiny.yaml")["model"]).lm
    plan = t_llm.build_lm_plan([np.arange(1, 9)], [np.arange(30)], pad_to=64)
    spk = np.full((1, 32), 0.1, np.float32)
    ref = j_llm.SpeechLM(jlm).apply(
        load_params(str(npz)), *(jnp.asarray(plan[k]) for k in (
            "src_type", "tok_id", "target", "seq_len")), jnp.asarray(spk),
        method=j_llm.SpeechLM.sequence_logp)
    with torch.no_grad():
        ours = state.module.sequence_logp(*(torch.as_tensor(plan[k]) for k in (
            "src_type", "tok_id", "target", "seq_len")), torch.as_tensor(spk))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5)


def test_executor_draws_follow_the_global_step(tmp_path):
    """A step that takes draws gets them from a generator seeded with
    (seed << 32) | global step: a run resumed at step 1 draws for it what
    the uninterrupted run drew; cv batch i draws from seed i, as JAX's
    PRNGKey(i); a step without draws gets none."""
    from minimax_speech_torch.train import executor, schedule
    from minimax_speech_torch.train import steps as t_steps
    from minimax_speech_torch.utils.logging import MetricsLogger

    seen = []

    def step_fn(state, batch, draws=None):
        seen.append(draws)
        state.step += 1
        return state, {}

    def run(start, n, make_draws):
        state = t_steps.make_train_state(torch.nn.Linear(2, 2),
                                         schedule.make_optimizer())
        state.step = start
        ex = executor.Executor(step_fn, state, MetricsLogger(
            str(tmp_path), name="t", log_interval=100), device="cpu",
            make_draws=make_draws)
        ex.train_one_epoch([{}] * n)
        return ex

    def draws(batch, gen):
        return torch.rand(4, generator=gen)

    run(0, 3, draws)
    full, seen[:] = list(seen), []
    run(1, 2, draws)
    for a, b in zip(seen, full[1:]):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    torch.testing.assert_close(full[1], torch.rand(
        4, generator=torch.Generator().manual_seed((1986 << 32) | 1)))
    assert not torch.equal(full[0], full[1])
    ex = run(5, 0, draws)
    cv = ex.cv([{}] * 2, lambda state, batch, d: {"x": d[0]})
    np.testing.assert_allclose(cv["cv/x"], np.mean(
        [float(torch.rand(1, generator=torch.Generator().manual_seed(i)))
         for i in range(2)]), rtol=1e-6)
    seen.clear()
    run(0, 1, None)
    assert seen == [None]


def test_run_key_hashes_data_and_flags(tmp_path):
    a, b = tmp_path / "a.list", tmp_path / "b.list"
    a.write_text("x.wav\n")
    b.write_text("y.wav\n")

    def key(lst, *flags, model="llm", stats=None):
        return t_cli.run_key({"lr": 1e-4}, 2, str(lst), t_cli.parse_args(
            ["--model", model, "--train_data", str(lst), "--model_dir", "m",
             *flags]), stats)

    base = key(a)
    assert key(a) == base
    stats = {"mean": [0.0] * 80, "std": [2.0] * 80}
    assert len({base, key(b), key(a, "--bf16"), key(a, "--dpo"),
                key(a, "--init_ckpt", "w.npz"), key(a, model="flow"),
                key(a, model="flow", stats=stats),
                key(a, "--dpo", "--ref_ckpt", "r.npz")}) == 8


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
