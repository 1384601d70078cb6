"""Multi-process training in the port against the JAX package on a mesh.

The port's side runs in gangs of 2 and 4 gloo ranks on the CPU
(utils/gang.Gang with the jobs of tests/torch_gang.py), started once for
this module; the JAX side on the 8 CPU devices tests/conftest.py forces,
on a dp x tp mesh of make_mesh(dp, tp, devices=jax.devices()[:dp * tp])
with make_train_state(..., mesh, kind). The global batch is ragged: its dp
halves hold different target counts, so a mean of per-rank means is
another function (the control test shows it lands outside the limits).

Limits (float32 on both sides, other summation orders): loss and
accuracy 1e-5 relative; grad_norm and the per-component norms 1e-4
relative; every leaf's gathered first-step gradient within 1e-4 of that
leaf's largest element; the parameters after 2 AdamW steps where the
first step's gradient pins them (|g| >= 1e-4 of the leaf's largest, as
tests/test_torch_flow_train.py's rule): within 5% of lr per update, all
but 0.1% within 1e-6. Adam moves a weight by about lr whatever the
gradient's size, so where it is ~0 (a key bias under softmax) the sign
rests on rounding: those elements are held within Adam's 2 lr per
update.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from minimax_speech_torch.models import llm as t_llm
from minimax_speech_torch.train import schedule as t_sched
from minimax_speech_torch.train import steps as t_steps
from minimax_speech_torch.train.checkpoint import CheckpointManager
from minimax_speech_torch.utils import params_io as t_io
from minimax_speech_torch.utils.gang import Gang
from minimax_speech_tpu.models import flow as j_flow
from minimax_speech_tpu.models import llm as j_llm
from minimax_speech_tpu.parallel import mesh as j_mesh
from minimax_speech_tpu.train import gan_steps as j_gan
from minimax_speech_tpu.train import schedule as j_sched
from minimax_speech_tpu.train import steps as j_steps
from minimax_speech_tpu.utils.params_io import load_params as j_load
from tests import torch_gang
from tests.test_torch_bridge import jitter, tiny_port_cfg
from tests.test_torch_flow_train import jax_flow_draws
from tests.test_train_cli import make_corpus
from tests import torch_cpu

torch_cpu.share_cores()

REPO = Path(__file__).resolve().parent.parent
LR = 1e-3
OPT = dict(lr=LR, warmup_steps=0, grad_clip=0.5)
# dp halves of 40 + 61 and 25 + 12 speech tokens
N_TEXT, N_SPEECH = (5, 9, 7, 6), (40, 61, 25, 12)


def _start(size: int) -> Gang:
    return Gang(size, torch_gang.__name__, "gloo", "cpu", threads=1,
                timeout=180)


@pytest.fixture(scope="module")
def gang2():
    g = _start(2)
    yield g
    g.close()


@pytest.fixture(scope="module")
def gang4():
    g = _start(4)
    yield g
    g.close()


def _gang(request, dp, tp):
    return request.getfixturevalue("gang4" if dp * tp == 4 else "gang2")


@pytest.fixture(scope="module")
def lm():
    jcfg, pcfg = tiny_port_cfg()
    model = j_llm.SpeechLM(jcfg.lm)
    init = jax.jit(j_llm.init_lm_variables, static_argnums=0)
    return model, jitter(init(model, jax.random.PRNGKey(2)), seed=2), pcfg


def lm_batch(seed, n_speech=N_SPEECH, rej=False):
    """A global batch of 4 plans padded to 128 and ragged reference mels
    (with rej, DPO's rejected plans of other lengths too)."""
    rng = np.random.default_rng(seed)
    text = [rng.integers(1, 256, n) for n in N_TEXT]
    out = {}
    for sfx, ns in (("", n_speech), ("_rej", (33, 70, 18, 30))
                    )[:2 if rej else 1]:
        plan = j_llm.build_lm_plan(text, [rng.integers(0, 6561, n)
                                          for n in ns], pad_to=128)
        out.update({k + sfx: v for k, v in plan.items()})
    mel_len = np.array([48, 31, 40, 20], np.int32)
    ref = np.zeros((4, 64, 80), np.float32)
    for i, n in enumerate(mel_len):
        ref[i, :n] = rng.standard_normal((n, 80)) * 0.5
    return {**out, "reference_mel": ref, "reference_mel_len": mel_len}


def _jax_mesh(dp, tp):
    return j_mesh.make_mesh(dp, tp, devices=jax.devices()[:dp * tp])


def _jax_run(step, params, batches, dp, tp, kind, keys=None):
    """JAX's metrics per step and parameters on a dp x tp mesh."""
    mesh = _jax_mesh(dp, tp)
    state = j_steps.make_train_state(params, j_sched.make_optimizer(**OPT),
                                     mesh, kind=kind)
    # the state keeps its layouts, so the second step reuses the compile
    layouts = jax.tree_util.tree_map(
        lambda x: x.sharding if isinstance(x.sharding, NamedSharding)
        else j_mesh.replicated(mesh), state)
    state = jax.device_put(state, layouts)
    step = jax.jit(step, out_shardings=(layouts, None))
    metrics = []
    for i, batch in enumerate(batches):
        placed = jax.device_put({k: np.asarray(v) for k, v in batch.items()},
                                j_mesh.batch_sharding(mesh))
        args = (placed,) if keys is None else (placed, keys[i])
        state, m = step(state, *args)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, t_io._flatten(jax.device_get(state.params))


def _check(port, jax_metrics, jax_grads, jax_params, symmetric=()):
    """The module's limits on metrics, first-step gradients and the
    parameters after the steps."""
    metrics, grads, params = port
    for ours, ref in zip(metrics, jax_metrics):
        assert ours.keys() == ref.keys()
        for k in ref:
            rtol = 1e-4 if k.startswith("grad_norm") else 1e-5
            np.testing.assert_allclose(ours[k], ref[k], rtol=rtol,
                                       atol=1e-7, err_msg=k)
    theirs = t_io._flatten(jax_grads)
    assert grads.keys() == theirs.keys()
    top = max(float(np.abs(np.asarray(g)).max()) for g in theirs.values())
    for path, g in grads.items():
        ref = np.asarray(theirs[path])
        if path[-2:] in symmetric:  # zero by symmetry: rounding only
            assert np.abs(g).max() <= 1e-6 * top, path
            continue
        np.testing.assert_allclose(g, ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max(),
                                   err_msg="/".join(path))
    diffs, n = [], len(metrics)
    for path, p in params.items():
        g = np.abs(np.asarray(theirs[path]))
        pinned = g >= 1e-4 * g.max()
        d = np.abs(p - np.asarray(jax_params[path]))
        assert d.max() <= 2 * LR * n, ("/".join(path), d.max())
        if pinned.any():
            assert d[pinned].max() <= 0.05 * LR * n, ("/".join(path),
                                                      d[pinned].max())
        diffs.append(d[pinned])
    diffs = np.concatenate(diffs)
    assert np.mean(diffs > 1e-6) <= 1e-3, np.quantile(diffs, [0.99, 0.999])


@pytest.fixture(scope="module")
def lm_ref(lm):
    """JAX's first-step gradients on the global batch."""
    model, variables, _ = lm
    batch = lm_batch(0)
    loss = j_steps.make_lm_loss_fn(model)
    (_, _), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"], {k: jnp.asarray(v) for k, v in batch.items()})
    return [batch, lm_batch(1)], grads


@pytest.mark.parametrize("dp,tp", [(2, 1), (1, 2), (2, 2)])
def test_lm_step_matches_jax_mesh(request, lm, lm_ref, dp, tp):
    """Two LM steps at dp x tp against JAX's on the same mesh."""
    model, variables, pcfg = lm
    batches, jgrads = lm_ref
    jm, jparams = _jax_run(j_steps.make_lm_train_step(model),
                           variables["params"], batches, dp, tp, "lm")
    port = _gang(request, dp, tp).run(
        "train_job", "llm", pcfg.lm, variables, batches, dp, tp, OPT)[0]
    _check(port, jm, jgrads, jparams)


@pytest.mark.parametrize("policy", ["dots", "none"])
def test_remat_recomputes_through_the_collectives(gang2, lm, lm_ref, policy):
    """Per-layer remat at tp = 2: torch.utils.checkpoint's recompute runs
    each layer's tensor-parallel collectives again; the loss and every
    leaf's first-step gradient within 1e-6 of each leaf's largest of the
    run without remat (as tests/test_torch_train.py holds remat in one
    process)."""
    _, variables, pcfg = lm
    batches = lm_ref[0][:1]
    cfg = dataclasses.replace(pcfg.lm, qwen=dataclasses.replace(
        pcfg.lm.qwen, remat=True, remat_policy=policy))
    off = gang2.run("train_job", "llm", pcfg.lm, variables, batches, 1, 2,
                    OPT)[0]
    on = gang2.run("train_job", "llm", cfg, variables, batches, 1, 2, OPT)[0]
    np.testing.assert_allclose(on[0][0]["loss"], off[0][0]["loss"],
                               rtol=1e-6)
    for path, g in off[1].items():
        np.testing.assert_allclose(on[1][path], g, rtol=0,
                                   atol=1e-6 * np.abs(g).max(),
                                   err_msg="/".join(path))


def test_dpo_step_matches_jax_mesh(gang2, lm):
    """Two DPO steps at dp = 2 against JAX's: the dpo/* metrics, the
    gradients and the parameters."""
    model, policy, pcfg = lm
    reference = jitter(policy, seed=5)
    batches = [lm_batch(3, rej=True), lm_batch(4, rej=True)]
    jstep = j_gan.make_dpo_step(model, reference["params"])
    jm, jparams = _jax_run(jstep, policy["params"], batches, 2, 1, "lm")
    loss = _jax_dpo_loss(model, reference["params"])
    jgrads = jax.jit(jax.grad(loss))(policy["params"], {
        k: jnp.asarray(v) for k, v in batches[0].items()})
    port = gang2.run("train_job", "dpo", pcfg.lm, policy, batches, 2, 1,
                     OPT, None, reference)[0]
    _check(port, jm, jgrads, jparams)


def _jax_dpo_loss(model, ref_params):
    """JAX's DPO loss of the policy's parameters (its step's loss)."""
    from minimax_speech_tpu.utils import losses as j_losses
    plan = ("src_type", "tok_id", "target", "seq_len")

    def logps(params, batch):
        spk = model.apply({"params": params}, batch["reference_mel"],
                          jnp.arange(batch["reference_mel"].shape[1])[None]
                          < batch["reference_mel_len"][:, None],
                          method=j_llm.SpeechLM.embed_speaker)
        return [model.apply({"params": params},
                            *(batch[k + sfx] for k in plan), spk,
                            method=j_llm.SpeechLM.sequence_logp)
                for sfx in ("", "_rej")]

    def loss(params, batch):
        ref_c, ref_r = logps(ref_params, batch)
        c, r = logps(params, batch)
        return j_losses.dpo_loss(c, r, jax.lax.stop_gradient(ref_c),
                                 jax.lax.stop_gradient(ref_r), 0.01)[0]
    return loss


@pytest.fixture(scope="module")
def flow():
    jcfg, pcfg = tiny_port_cfg()
    model = j_flow.FlowModel(jcfg.flow)
    init = jax.jit(j_flow.init_flow_variables, static_argnums=0)
    return model, jitter(init(model, jax.random.PRNGKey(2)), seed=2), pcfg


def flow_batch4(seed):
    """A padding_flow-shaped global batch of 4: ragged tokens (dp halves
    of 15 and 11), their 2x latents, ragged reference mels."""
    rng = np.random.default_rng(seed)
    tok, refs = np.array([9, 6, 7, 4], np.int32), (32, 20, 27, 16)
    token = np.zeros((4, 9), np.int32)
    feat = np.zeros((4, 18, 80), np.float32)
    ref = np.zeros((4, 32, 80), np.float32)
    for i, n in enumerate(tok):
        token[i, :n] = rng.integers(0, 6561, n)
        feat[i, :2 * n] = rng.standard_normal((2 * n, 80))
        ref[i, :refs[i]] = rng.standard_normal((refs[i], 80)) * 0.5
    return {"token": token, "token_len": tok, "feat": feat,
            "feat_len": 2 * tok, "reference_mel": ref,
            "reference_mel_len": np.array(refs, np.int32)}


@pytest.fixture(scope="module")
def flow_ref(flow):
    """Two global batches, their JAX keys, JAX's first-step gradients and
    the port's draws of each key for the global batch."""
    model, variables, pcfg = flow
    batches = [flow_batch4(seed) for seed in (1, 2)]
    keys = [jax.random.PRNGKey(7), jax.random.PRNGKey(8)]
    loss = j_steps.make_flow_loss_fn(model)
    grads = jax.jit(jax.grad(loss))(variables["params"], {
        k: jnp.asarray(v) for k, v in batches[0].items()}, keys[0])
    t_feat = batches[0]["feat"].shape[1]
    draws = [jax_flow_draws(k, pcfg.flow, 4, t_feat) for k in keys]
    return batches, keys, grads, draws


@pytest.mark.parametrize("dp,tp", [(2, 1), (1, 2)])
def test_flow_step_matches_jax_mesh(gang2, flow, flow_ref, dp, tp):
    """Two flow steps (contrastive FM and immiscible noise on) at dp x tp
    against JAX's on the same mesh, the port's ranks taking their rows of
    one JAX key's draws for the global batch. The conformer's key biases
    are zero by symmetry (tests/test_torch_flow_train.py)."""
    model, variables, pcfg = flow
    assert pcfg.flow.cfm.use_contrastive_fm and pcfg.flow.cfm.use_immiscible
    batches, keys, jgrads, draws = flow_ref
    jm, jparams = _jax_run(j_steps.make_flow_train_step(model),
                           variables["params"], batches, dp, tp, "flow",
                           keys)
    port = gang2.run("train_job", "flow", pcfg.flow, variables, batches, dp,
                     tp, OPT, draws)[0]
    _check(port, jm, jgrads, jparams, symmetric=(("linear_k", "bias"),))


def test_mean_of_rank_means_fails_the_limits(lm):
    """The control: on the ragged batch, each dp half's own mean loss and
    gradient, averaged over the halves, land outside the limits the
    distributed step meets against JAX's global-batch step."""
    model, variables, pcfg = lm
    batch = lm_batch(0)
    jloss = j_steps.make_lm_loss_fn(model)
    (loss, acc), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        variables["params"], {k: jnp.asarray(v) for k, v in batch.items()})
    port = t_io.load_flax_params(t_llm.SpeechLM(pcfg.lm), variables)
    paths = list(t_io._params_with_paths(port))
    halves = []
    for sl in (slice(0, 2), slice(2, 4)):
        out, a = t_steps.make_lm_loss_fn(port)(
            {k: torch.as_tensor(v[sl]) for k, v in batch.items()})
        g = torch.autograd.grad(out, [p for _, p, _, _ in paths])
        halves.append((float(out.detach()), [t.numpy() for t in g]))
    mean_loss = (halves[0][0] + halves[1][0]) / 2
    assert abs(mean_loss - float(loss)) > 1e-3 * abs(float(loss))
    theirs = t_io._flatten(grads)
    worst = 0.0
    for i, (path, _, _, to_flax) in enumerate(paths):
        g = to_flax((halves[0][1][i] + halves[1][1][i]) / 2)
        ref = np.asarray(theirs[path])
        if np.abs(ref).max() > 0:
            worst = max(worst, np.abs(g - ref).max() / np.abs(ref).max())
    assert worst > 1e-2, worst


def test_checkpoint_across_world_sizes(gang4, lm, tmp_path):
    """A checkpoint saved at (2, 2) restores at world size 1 with identical
    parameters and moments, and one saved at world size 1 restores at
    (2, 2) identically."""
    _, variables, pcfg = lm
    batch = lm_batch(0)
    d = tmp_path / "from_mesh"
    step, params, moments = gang4.run("checkpoint_job", pcfg.lm, variables,
                                      batch, str(d), 2, 2, True)[0]
    model = t_io.load_flax_params(t_llm.SpeechLM(pcfg.lm), variables)
    state = t_steps.make_train_state(
        model, t_sched.make_optimizer(lr=1e-3, warmup_steps=0))
    state, restored = CheckpointManager(str(d)).restore(state)
    assert restored == step == 1
    names = [path for path, _ in t_io.named_flax_params(model)]
    for name, p, mu, nu in zip(names, state.params(), state.opt_state.mu,
                               state.opt_state.nu):
        np.testing.assert_array_equal(p.detach().numpy(), params[name])
        np.testing.assert_array_equal(mu.numpy(), moments["mu"][name])
        np.testing.assert_array_equal(nu.numpy(), moments["nu"][name])
    # and back: world size 1 -> (2, 2)
    d1 = tmp_path / "from_one"
    CheckpointManager(str(d1)).save(5, state)
    step, params, moments = gang4.run("checkpoint_job", pcfg.lm, variables,
                                      batch, str(d1), 2, 2, False)[0]
    assert step == 5
    for name, p, mu in zip(names, state.params(), state.opt_state.mu):
        np.testing.assert_array_equal(params[name], p.detach().numpy())
        np.testing.assert_array_equal(moments["mu"][name], mu.numpy())


def test_agree_steps_and_uneven_join(gang2):
    """One rank short: both agree on the smaller count, and the join
    (rounds of 3) yields on each rank what both can match: 5 and 8 local
    batches give a round of 3 and one of 2; 7 and 6 give two rounds of
    3, and the third round ends the epoch."""
    (a0, j0), (a1, j1) = gang2.run("join_job", [5, 8])
    assert a0 == a1 == 5
    assert j0 == [0, 1, 2, 3, 4] and j1 == [0, 1, 2, 3, 4]
    (a0, j0), (a1, j1) = gang2.run("join_job", [7, 6])
    assert a0 == a1 == 6
    assert j0 == j1 == [0, 1, 2, 3, 4, 5]


def _launch(tmp_path, lst, out, *extra):
    """cli/launch.py --nproc 2 over gloo on the CPU, cli/train.py at the
    tiny config on `lst` in static batches of 2 padded to 64."""
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(REPO)}
    return subprocess.run(
        [sys.executable, "-m", "minimax_speech_torch.cli.launch",
         "--nproc", "2", "--max_restarts", "0", "--device", "cpu",
         "--log_dir", str(tmp_path / "logs"), "--",
         "--config", "configs/tiny.yaml", "--train_data", str(lst),
         "--model_dir", str(out), "--override", "train.batch_size=2",
         "--override", "train.pad_seq=64", "--override", "train.pad_ref=64",
         "--override", "train.log_interval=1", *extra],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)


def _exported_shapes_match_jax(path, kind: str):
    """The JAX package's load_params reads the export at `path` into the
    leaves, by shape, of the config's model of `kind`."""
    from minimax_speech_tpu import config as j_config
    tree = j_load(str(path))
    jcfg = j_config.load_tts_config(str(REPO / "configs/tiny.yaml"))
    if kind == "flow":
        model = j_flow.FlowModel(jcfg.flow)
        init = lambda k: j_flow.init_flow_variables(model, k)  # noqa: E731
    else:
        model = j_llm.SpeechLM(jcfg.lm)
        init = lambda k: j_llm.init_lm_variables(model, k)  # noqa: E731
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    want = {k: v.shape for k, v in t_io._flatten(shapes["params"]).items()}
    got = {k: np.asarray(v).shape
           for k, v in t_io._flatten(tree["params"]).items()}
    assert got == want


def test_cli_under_the_launcher(tmp_path, rng):
    """cli/launch.py --nproc 2 -- --device cpu --model llm --tp 2: one
    epoch, a second call that resumes at the saved step, and an
    --export_npz that the JAX package's load_params reads into a
    SpeechLM of the config."""
    lst = make_corpus(tmp_path, rng, n=6)
    out = tmp_path / "exp"
    common = ("--model", "llm", "--tp", "2", "--override",
              "train.save_per_step=2")
    r = _launch(tmp_path, lst, out, *common, "--max_epoch", "1")
    assert r.returncode == 0, r.stdout + r.stderr
    rows = (out / "llm_metrics.jsonl").read_text().splitlines()
    assert len(rows) >= 3  # 3 steps of 2 (6 items, tp peers share) + epoch
    steps_done = sorted(int(p.name) for p in (out / "ckpt").iterdir())
    r = _launch(tmp_path, lst, out, *common, "--max_epoch", "2",
                "--export_npz", str(tmp_path / "lm.npz"))
    assert r.returncode == 0, r.stdout + r.stderr
    log0 = (tmp_path / "logs" / "rank0.attempt0.log").read_text()
    assert f"resumed from step {steps_done[-1]}" in log0
    _exported_shapes_match_jax(tmp_path / "lm.npz", "llm")


@pytest.mark.parametrize("kind,args", [
    ("flow", ("--model", "flow", "--dp", "2")),
    ("dpo", ("--model", "llm", "--dpo", "--tp", "2"))])
def test_flow_and_dpo_cli_under_the_launcher(tmp_path, rng, kind, args):
    """The flow CLI at dp = 2 and the DPO CLI (rejected tokens beside
    every utterance) at tp = 2 under cli/launch.py --nproc 2: one epoch
    whose metrics rank 0 writes, and an --export_npz that the JAX
    package's load_params reads into the config's model."""
    lst = make_corpus(tmp_path, rng, n=6)
    if kind == "dpo":
        for i in range(6):
            n = len(np.load(tmp_path / f"utt{i}_fsq.npy"))
            np.save(tmp_path / f"utt{i}_fsq_reject.npy",
                    rng.integers(0, 6561, n + 3).astype(np.int32))
    out = tmp_path / "exp"
    r = _launch(tmp_path, lst, out, *args, "--max_epoch", "1",
                "--export_npz", str(tmp_path / "out.npz"))
    assert r.returncode == 0, r.stdout + r.stderr
    name = "flow" if kind == "flow" else "llm"
    rows = [json.loads(x) for x in
            (out / f"{name}_metrics.jsonl").read_text().splitlines()]
    key = "dpo/loss" if kind == "dpo" else "loss"
    assert any(np.isfinite(r.get(key, np.nan)) for r in rows), rows
    _exported_shapes_match_jax(tmp_path / "out.npz", name)
