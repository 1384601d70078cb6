"""DPO fine-tuning of the Stage-1 LM in the port against the JAX package,
on the CPU.

dpo_loss in its three forms, SpeechLM.sequence_logp against both JAX
training routes (the XLA causal+pad bias, and splash in interpret mode),
one make_dpo_step (loss, rewards, accuracy, every leaf's gradient and
the parameters after one AdamW step), the loss at a reference equal to
the policy, and the DPO data: the reject sidecar and padding_llm's dpo
branch. float32 on both sides; each tolerance is stated where it is
used.
"""
import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minimax_speech_torch.data import pipeline as t_dp
from minimax_speech_torch.models import llm as t_llm
from minimax_speech_torch.train import gan_steps as t_gan
from minimax_speech_torch.train import schedule as t_sched
from minimax_speech_torch.train import steps as t_steps
from minimax_speech_torch.utils import losses as t_losses
from minimax_speech_torch.utils import params_io as t_io
from minimax_speech_tpu.data import pipeline as j_dp
from minimax_speech_tpu.models import llm as j_llm
from minimax_speech_tpu.train import gan_steps as j_gan
from minimax_speech_tpu.train import schedule as j_sched
from minimax_speech_tpu.train import steps as j_steps
from minimax_speech_tpu.utils import losses as j_losses
from tests.test_torch_bridge import jitter, port_config, tiny_port_cfg
from tests import torch_cpu

torch_cpu.share_cores()

PLAN = ("src_type", "tok_id", "target", "seq_len")
LR = 1e-3


@pytest.mark.parametrize("form", [dict(), dict(label_smoothing=0.1),
                                  dict(ipo=True)],
                         ids=["sigmoid", "smoothed", "ipo"])
def test_dpo_loss_matches_jax(rng, form):
    """Loss and both rewards to 1e-6 relative, at beta 0.1 over log-probs
    of a few hundred nats."""
    logps = [(rng.standard_normal(5) * 30 - 300).astype(np.float32)
             for _ in range(4)]
    ref = j_losses.dpo_loss(*map(jnp.asarray, logps), 0.1, **form)
    ours = t_losses.dpo_loss(*map(torch.as_tensor, logps), 0.1, **form)
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-6)


def _plans(rng, n_text, n_speech, pad_to, cfg):
    return j_llm.build_lm_plan(
        [rng.integers(1, cfg.qwen.vocab_size, n) for n in n_text],
        [rng.integers(0, cfg.speech_token_size, n) for n in n_speech],
        bistream_flags=[False, True, False][:len(n_text)], pad_to=pad_to,
        eos=cfg.eos_token, fill=cfg.fill_token)


@pytest.mark.parametrize("route", ["xla", "splash"])
def test_sequence_logp_matches_jax(rng, route):
    """Each plan's summed target log-prob (a few hundred nats) within
    1e-5 relative of JAX's, at T = 128 (splash needs T % 128 == 0 and
    head_dim 64)."""
    from minimax_speech_tpu.kernels import splash as j_splash

    jcfg, _ = tiny_port_cfg()
    lm = jcfg.lm
    qwen = dataclasses.replace(lm.qwen, hidden_size=128, n_heads=2,
                               n_kv_heads=1, head_dim=64, flash_train=route)
    lm = dataclasses.replace(lm, llm_input_size=128, llm_output_size=128,
                             qwen=qwen)
    model = j_llm.SpeechLM(lm)
    init = jax.jit(j_llm.init_lm_variables, static_argnums=0)
    variables = jitter(init(model, jax.random.PRNGKey(1)), seed=1)
    plan = _plans(rng, (6, 9, 4), (70, 41, 90), 128, lm)
    spk = rng.standard_normal((3, 128)).astype(np.float32) * 0.3
    j_splash._INTERPRET = route == "splash"
    try:
        ref = model.apply(variables, *(jnp.asarray(plan[k]) for k in PLAN),
                          jnp.asarray(spk), method=j_llm.SpeechLM.sequence_logp)
    finally:
        j_splash._INTERPRET = False
    port = t_io.load_flax_params(
        t_llm.SpeechLM(port_config(lm, t_llm.LMConfig)), variables)
    with torch.no_grad():
        ours = port.sequence_logp(*(torch.as_tensor(plan[k]) for k in PLAN),
                                  torch.as_tensor(spk))
    assert np.all(np.asarray(ref) < -50)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5)


@pytest.fixture(scope="module")
def dpo_weights():
    """The tiny LM's jittered weights (the policy), a second jitter of
    them (the reference), and the configs."""
    jcfg, pcfg = tiny_port_cfg()
    model = j_llm.SpeechLM(jcfg.lm)
    init = jax.jit(j_llm.init_lm_variables, static_argnums=0)
    policy = jitter(init(model, jax.random.PRNGKey(4)), seed=4)
    return model, policy, jitter(policy, seed=5), pcfg


def dpo_batch(cfg, seed: int = 0):
    """3 chosen and 3 rejected plans (rejected speech of other lengths,
    one longer than its chosen) at one pad, and ragged reference mels."""
    rng = np.random.default_rng(seed)
    text = [rng.integers(1, cfg.qwen.vocab_size, n) for n in (5, 9, 7)]
    out = {}
    for sfx, n_speech in (("", (40, 61, 25)), ("_rej", (33, 70, 18))):
        plan = j_llm.build_lm_plan(
            text, [rng.integers(0, cfg.speech_token_size, n)
                   for n in n_speech], bistream_flags=[False, True, False],
            pad_to=128, eos=cfg.eos_token, fill=cfg.fill_token)
        out.update({k + sfx: v for k, v in plan.items()})
    mel_len = np.array([48, 31, 40], np.int32)
    ref = np.zeros((3, 64, 80), np.float32)
    for i, n in enumerate(mel_len):
        ref[i, :n] = rng.standard_normal((n, 80)) * 0.5
    return {**out, "reference_mel": ref, "reference_mel_len": mel_len}


def _port_pair(pcfg, policy, reference):
    port = t_io.load_flax_params(t_llm.SpeechLM(pcfg.lm), policy)
    ref = t_io.load_flax_params(t_llm.SpeechLM(pcfg.lm), reference)
    return port, ref


def _jax_dpo_loss(model, ref_params, batch):
    """JAX's DPO loss of the policy's params, from its public pieces."""
    mask = (jnp.arange(batch["reference_mel"].shape[1])[None]
            < batch["reference_mel_len"][:, None])

    def logps(params):
        spk = model.apply({"params": params}, batch["reference_mel"], mask,
                          method=j_llm.SpeechLM.embed_speaker)
        return [model.apply({"params": params},
                            *(batch[k + sfx] for k in PLAN), spk,
                            method=j_llm.SpeechLM.sequence_logp)
                for sfx in ("", "_rej")]

    ref_c, ref_r = logps(ref_params)
    return lambda params: j_losses.dpo_loss(*logps(params), ref_c, ref_r)[0]


def test_dpo_step_matches_jax(dpo_weights):
    """One make_dpo_step (AdamW lr 1e-3, no warm-up, clip 1.0) on both
    sides: the four metrics within 1e-5 relative (rewards with atol 1e-7:
    beta times differences of float32 sums of ~-800 nats); the first
    gradient of every leaf within 1e-4 of its largest element of JAX's
    jax.grad; every parameter after the step within 1e-6 of JAX's where
    that check pins the gradient (|g| >= 1e-4 of its leaf's largest),
    the rest within 2 lr (Adam's first update is lr * g / (|g| + eps),
    so near g = 0 its size rests on rounding)."""
    model, policy, reference, pcfg = dpo_weights
    batch = dpo_batch(pcfg.lm)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jgrads = t_io._flatten(jax.jit(jax.grad(_jax_dpo_loss(
        model, reference["params"], jbatch)))(policy["params"]))
    opt = dict(lr=LR, warmup_steps=0, grad_clip=1.0)
    jstate = j_steps.make_train_state(policy["params"],
                                      j_sched.make_optimizer(**opt))
    jstate, jm = jax.jit(j_gan.make_dpo_step(model, reference["params"]))(
        jstate, jbatch)

    port, ref = _port_pair(pcfg, policy, reference)
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    with torch.no_grad():
        ref_c, ref_r = t_gan._seq_logps(ref, tbatch)
    paths = list(t_io._params_with_paths(port))
    loss = t_losses.dpo_loss(*t_gan._seq_logps(port, tbatch), ref_c,
                             ref_r)[0]
    grads = torch.autograd.grad(loss, [p for _, p, _, _ in paths],
                                allow_unused=True)
    grads = {path: to_flax((torch.zeros_like(p) if g is None else g)
                           .detach().numpy())
             for (path, p, _, to_flax), g in zip(paths, grads)}
    assert grads.keys() == jgrads.keys()
    for path, g in grads.items():
        j = np.asarray(jgrads[path])
        np.testing.assert_allclose(g, j, rtol=0, atol=1e-4 * np.abs(j).max(),
                                   err_msg="/".join(path))

    state = t_steps.make_train_state(port, t_sched.make_optimizer(**opt))
    state, tm = t_gan.make_dpo_step(port, ref, device="cpu")(state, tbatch)
    assert state.step == 1
    assert tm.keys() == jm.keys() == {"dpo/loss", "dpo/chosen_reward",
                                      "dpo/rejected_reward", "dpo/reward_acc"}
    assert abs(float(jm["dpo/chosen_reward"])) > 1e-3  # the policies differ
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    theirs = t_io._flatten(jstate.params)
    ours = t_io._flatten(t_io.to_flax_params(port)["params"])
    for path, g in grads.items():
        g = np.abs(g)
        pinned = g >= 1e-4 * g.max()
        d = np.abs(ours[path] - np.asarray(theirs[path]))
        assert (d[pinned] <= 1e-6).all(), ("/".join(path), d[pinned].max())
        assert (d <= 2 * LR).all(), "/".join(path)
    assert all(not p.requires_grad for p in ref.parameters())


def test_dpo_loss_is_log2_at_the_reference(dpo_weights):
    """With the reference equal to the policy, the sigmoid loss is
    -log sigmoid(0) = log 2 (1e-6 relative), both rewards 0, no pair
    ranked right; the policy still moves (its gradient is not 0)."""
    _, policy, _, pcfg = dpo_weights
    port, ref = _port_pair(pcfg, policy, policy)
    before = [p.detach().clone() for p in port.parameters()]
    state = t_steps.make_train_state(port, t_sched.make_optimizer(
        lr=LR, warmup_steps=0))
    batch = {k: torch.as_tensor(v) for k, v in dpo_batch(pcfg.lm, 1).items()}
    state, m = t_gan.make_dpo_step(port, ref, device="cpu")(state, batch)
    np.testing.assert_allclose(float(m["dpo/loss"]), np.log(2), rtol=1e-6)
    assert float(m["dpo/chosen_reward"]) == float(
        m["dpo/rejected_reward"]) == float(m["dpo/reward_acc"]) == 0.0
    assert any(not torch.equal(a, b) for a, b in
               zip(before, port.parameters()))


def test_dpo_step_refuses_wrong_device(dpo_weights):
    _, policy, reference, pcfg = dpo_weights
    port, ref = _port_pair(pcfg, policy, reference)
    with pytest.raises((RuntimeError, ValueError)):
        t_gan.make_dpo_step(port, ref)  # default cuda: no GPU, or not on it


def _samples(rng):
    """4 samples: one without a reject, one whose reject is longer than
    its chosen tokens."""
    out = []
    for i, (n_text, n_sp, n_rej) in enumerate(
            [(5, 40, 33), (9, 61, None), (7, 25, 90), (4, 50, 12)]):
        s = {"text_token": rng.integers(1, 256, n_text).astype(np.int32),
             "speech_token": rng.integers(0, 6561, n_sp).astype(np.int32),
             "reference_mels": [rng.standard_normal(
                 (20 + 7 * i, 80)).astype(np.float32)]}
        if n_rej is not None:
            s["reject_speech_token"] = rng.integers(
                0, 6561, n_rej).astype(np.int32)
        out.append(s)
    return out


def test_padding_llm_dpo_matches_jax(rng, caplog):
    """padding_llm(dpo=True) on one batch: the sample without a reject
    dropped with a warning, the bucket sized by the longer reject, every
    array (chosen and _rej plans, reference mels) identical to JAX's
    under one random.seed (the bistream flags are drawn alike)."""
    batch = _samples(rng)
    out = {}
    for name, dp in (("jax", j_dp), ("port", t_dp)):
        random.seed(3)
        out[name] = list(dp.padding_llm(
            [[dict(s) for s in batch]], bistream_prob=0.5, dpo=True))
    assert "dropping 1/4" in caplog.text
    (ours,), (ref,) = out["port"], out["jax"]
    assert ours.keys() == ref.keys()
    assert {k + "_rej" for k in PLAN} <= ours.keys()
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    assert ours["src_type"].shape == (3, 128)  # the 90-token reject's bucket
    assert int(ours["seq_len_rej"].max()) > 64 > int(ours["seq_len"].max())


def test_reject_sidecar_matches_jax(tmp_path, rng):
    """The opener attaches <stem>_fsq_reject.npy as reject_speech_token
    as JAX's does, and leaves it out where the file is missing."""
    from tests.test_train_cli import make_corpus

    lst = make_corpus(tmp_path, rng, n=3)
    wavs = lst.read_text().splitlines()
    np.save(wavs[0][:-4] + "_fsq_reject.npy",
            rng.integers(0, 6561, 17).astype(np.int64))
    np.save(wavs[2][:-4] + "_fsq_reject.npy",
            rng.integers(0, 6561, 44).astype(np.int32))
    items = [{"src": w} for w in wavs]
    ours = list(t_dp.individual_file_opener([dict(i) for i in items]))
    ref = list(j_dp.individual_file_opener([dict(i) for i in items]))
    assert [("reject_speech_token" in s) for s in ours] == [
        ("reject_speech_token" in s) for s in ref] == [True, False, True]
    for o, r in zip(ours, ref):
        for k in ("speech_token", "reject_speech_token"):
            if k in r:
                assert o[k].dtype == np.int32
                np.testing.assert_array_equal(o[k], r[k])
