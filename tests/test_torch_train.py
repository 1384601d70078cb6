"""Stage-1 LM training in the port against the JAX package, on the CPU.

Losses, schedules, the plan builder, Qwen2's training forward and its
gradients (against both JAX routes: the XLA causal+pad bias, and splash
in interpret mode), and the whole train step: same weights through the
bridge, same batch, AdamW + clip, compared after 3 steps. float32 on
both sides; each tolerance is stated where it is used.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minimax_speech_torch.models import llm as t_llm
from minimax_speech_torch.models import qwen2 as t_qwen2
from minimax_speech_torch.train import schedule as t_sched
from minimax_speech_torch.train import steps as t_steps
from minimax_speech_torch.utils import losses as t_losses
from minimax_speech_torch.utils import params_io as t_io
from minimax_speech_tpu.models import llm as j_llm
from minimax_speech_tpu.models import qwen2 as j_qwen2
from minimax_speech_tpu.train import schedule as j_sched
from minimax_speech_tpu.train import steps as j_steps
from minimax_speech_tpu.utils import losses as j_losses
from tests.test_torch_bridge import jitter, port_config, tiny_port_cfg
from tests import torch_cpu

torch_cpu.share_cores()


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("normalize", [True, False])
def test_losses_match_jax(rng, smoothing, normalize):
    logits = rng.standard_normal((3, 7, 11)).astype(np.float32) * 2
    target = rng.integers(0, 11, (3, 7)).astype(np.int32)
    target[0, 4:] = j_losses.IGNORE_ID
    target[2, :2] = j_losses.IGNORE_ID
    ref = j_losses.label_smoothing_ce(jnp.asarray(logits), jnp.asarray(target),
                                      smoothing, normalize)
    ours = t_losses.label_smoothing_ce(torch.as_tensor(logits),
                                       torch.as_tensor(target), smoothing,
                                       normalize)
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-6)
    acc_j = j_losses.accuracy(jnp.asarray(logits), jnp.asarray(target))
    acc_t = t_losses.accuracy(torch.as_tensor(logits), torch.as_tensor(target))
    assert float(acc_t) == pytest.approx(float(acc_j), abs=1e-7)


def _jax_schedule(name, lr, warmup, total):
    """The schedule JAX make_optimizer builds for `name`."""
    return {
        "constantlr": lambda: j_sched.warmup_constant(lr, warmup),
        "warmuplr": lambda: j_sched.warmup_lr(lr, warmup),
        "cosine": lambda: j_sched.cosine_annealing(lr, warmup, total),
        "square": lambda: j_sched.square_annealing(lr, warmup, total),
        "squareroot": lambda: j_sched.squareroot_annealing(lr, warmup,
                                                           total),
        "noam": lambda: j_sched.noam_annealing(lr, warmup),
        "noamhold": lambda: j_sched.noam_hold_annealing(
            lr, warmup, hold_steps=total // 10),
        "polynomial": lambda: j_sched.polynomial_decay(lr, warmup, total),
    }[name]()


@pytest.mark.parametrize("name", t_sched._SCHEDULES)
def test_schedules_match_jax(name):
    """Every scheduler name at steps 0, 1, warmup and 10*warmup, to 1e-6
    of the peak lr: JAX evaluates in float32 (lr*1e-3 + a ramp loses
    float32 bits to cancellation), the port in float64."""
    lr, warmup, total = 2e-3, 50, 5000
    ours = t_sched.make_schedule(lr, warmup, name, total)
    ref = _jax_schedule(name, lr, warmup, total)
    for step in (0, 1, warmup, 10 * warmup):
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-6,
                                   atol=1e-6 * lr, err_msg=f"{name} @ {step}")


@pytest.mark.parametrize("bistream", [False, True])
def test_lm_plan_identical(rng, bistream):
    texts = [rng.integers(1, 256, n) for n in (4, 9, 12)]
    speech = [rng.integers(0, 6561, n) for n in (70, 33, 200)]
    flags = [bistream, bistream, bistream]
    ref = j_llm.build_lm_plan(texts, speech, bistream_flags=flags, pad_to=256)
    ours = t_llm.build_lm_plan(texts, speech, bistream_flags=flags,
                               pad_to=256)
    assert ref.keys() == ours.keys()
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    if bistream:  # the fill token marks each full text chunk's end
        assert (ours["target"] == t_llm.LMConfig().fill_token).any()


QWEN = dict(vocab_size=50, hidden_size=128, n_layers=2, n_heads=2,
            n_kv_heads=1, head_dim=64, intermediate_size=96)


@pytest.mark.parametrize("route", ["xla", "splash"])
def test_qwen2_training_forward_and_grads(rng, route):
    """The port's training path (K2's plain version on the CPU) against
    each JAX route: hidden states at valid positions, and the gradients
    of a loss over them, for every parameter. atol 3e-5 / rtol 2e-3, as
    the JAX package holds its two routes against each other."""
    from minimax_speech_tpu.kernels import splash as j_splash

    b, t = 2, 128
    jcfg = j_qwen2.Qwen2Config(**QWEN, flash_train=route)
    model = j_qwen2.Qwen2Model(jcfg)
    x = rng.standard_normal((b, t, 128)).astype(np.float32) * 0.3
    lengths = np.array([t, 90], np.int32)
    positions = np.broadcast_to(np.arange(t)[None], (b, t))
    valid = (np.arange(t)[None] < lengths[:, None]).astype(np.float32)
    xla = j_qwen2.Qwen2Model(j_qwen2.Qwen2Config(**QWEN, flash_train="xla"))
    variables = jitter(xla.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                jnp.asarray(positions), None,
                                lengths=jnp.asarray(lengths)), seed=3)

    def jloss(p):
        out, _ = model.apply(p, jnp.asarray(x), jnp.asarray(positions), None,
                             lengths=jnp.asarray(lengths))
        v = jnp.asarray(valid)
        return jnp.sum(jnp.square(out) * v[..., None]) / jnp.sum(v), out

    j_splash._INTERPRET = route == "splash"
    try:
        (jl, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(variables)
    finally:
        j_splash._INTERPRET = False

    port = t_io.load_flax_params(
        t_qwen2.Qwen2Model(port_config(jcfg, t_qwen2.Qwen2Config)), variables)
    out = port(torch.as_tensor(x), torch.as_tensor(positions.copy()), None,
               lengths=torch.as_tensor(lengths))
    v = torch.as_tensor(valid)
    loss = (out.square() * v[..., None]).sum() / v.sum()
    grads = torch.autograd.grad(loss, list(port.parameters()))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=2e-5)
    for i, n in enumerate(lengths):
        np.testing.assert_allclose(out.detach().numpy()[i, :n],
                                   np.asarray(jout)[i, :n], atol=3e-5,
                                   rtol=2e-3)
    jflat = t_io._flatten(jgrad["params"])
    for (path, p, _, to_flax), g in zip(t_io._params_with_paths(port), grads):
        np.testing.assert_allclose(to_flax(g.numpy()), np.asarray(jflat[path]),
                                   atol=3e-5, rtol=2e-3,
                                   err_msg="/".join(path))


def _remat(lm_cfg, mode: str):
    """lm_cfg with remat off ("off") or on under policy `mode`."""
    import dataclasses
    return dataclasses.replace(lm_cfg, qwen=dataclasses.replace(
        lm_cfg.qwen, remat=mode != "off",
        remat_policy="dots" if mode == "off" else mode))


def _lm_grads(port, batch):
    """(loss, {flax path: gradient}) of the port's LM loss."""
    paths = list(t_io._params_with_paths(port))
    loss, _ = t_steps.make_lm_loss_fn(port)(_torch_batch(batch))
    grads = torch.autograd.grad(loss, [p for _, p, _, _ in paths],
                                allow_unused=True)
    return float(loss.detach()), {
        path: to_flax((torch.zeros_like(p) if g is None else g).numpy())
        for (path, p, _, to_flax), g in zip(paths, grads)}


@pytest.fixture(scope="module")
def remat_ref(lm_weights):
    """JAX's remat-off loss and gradients, and the port's remat-off
    gradients, on one batch."""
    model, variables, pcfg = lm_weights
    batch = _lm_batch(7)
    jloss = j_steps.make_lm_loss_fn(model)
    (loss, _), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        variables["params"], {k: jnp.asarray(v) for k, v in batch.items()})
    port = t_io.load_flax_params(t_llm.SpeechLM(pcfg.lm), variables)
    return batch, float(loss), t_io._flatten(grads), _lm_grads(port, batch)[1]


@pytest.mark.parametrize("mode", ["off", "none", "dots"])
def test_remat_matches_jax_and_remat_off(lm_weights, remat_ref, mode):
    """The LM loss under each remat mode against JAX's remat-off loss
    (1e-5 relative) and gradients (each leaf within 1e-4 of its largest
    element, as the flow step holds them), and its gradients against the
    port's remat-off ones within 1e-6 of each leaf's largest (the
    recompute repeats the same float32 arithmetic)."""
    _, variables, pcfg = lm_weights
    batch, jloss, jgrads, off = remat_ref
    port = t_io.load_flax_params(t_llm.SpeechLM(_remat(pcfg.lm, mode)),
                                 variables)
    loss, grads = _lm_grads(port, batch)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    assert grads.keys() == jgrads.keys() == off.keys()
    for path, g in grads.items():
        j = np.asarray(jgrads[path])
        name = "/".join(path)
        np.testing.assert_allclose(g, j, rtol=0, atol=1e-4 * np.abs(j).max(),
                                   err_msg=name)
        np.testing.assert_allclose(g, off[path], rtol=0,
                                   atol=1e-6 * np.abs(off[path]).max(),
                                   err_msg=name)


def test_remat_policy_typo_raises():
    """A misspelled policy fails loudly on the training path, as JAX's
    (tests/test_training.py), rather than running another policy."""
    model = t_qwen2.Qwen2Model(t_qwen2.Qwen2Config(
        **QWEN, remat=True, remat_policy="dot"))
    x = torch.zeros(1, 4, 128)
    with pytest.raises(ValueError, match="remat_policy"):
        model(x, torch.arange(4)[None], None, lengths=torch.tensor([4]))


def _qwen_inputs(rng, t=32):
    x = torch.as_tensor(rng.standard_normal((2, t, 128)).astype(np.float32))
    return x, torch.arange(t)[None].expand(2, t), torch.tensor([t, 20])


def test_dots_policy_keeps_the_seven_projections(rng, monkeypatch):
    """On the first pass the "dots" policy marks exactly the seven
    projection products of each layer MUST_SAVE (q, k, v with bias as
    addmm; o, gate, up, down as mm) and nothing else; the recompute
    (ctx.is_recompute) is left out of the count."""
    from collections import Counter

    from torch.utils.checkpoint import CheckpointPolicy

    decisions = Counter()

    def counting(ctx, op, *args, **kwargs):
        policy = dots(ctx, op, *args, **kwargs)
        if not ctx.is_recompute:
            decisions[str(op), policy == CheckpointPolicy.MUST_SAVE] += 1
        return policy

    dots = t_qwen2.dots_policy
    monkeypatch.setattr(t_qwen2, "dots_policy", counting)
    model = t_qwen2.Qwen2Model(t_qwen2.Qwen2Config(**QWEN, remat=True))
    x, pos, lengths = _qwen_inputs(rng)
    out = model(x, pos, None, lengths=lengths)
    torch.autograd.grad(out.square().sum(), list(model.parameters()))
    saved = {op: n for (op, keep), n in decisions.items() if keep}
    assert saved == {"aten.addmm.default": 3 * QWEN["n_layers"],
                     "aten.mm.default": 4 * QWEN["n_layers"]}
    assert sum(n for (_, keep), n in decisions.items() if not keep) > 0


def test_remat_saves_far_fewer_activation_bytes(rng):
    """The bytes autograd saves for the backward of the training forward,
    counted by saved_tensors_hooks: with remat, a checkpointed layer
    saves its input only as seen from outside (what selective
    checkpointing caches is not seen there), so both modes save under a
    quarter of remat-off's; "none" against "dots" is told apart by the
    policy count above and by peak memory on the card."""
    x, pos, lengths = _qwen_inputs(rng, t=64)
    saved = {}
    for mode in ("off", "none", "dots"):
        cfg = t_qwen2.Qwen2Config(**QWEN, remat=mode != "off",
                                  remat_policy="dots" if mode == "off"
                                  else mode)
        model = t_qwen2.Qwen2Model(cfg)
        n = [0]

        def pack(t, n=n):
            n[0] += t.numel() * t.element_size()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            model(x.requires_grad_(), pos, None, lengths=lengths)
        saved[mode] = n[0]
    assert saved["none"] < saved["off"] / 4, saved
    assert saved["dots"] < saved["off"] / 4, saved


def test_decode_with_a_cache_ignores_remat(rng, monkeypatch):
    """Prefill and a decode step through a cache run the plain layers
    under remat, grad on or not: no checkpoint call, outputs equal to the
    remat-off model's."""
    def refuse(*args, **kwargs):
        raise AssertionError("checkpoint called on the cache path")

    monkeypatch.setattr(t_qwen2, "checkpoint", refuse)
    x = torch.as_tensor(rng.standard_normal((1, 5, 128)).astype(np.float32))
    outs = {}
    for mode in ("off", "dots"):
        torch.manual_seed(0)
        cfg = t_qwen2.Qwen2Config(**QWEN, remat=mode != "off")
        model = t_qwen2.Qwen2Model(cfg)
        cache = t_qwen2.make_cache(cfg, 1, 16)
        pad = torch.ones(1, 5, dtype=torch.bool)
        bias = torch.cat([t_qwen2.causal_bias(pad),
                          torch.full((1, 1, 5, 11), -1e10)], dim=-1)
        h = model(x, torch.arange(5)[None], bias, cache, 0)
        valid = torch.zeros(1, 16, dtype=torch.bool)
        valid[:, :6] = True
        h1 = model(x[:, -1:], torch.tensor([[5]]), t_qwen2.cache_bias(valid),
                   cache, 5)
        outs[mode] = (h.detach(), h1.detach())
    for a, b in zip(outs["off"], outs["dots"]):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


# -- the train step ---------------------------------------------------------

def _lm_batch(seed, b=3, n_text=(5, 9, 7), n_speech=(40, 61, 25),
              pad_to=128):
    rng = np.random.default_rng(seed)
    plan = j_llm.build_lm_plan(
        [rng.integers(1, 256, n) for n in n_text[:b]],
        [rng.integers(0, 6561, n) for n in n_speech[:b]], pad_to=pad_to)
    mel_len = np.array([48, 31, 40][:b], np.int32)
    ref = np.zeros((b, 64, 80), np.float32)
    for i, n in enumerate(mel_len):
        ref[i, :n] = rng.standard_normal((n, 80)) * 0.5
    return {**plan, "reference_mel": ref, "reference_mel_len": mel_len}


@pytest.fixture(scope="module")
def lm_weights():
    jcfg, pcfg = tiny_port_cfg()
    model = j_llm.SpeechLM(jcfg.lm)
    init = jax.jit(j_llm.init_lm_variables, static_argnums=0)
    variables = jitter(init(model, jax.random.PRNGKey(2)), seed=2)
    return model, variables, pcfg


def _port_state(pcfg, variables, tx):
    port = t_io.load_flax_params(t_llm.SpeechLM(pcfg.lm), variables)
    return port, t_steps.make_train_state(port, tx)


def _torch_batch(batch):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}


def _run_both(lm_weights, batches, opt_kw, bf16=False):
    """(JAX metrics per step, JAX params, port metrics, port module)."""
    model, variables, pcfg = lm_weights
    jtx = j_sched.make_optimizer(**opt_kw)
    jstate = j_steps.make_train_state(variables["params"], jtx)
    jstep = jax.jit(j_steps.make_lm_train_step(model, bf16=bf16))
    port, tstate = _port_state(pcfg, variables, t_sched.make_optimizer(
        **opt_kw))
    tstep = t_steps.make_lm_train_step(port, bf16=bf16, device="cpu")
    jm, tm = [], []
    for batch in batches:
        jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in
                                   batch.items()})
        jm.append({k: float(v) for k, v in m.items()})
        tstate, m = tstep(tstate, _torch_batch(batch))
        tm.append({k: float(v) for k, v in m.items()})
    return jm, jstate.params, tm, port


def _assert_params_close(port, jparams, lr, updates):
    """Every parameter after the steps. Adam moves a weight by about lr
    per update whatever the gradient's size, so where a gradient is ~0
    by symmetry (a key bias under softmax) its sign, and the update, rest
    on rounding: every element within 5% of lr * updates, and all but
    0.1% of the elements within 1e-6 (float32 through 2 layers)."""
    theirs = t_io._flatten(jparams)
    ours = t_io._flatten(t_io.to_flax_params(port)["params"])
    assert ours.keys() == theirs.keys()
    diffs = []
    for path in ours:
        d = np.abs(ours[path] - np.asarray(theirs[path]))
        assert d.max() <= 0.05 * lr * updates, ("/".join(path), d.max())
        diffs.append(d.ravel())
    diffs = np.concatenate(diffs)
    assert np.mean(diffs > 1e-6) <= 1e-3, np.quantile(diffs, [0.99, 0.999])


def test_lm_train_step_matches_jax(lm_weights):
    """3 steps of make_lm_train_step with lr 1e-3, warmup 2 and clip 0.5
    (the clip triggers: grad_norm > 0.5 at every step). Metrics to 1e-4
    relative (float32 through 2 layers, other summation orders); every
    parameter as _assert_params_close states."""
    batches = [_lm_batch(s) for s in (0, 1, 2)]
    jm, jparams, tm, port = _run_both(
        lm_weights, batches, dict(lr=1e-3, warmup_steps=2, grad_clip=0.5))
    for j, t in zip(jm, tm):
        assert j["grad_norm"] > 0.5
        assert j.keys() == t.keys()
        for k in j:
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4, atol=1e-6,
                                       err_msg=k)
    _assert_params_close(port, jparams, lr=1e-3, updates=3)


def test_accumulation_matches_optax_multisteps(lm_weights):
    """accum_steps=2 against optax.MultiSteps over 4 micro-steps (2
    updates); same tolerances as the plain step."""
    batches = [_lm_batch(s) for s in (3, 4, 5, 6)]
    jm, jparams, tm, port = _run_both(
        lm_weights, batches,
        dict(lr=1e-3, warmup_steps=1, grad_clip=0.5, accum_steps=2))
    for j, t in zip(jm, tm):
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-4)
    _assert_params_close(port, jparams, lr=1e-3, updates=2)


def test_lm_train_step_bf16(lm_weights):
    """bf16=True: the loss of each step within 2e-2 relative of JAX's
    bf16 step (bf16 rounds at other places in the two frameworks), and
    the float32 master weights stay float32."""
    batches = [_lm_batch(s) for s in (0, 1)]
    jm, _, tm, port = _run_both(lm_weights, batches,
                                dict(lr=1e-3, warmup_steps=2), bf16=True)
    for j, t in zip(jm, tm):
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=2e-2)
        assert np.isfinite(t["grad_norm"])
    assert all(p.dtype == torch.float32 for p in port.parameters())


def test_multicrop_speaker_and_xvector_match_jax(lm_weights, rng):
    model, variables, pcfg = lm_weights
    port = t_io.load_flax_params(t_llm.SpeechLM(pcfg.lm), variables)
    mel = rng.standard_normal((2, 3, 40, 80)).astype(np.float32)
    mask = np.arange(40)[None, None] < np.array([[40, 22, 31],
                                                 [17, 40, 25]])[..., None]
    xv = rng.standard_normal((2, 12)).astype(np.float32)
    ref = model.apply(variables, jnp.asarray(mel), jnp.asarray(mask),
                      method=j_llm.SpeechLM.embed_speaker)
    ref_x = model.apply(variables, jnp.asarray(xv),
                        method=j_llm.SpeechLM.project_xvector)
    with torch.no_grad():
        ours = port.embed_speaker(torch.as_tensor(mel), torch.as_tensor(mask))
        ours_x = port.project_xvector(torch.as_tensor(xv))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(ours_x.numpy(), np.asarray(ref_x), atol=1e-6)


def test_train_step_refuses_wrong_device(lm_weights):
    _, variables, pcfg = lm_weights
    port = t_io.load_flax_params(t_llm.SpeechLM(pcfg.lm), variables)
    with pytest.raises((RuntimeError, ValueError)):
        t_steps.make_lm_train_step(port)  # default cuda: no GPU, or not on it


def test_speaker_encoder_grads_match_jax(lm_weights, rng):
    """The speaker encoder trains jointly with the LM: the gradients of a
    loss on the projected embedding (masked reference mels) match JAX's
    for every speaker-encoder and projection parameter (atol 1e-6 /
    rtol 1e-4, float32)."""
    model, variables, pcfg = lm_weights
    port = t_io.load_flax_params(t_llm.SpeechLM(pcfg.lm), variables)
    mel = rng.standard_normal((3, 40, 80)).astype(np.float32)
    mask = np.arange(40)[None] < np.array([40, 22, 31])[:, None]
    w = rng.standard_normal((3, 32)).astype(np.float32)

    def jloss(params):
        e = model.apply({"params": params}, jnp.asarray(mel),
                        jnp.asarray(mask), method=j_llm.SpeechLM.embed_speaker)
        return jnp.sum(e * jnp.asarray(w))

    jgrad = t_io._flatten(jax.grad(jloss)(variables["params"]))
    e = port.embed_speaker(torch.as_tensor(mel), torch.as_tensor(mask))
    named = [(path, p, to_flax) for path, p, _, to_flax
             in t_io._params_with_paths(port)
             if path[0] in ("speaker_encoder", "spk_embed_affine_layer")]
    grads = torch.autograd.grad((e * torch.as_tensor(w)).sum(),
                                [p for _, p, _ in named])
    assert len(named) > 10
    for (path, _, to_flax), g in zip(named, grads):
        np.testing.assert_allclose(to_flax(g.numpy()), np.asarray(jgrad[path]),
                                   atol=1e-6, rtol=1e-4,
                                   err_msg="/".join(path))
