"""Stage-2 flow training in the port against the JAX package, on the CPU.

The tiny geometry of tests/test_pipeline.py, weights jittered and loaded
by both packages, float32 on both sides. Every case feeds the port the
draws of one JAX key, rebuilt as JAX splits it (FlowModel: k_on, k_idx,
k_cfm; compute_loss: k_t, k_noise, k_cfg, k_perm), never a seed.

On the CPU the port's UNet under grad attends through K2's plain
version, whose pad query rows see pad keys where the JAX UNet's see
valid ones; no loss or gradient reads a pad row, so losses, gradients
and parameters are compared, never velocities at pad rows. Tolerances
(float32 sums in other orders through both stacks): losses 1e-5
relative; each leaf's gradient within 1e-4 of its largest element;
parameters after one AdamW step within 1e-6 where the gradient is
pinned; grad norms 1e-4 relative. Each test states its exceptions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minimax_speech_torch.data import pipeline as t_dp
from minimax_speech_torch.models import cfm as t_cfm
from minimax_speech_torch.models import decoder_unet as t_unet
from minimax_speech_torch.models import flow as t_flow
from minimax_speech_torch.train import schedule as t_sched
from minimax_speech_torch.train import steps as t_steps
from minimax_speech_torch.utils import params_io as t_io
from minimax_speech_tpu.data import pipeline as j_dp
from minimax_speech_tpu.models import cfm as j_cfm
from minimax_speech_tpu.models import flow as j_flow
from minimax_speech_tpu.train import schedule as j_sched
from minimax_speech_tpu.train import steps as j_steps
from tests.test_torch_bridge import jitter, tiny_port_cfg
from tests import torch_cpu

torch_cpu.share_cores()

TOK_LENS = np.array([9, 6, 7], np.int32)
REF_LENS = np.array([32, 20, 27], np.int32)
LR = 1e-3


@pytest.fixture(scope="module")
def flow():
    jcfg, pcfg = tiny_port_cfg()
    model = j_flow.FlowModel(jcfg.flow)
    init = jax.jit(j_flow.init_flow_variables, static_argnums=0)
    variables = jitter(init(model, jax.random.PRNGKey(2)), seed=2)
    return model, variables, pcfg.flow


def _port(pcfg, variables):
    return t_io.load_flax_params(t_flow.FlowModel(pcfg), variables)


def jax_cfm_draws(key, cfg, b, t, d) -> t_cfm.CFMDraws:
    """The numbers JAX's compute_loss draws from `key`."""
    k_t, k_noise, k_cfg, k_perm = jax.random.split(key, 4)
    k = cfg.immiscible_k if cfg.use_immiscible else 1
    return t_cfm.CFMDraws(
        t=torch.as_tensor(np.array(
            jax.random.uniform(k_t, (b, 1, 1))).reshape(b)),
        cand=torch.as_tensor(np.array(
            jax.random.normal(k_noise, (b, k, t, d)))),
        keep=torch.as_tensor(np.array(
            jax.random.uniform(k_cfg, (b,)) > cfg.training_cfg_rate
        ).astype(np.float32)),
        perm=torch.as_tensor(np.array(jax.random.permutation(k_perm, b))))


def jax_flow_draws(key, cfg, b, t_feat) -> t_flow.FlowDraws:
    """The numbers JAX's FlowModel.__call__ draws from `key`."""
    k_on, k_idx, k_cfm = jax.random.split(key, 3)
    return t_flow.FlowDraws(
        use_cond=torch.as_tensor(np.array(
            jax.random.bernoulli(k_on, 0.5, (b,)))),
        frac=torch.as_tensor(np.array(jax.random.uniform(k_idx, (b,)))),
        cfm=jax_cfm_draws(k_cfm, cfg.cfm, b, t_feat, cfg.output_size))


def flow_batch(seed=0, tok_lens=TOK_LENS):
    """A padding_flow-shaped batch: ragged tokens, their 2x latents (zero
    past feat_len) and ragged reference mels."""
    rng = np.random.default_rng(seed)
    b, t = len(tok_lens), int(tok_lens.max())
    token = np.zeros((b, t), np.int32)
    feat = np.zeros((b, 2 * t, 80), np.float32)
    ref = np.zeros((b, int(REF_LENS.max()), 80), np.float32)
    for i, n in enumerate(tok_lens):
        token[i, :n] = rng.integers(0, 6561, n)
        feat[i, :2 * n] = rng.standard_normal((2 * n, 80))
        ref[i, :REF_LENS[i]] = rng.standard_normal((REF_LENS[i], 80)) * 0.5
    return {"token": token, "token_len": tok_lens.copy(), "feat": feat,
            "feat_len": 2 * tok_lens, "reference_mel": ref,
            "reference_mel_len": REF_LENS.copy()}


def _torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _zero_by_symmetry(path) -> bool:
    """The conformer's key biases: a key bias adds one constant to every
    score of a query row, which softmax ignores, so their gradient is 0
    and both sides hold rounding only."""
    return path[-2:] == ("linear_k", "bias")


def _assert_grads_close(port, grads, jgrads):
    """Each leaf within 1e-4 of its largest element (JAX's side); a leaf
    that is zero by symmetry within 1e-8 of the model's largest element
    on both sides; the frozen speaker encoder's exactly 0 on both."""
    theirs = t_io._flatten(jgrads)
    top = max(float(np.abs(np.asarray(g)).max()) for g in theirs.values())
    n = 0
    for (path, _, _, to_flax), g in zip(t_io._params_with_paths(port), grads):
        ref = np.asarray(theirs[path])
        ours = to_flax(g.numpy())
        err = float(np.abs(ours - ref).max())
        if path[0] == "speaker_encoder":
            assert not ours.any() and not ref.any(), "/".join(path)
        elif _zero_by_symmetry(path):
            assert max(np.abs(ours).max(), np.abs(ref).max()) <= 1e-8 * top
        else:
            assert err <= 1e-4 * float(np.abs(ref).max()), ("/".join(path),
                                                            err)
            n += 1
    assert n > 20


@pytest.mark.parametrize("b", [1, 2, 5])
def test_immiscible_noise_and_derangement_identical(b):
    """On JAX's candidates and permutation: the chosen noise and the
    derangement are identical (b = 1 keeps its self-pair)."""
    key = jax.random.PRNGKey(b)
    x1 = np.array(jax.random.normal(jax.random.PRNGKey(100 + b),
                                    (b, 11, 80)))
    draws = jax_cfm_draws(key, j_cfm.CFMConfig(), b, 11, 80)
    _, k_noise, _, k_perm = jax.random.split(key, 4)
    ref = j_cfm.immiscible_noise(k_noise, jnp.asarray(x1), 8)
    ours = t_cfm.immiscible_noise(torch.as_tensor(x1), draws.cand)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(t_cfm.derangement(draws.perm).numpy(),
                                  np.asarray(j_cfm.derangement(k_perm, b)))


@pytest.mark.parametrize("streaming", [False, True])
def test_compute_loss_matches_jax(flow, streaming):
    """compute_loss through the tiny UNet, contrastive, immiscible, CFG
    dropout on, within 1e-5 relative."""
    model, variables, pcfg = flow
    port = _port(pcfg, variables)
    rng = np.random.default_rng(3)
    b, t = 3, 20
    x1, mu, cond = (rng.standard_normal((b, t, 80)).astype(np.float32)
                    for _ in range(3))
    mask = (np.arange(t)[None] < np.array([[20], [13], [17]])
            ).astype(np.float32)
    spks = rng.standard_normal((b, 80)).astype(np.float32)
    key = jax.random.PRNGKey(7)

    def est(_, *a):
        return model.apply(variables, *a, method=j_flow.FlowModel.estimate)

    ref, _ = j_cfm.compute_loss(est, None, key, *map(
        jnp.asarray, (x1, mask, mu, spks, cond)), model.cfg.cfm,
        streaming=streaming)
    draws = jax_cfm_draws(key, pcfg.cfm, b, t, 80)
    assert float(draws.keep.sum()) < b  # a sample is dropped
    ours = t_cfm.compute_loss(port.estimate, *map(torch.as_tensor, (
        x1, mask, mu, spks, cond)), pcfg.cfm, draws, streaming=streaming)
    np.testing.assert_allclose(float(ours.detach()), float(ref), rtol=1e-5)


@pytest.mark.parametrize("streaming", [False, True])
def test_flow_loss_and_grads_match_jax(flow, streaming):
    """FlowModel's loss (the speaker embedding from reference mels,
    frozen) within 1e-5 relative, every leaf's gradient as
    _assert_grads_close states."""
    model, variables, pcfg = flow
    port = _port(pcfg, variables)
    batch = flow_batch()
    key = jax.random.PRNGKey(1)  # prefixes on 1 of 3, CFG drops 1 of 3

    def jloss(params):
        emb = model.apply({"params": params}, jnp.asarray(
            batch["reference_mel"]), jnp.arange(32)[None]
            < jnp.asarray(batch["reference_mel_len"])[:, None],
            method=j_flow.FlowModel.embed_speaker)
        return model.apply({"params": params}, *(jnp.asarray(batch[k]) for k
                           in ("token", "token_len", "feat", "feat_len")),
                           jax.lax.stop_gradient(emb), key,
                           streaming=streaming)

    ref, jgrads = jax.jit(jax.value_and_grad(jloss))(variables["params"])
    draws = jax_flow_draws(key, pcfg, 3, 18)
    assert int(draws.use_cond.sum()) == 1 and float(draws.cfm.keep.sum()) == 2
    loss = t_steps.make_flow_loss_fn(port)(_torch(batch), draws,
                                           streaming=streaming)
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-5)
    grads = torch.autograd.grad(
        loss, [p for _, p in t_io.named_flax_params(port)],
        allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for (_, p), g in zip(t_io.named_flax_params(port), grads)]
    _assert_grads_close(port, grads, jgrads)


def test_flow_train_step_matches_jax(flow):
    """One make_flow_train_step with AdamW (lr 1e-3, no warm-up, clip
    1.0): loss, grad_norm and grad_norm/{encoder,estimator} within 1e-4
    relative; the frozen speaker encoder unchanged; every other parameter
    within 1e-6 of JAX's where the gradient check pins its gradient
    (|g| >= 1e-4 of its leaf's largest). Adam's first update is
    lr * g / (|g| + eps), so where |g| is that close to 0 its size rests
    on rounding; those elements (0.2% here) are held within 2 lr."""
    model, variables, pcfg = flow
    batch = flow_batch(seed=1)
    key = jax.random.PRNGKey(7)  # prefixes on 1 of 3, CFG drops 1 of 3
    opt = dict(lr=LR, warmup_steps=0, grad_clip=1.0)
    jstate = j_steps.make_train_state(variables["params"],
                                      j_sched.make_optimizer(**opt))
    jstate, jm = jax.jit(j_steps.make_flow_train_step(model))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    port = _port(pcfg, variables)
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    draws = jax_flow_draws(key, pcfg, 3, 18)
    paths = list(t_io._params_with_paths(port))
    grads = torch.autograd.grad(
        t_steps.make_flow_loss_fn(port)(_torch(batch), draws),
        [p for _, p, _, _ in paths], allow_unused=True)
    grads = {path: np.abs(to_flax((torch.zeros_like(p) if g is None else g)
                                  .detach().numpy()))
             for (path, p, _, to_flax), g in zip(paths, grads)}
    state = t_steps.make_train_state(port, t_sched.make_optimizer(**opt))
    state, tm = t_steps.make_flow_train_step(port, device="cpu")(
        state, _torch(batch), draws)
    assert state.step == 1
    assert tm.keys() == jm.keys() == {"loss", "grad_norm",
                                      "grad_norm/encoder",
                                      "grad_norm/estimator"}
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   err_msg=k)
    theirs = t_io._flatten(jstate.params)
    ours = t_io._flatten(t_io.to_flax_params(port)["params"])
    assert ours.keys() == theirs.keys()
    n_loose = n_all = 0
    for path in ours:
        g = grads[path]
        pinned = g >= 1e-4 * g.max()
        if _zero_by_symmetry(path):
            pinned[...] = False
        d = np.abs(ours[path] - np.asarray(theirs[path]))
        assert (d[pinned] <= 1e-6).all(), ("/".join(path), d[pinned].max())
        assert (d <= 2 * LR).all(), "/".join(path)
        n_loose += int((~pinned & (g > 0)).sum())
        n_all += g.size
    assert n_loose <= 5e-3 * n_all, n_loose
    for n, p in port.named_parameters():
        if n.startswith("speaker_encoder."):
            torch.testing.assert_close(p.detach(), before[n], atol=0, rtol=0)


def test_flow_train_step_bf16_finite(flow):
    """bf16=True: a streaming and a non-streaming step give finite metrics
    and leave float32 masters."""
    _, variables, pcfg = flow
    port = _port(pcfg, variables)
    state = t_steps.make_train_state(port, t_sched.make_optimizer(lr=LR))
    batch = _torch(flow_batch(seed=2))
    for streaming in (False, True):
        step = t_steps.make_flow_train_step(port, bf16=True, device="cpu",
                                            streaming=streaming)
        draws = t_flow.make_flow_draws(pcfg, 3, 18,
                                       torch.Generator().manual_seed(0))
        state, m = step(state, batch, draws)
        assert all(np.isfinite(float(v)) for v in m.values()), m
    assert all(p.dtype == torch.float32 for p in port.parameters())


def test_unet_routes_attention_by_grad_mode(flow, monkeypatch):
    """Under grad every UNet attention call goes to K2 with the frame
    mask's key lengths and the static chunk mode when streaming; without
    grad, or with no input that requires grad, to K1."""
    _, variables, pcfg = flow
    port = _port(pcfg, variables)
    calls = []

    def spy(name, fn):
        def run(q, k, v, kv_len, chunk, left_chunks):
            calls.append((name, kv_len.tolist(), chunk, left_chunks))
            return fn(q, k, v, kv_len, chunk, left_chunks)
        monkeypatch.setattr(t_unet, name, run)

    spy("splash_chunk_attention", t_unet.splash_chunk_attention)
    spy("flash_attention", t_unet.flash_attention)
    rng = np.random.default_rng(4)
    x, mu, cond = (torch.as_tensor(rng.standard_normal((2, 16, 80)),
                                   dtype=torch.float32) for _ in range(3))
    mask = (torch.arange(16)[None] < torch.tensor([[16], [9]])).float()
    args = (x, mask, mu, torch.tensor([0.2, 0.7]), torch.zeros(2, 80), cond)
    n = 2 * len(pcfg.unet.channels) + pcfg.unet.num_mid_blocks
    for streaming, chunk in ((False, 0), (True, pcfg.unet.static_chunk_size)):
        calls.clear()
        port.estimate(*args, streaming=streaming).sum().backward()
        assert calls == [("splash_chunk_attention", [16, 9], chunk,
                          pcfg.unet.num_left_chunks)] * n
        calls.clear()
        with torch.no_grad():
            port.estimate(*args, streaming=streaming)
        assert [c[0] for c in calls] == ["flash_attention"] * n
    calls.clear()
    port.requires_grad_(False)
    port.estimate(*args)
    assert [c[0] for c in calls] == ["flash_attention"] * n


def test_padding_flow_identical():
    """padding_flow's dynamic-bucket branch against JAX's on the same
    samples: token bucket of 32, latents at 2x, reference mels."""
    rng = np.random.default_rng(6)
    batch = []
    for n_tok, n_ref in ((40, 70), (25, 33), (33, 100)):
        batch.append({
            "speech_token": rng.integers(0, 6561, n_tok).astype(np.int32),
            "speech_latent": rng.standard_normal((2 * n_tok, 80)).astype(
                np.float32),
            "reference_mels": [rng.standard_normal((n_ref, 80)).astype(
                np.float32)]})
    ours = next(t_dp.padding_flow([batch]))
    ref = next(j_dp.padding_flow([batch]))
    assert ours.keys() == ref.keys()
    assert ours["token"].shape == (3, 64) and ours["feat"].shape == (3, 128,
                                                                     80)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


def test_embed_speaker_multicrop_matches_jax(flow):
    """The 4-D (B, N, T, 80) reference path: each crop embedded, averaged
    and re-normalized; and the 3-D path; within 1e-5."""
    model, variables, pcfg = flow
    port = _port(pcfg, variables)
    rng = np.random.default_rng(8)
    mel = rng.standard_normal((2, 3, 30, 80)).astype(np.float32)
    mask = np.arange(30)[None, None] < np.array([[30, 12, 21],
                                                 [17, 30, 25]])[..., None]
    for m, k in ((mel, mask), (mel[:, 0], mask[:, 0])):
        ref = model.apply(variables, jnp.asarray(m), jnp.asarray(k),
                          method=j_flow.FlowModel.embed_speaker)
        with torch.no_grad():
            ours = port.embed_speaker(torch.as_tensor(m), torch.as_tensor(k))
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)


def test_flow_train_step_refuses_wrong_device(flow):
    _, variables, pcfg = flow
    with pytest.raises((RuntimeError, ValueError)):
        t_steps.make_flow_train_step(_port(pcfg, variables))
