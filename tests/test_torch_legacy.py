"""The legacy CosyVoice1 flow and LM in the port against the JAX package,
on the CPU.

Tiny geometries; random weights in the shapes the JAX initialiser gives
(`random_variables`: no compile of the initialiser), loaded by both
packages; float32 on both sides. Random draws are JAX's (the flow loss's
k_keep, k_idx and the CFM's keys, split as JAX splits them), never a
seed. Tolerances: interpolate_linear 1e-6; the decoder's velocity and
the inference mel within 1e-4 of their peak |value|; losses and the LM's
accuracy 1e-5 relative; gradients within 1e-4 of each leaf's largest
element; the converter exact. On the CPU the UNet attends through K1's
and K2's plain versions.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minimax_speech_torch.models import cfm as t_cfm
from minimax_speech_torch.models import legacy_flow as t_lf
from minimax_speech_torch.models import legacy_lm as t_llm
from minimax_speech_torch.models import llm as t_llm_mod
from minimax_speech_torch.models.flow import FlowDraws
from minimax_speech_torch.ops import interpolate as t_interp
from minimax_speech_torch.ops import masks as t_masks
from minimax_speech_torch.utils import convert as t_conv
from minimax_speech_torch.utils import params_io as t_io
from minimax_speech_tpu.models import cfm as j_cfm
from minimax_speech_tpu.models import legacy_flow as j_lf
from minimax_speech_tpu.models import legacy_lm as j_llm
from minimax_speech_tpu.ops import interpolate as j_interp
from minimax_speech_tpu.ops import masks as j_masks
from minimax_speech_tpu.ops.safe_conv import ConvTranspose1dSafe
from minimax_speech_tpu.utils import convert as j_conv
from tests.test_torch_flow_train import jax_cfm_draws
from tests import torch_cpu

torch_cpu.share_cores()

UNET = dict(in_channels=32, out_channels=8, channels=(16, 16),
            attention_head_dim=8, n_blocks=2, num_mid_blocks=2, num_heads=2)
SEED = 1  # JAX key of the loss: a prefix kept on 1 of 3 samples, CFG drops 1
ENC = dict(input_size=16, output_size=16, attention_heads=2,
           linear_units=32, num_blocks=2)


def flow_cfgs(cfm_kw=None):
    """(JAX, port) LegacyFlowConfig at the tiny geometry."""
    cfm_kw = cfm_kw or dict(use_contrastive_fm=False, use_immiscible=True,
                            immiscible_k=4, training_cfg_rate=0.2,
                            inference_cfg_rate=0.7)
    common = dict(input_size=16, output_size=8, spk_embed_dim=12,
                  vocab_size=50, n_timesteps=3)
    return (j_lf.LegacyFlowConfig(
                **common, encoder=j_lf.LegacyEncoderConfig(**ENC),
                unet=j_lf.LegacyUNetConfig(**UNET),
                cfm=j_cfm.CFMConfig(**cfm_kw)),
            t_lf.LegacyFlowConfig(
                **common, encoder=t_lf.LegacyEncoderConfig(**ENC),
                unet=t_lf.LegacyUNetConfig(**UNET),
                cfm=t_cfm.CFMConfig(**cfm_kw)))


def random_variables(init, seed: int):
    """Random numpy weights in the shapes of `init()`'s tree, read with
    jax.eval_shape: scales (scale, gamma) 1 + N(0, 0.1^2), biases and
    betas N(0, 0.1^2), kernels N(0, 1/fan-in) (fan-in: every axis but
    the last), embeddings N(0, 1), the rest (rel-pos biases)
    N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        x = rng.standard_normal(s.shape).astype(np.float32)
        if name in ("scale", "gamma"):
            return 1.0 + 0.1 * x
        if name == "kernel":
            return x / math.sqrt(math.prod(s.shape[:-1]))
        if name == "embedding":
            return x
        return 0.1 * x

    return jax.tree_util.tree_map_with_path(leaf, jax.eval_shape(init))


@pytest.fixture(scope="module")
def legacy_flow():
    jcfg, pcfg = flow_cfgs()
    model = j_lf.MaskedDiffWithXvec(jcfg)
    variables = random_variables(functools.partial(
        j_lf.init_legacy_flow_variables, model, jax.random.PRNGKey(3), 2, 6),
        seed=3)
    port = t_io.load_flax_params(t_lf.MaskedDiffWithXvec(pcfg), variables)
    return model, variables, port


def _peak_close(ours, ref, rtol=1e-4):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape
    err = float(np.abs(ours - ref).max())
    assert err <= rtol * float(np.abs(ref).max()), err


def test_causal_mask_matches_jax():
    np.testing.assert_array_equal(t_masks.causal_mask(7).numpy(),
                                  np.asarray(j_masks.causal_mask(7)))


@pytest.mark.parametrize("t_in,t_out", [(9, 15), (12, 12), (10, 87),
                                        (23, 7)])
def test_interpolate_linear_matches_jax_and_torch(rng, t_in, t_out):
    """Within 1e-6 of JAX's; within 1e-6 of the peak of torch's
    F.interpolate(mode='linear'), which takes its source coordinates in
    float32 (the static form in float64)."""
    x = rng.standard_normal((2, 3, t_in)).astype(np.float32)
    ours = t_interp.interpolate_linear(torch.from_numpy(x), t_out).numpy()
    np.testing.assert_allclose(
        ours, np.asarray(j_interp.interpolate_linear(jnp.asarray(x), t_out)),
        atol=1e-6, rtol=0)
    _peak_close(ours, torch.nn.functional.interpolate(
        torch.from_numpy(x), size=t_out, mode="linear").numpy(), 1e-6)
    np.testing.assert_array_equal(
        t_interp.interpolate_nearest(torch.from_numpy(x), 2).numpy(),
        np.asarray(j_interp.interpolate_nearest(jnp.asarray(x), 2)))


@pytest.mark.parametrize("t", [6, 7])
def test_conv_transpose_layout_round_trips(rng, t):
    """ConvTranspose1d(k 4, s 2, pad 1) loaded from ConvTranspose1dSafe's
    (k, out, in) kernel gives its output within 1e-5, and the weight
    saves back to the same kernel."""
    mod = ConvTranspose1dSafe(6, 4, 2)
    x = rng.standard_normal((2, t, 5)).astype(np.float32)
    variables = random_variables(functools.partial(
        mod.init, jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    conv = torch.nn.ConvTranspose1d(5, 6, 4, 2, padding=1)
    t_io.load_flax_params(conv, variables)
    ours = conv(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
    ref = np.asarray(mod.apply(variables, jnp.asarray(x)))
    assert ours.shape == (2, 2 * t, 6)
    np.testing.assert_allclose(ours.detach().numpy(), ref, atol=1e-5)
    back = t_io.to_flax_params(conv)["params"]["kernel"]
    np.testing.assert_array_equal(back, variables["params"]["kernel"])


def test_legacy_decoder_matches_jax(legacy_flow, rng):
    """The non-causal UNet's velocity at an odd T (the up path trims to
    the skip's length) with a ragged prefix mask."""
    model, variables, port = legacy_flow
    b, t, d = 2, 11, 8
    x, mu, cond = (rng.standard_normal((b, t, d)).astype(np.float32)
                   for _ in range(3))
    spks = rng.standard_normal((b, d)).astype(np.float32)
    tt = np.array([0.3, 0.8], np.float32)
    mask = (np.arange(t)[None] < np.array([[t], [7]])).astype(np.float32)
    ref = jax.jit(functools.partial(
        model.apply, method=j_lf.MaskedDiffWithXvec.estimate))(
        variables, *(jnp.asarray(a) for a in (x, mask, mu, tt, spks, cond)))
    with torch.no_grad():
        ours = port.estimate(*(torch.from_numpy(a) for a in
                               (x, mask, mu, tt, spks, cond)))
    _peak_close(ours.numpy(), ref)


def test_legacy_flow_inference_matches_jax(legacy_flow, rng):
    """legacy_flow_inference with a 3-token prompt (5 mel frames) and 6
    new tokens (10 frames): the generated mel within 1e-4 of its peak;
    the mel grid of 15 frames is odd at the UNet's first stage."""
    model, variables, port = legacy_flow
    tok = rng.integers(0, 50, (1, 6))
    ptok = rng.integers(0, 50, (1, 3))
    pfeat = rng.standard_normal((1, 5, 8)).astype(np.float32)
    emb = rng.standard_normal((1, 12)).astype(np.float32)
    noise = rng.standard_normal((1, 64, 8)).astype(np.float32)
    ref = jax.jit(j_lf.legacy_flow_inference, static_argnums=0)(
        model, variables, jnp.asarray(tok), jnp.array([6]),
        jnp.asarray(ptok), jnp.array([3]), jnp.asarray(pfeat),
        jnp.asarray(emb), jnp.asarray(noise))
    ours = t_lf.legacy_flow_inference(port, tok, [6], ptok, [3], pfeat, emb,
                                      noise, device="cpu")
    assert ours.shape == (1, 10, 8)
    _peak_close(ours.numpy(), ref)


def jax_legacy_draws(key, cfg, b, tf) -> FlowDraws:
    """The numbers JAX's MaskedDiffWithXvec.__call__ draws from `key`."""
    k_keep, k_idx, k_cfm = jax.random.split(key, 3)
    return FlowDraws(
        use_cond=torch.as_tensor(np.array(
            jax.random.uniform(k_keep, (b,)) < cfg.cond_prob)),
        frac=torch.as_tensor(np.array(jax.random.uniform(k_idx, (b,)))),
        cfm=jax_cfm_draws(k_cfm, cfg.cfm, b, tf, cfg.output_size))


def _flow_batch(rng):
    tok = rng.integers(0, 50, (3, 7))
    tok_len = np.array([7, 4, 6], np.int32)
    feat = rng.standard_normal((3, 15, 8)).astype(np.float32)
    feat_len = np.array([15, 9, 12], np.int32)
    emb = rng.standard_normal((3, 12)).astype(np.float32)
    return tok, tok_len, feat, feat_len, emb


def assert_grads_close(port, grads, jgrads):
    """Each leaf's gradient within 1e-4 of its largest element (JAX's);
    a leaf that is 0 but for rounding (a key bias, which softmax ignores)
    within 1e-7 of the model's largest on both sides."""
    theirs = t_io._flatten(jgrads)
    top = max(float(np.abs(np.asarray(g)).max()) for g in theirs.values())
    checked = 0
    for (path, _, _, to_flax), g in zip(t_io._params_with_paths(port),
                                        grads):
        ref = np.asarray(theirs[path])
        ours = to_flax(g.detach().numpy())
        scale = float(np.abs(ref).max())
        if path[-2:] == ("linear_k", "bias"):
            assert max(np.abs(ours).max(), scale) <= 1e-7 * top
            continue
        err = float(np.abs(ours - ref).max())
        assert err <= 1e-4 * scale, ("/".join(path), err, scale)
        checked += 1
    assert checked > 20


def test_legacy_flow_loss_and_grads_match_jax(legacy_flow, rng):
    """The training loss within 1e-5 relative and every leaf's gradient
    (assert_grads_close) given JAX's draws, which keep a prompt prefix
    on some samples and drop the CFG conditioning of one."""
    model, variables, port = legacy_flow
    batch = _flow_batch(rng)
    key = jax.random.PRNGKey(SEED)

    def jloss(params):
        return model.apply({"params": params},
                           *(jnp.asarray(a) for a in batch), key)

    ref, jgrads = jax.jit(jax.value_and_grad(jloss))(variables["params"])
    draws = jax_legacy_draws(key, port.cfg, 3, 15)
    assert 0 < int(draws.use_cond.sum()) < 3
    assert float(draws.cfm.keep.sum()) == 2
    params = [p for _, p in t_io.named_flax_params(port)]
    loss = port(*(torch.as_tensor(a) for a in batch), draws)
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-5)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)]
    assert_grads_close(port, grads, jgrads)


def test_legacy_unet_routes_attention_by_grad_mode(legacy_flow, rng,
                                                   monkeypatch):
    """Each transformer block attends with its stage's key lengths
    (T, then ceil(T/2) below the first stage): through K1 without grad,
    through K2 under grad; 2 x 2 + 2 x 2 + 2 x 2 blocks a pass."""
    from minimax_speech_torch.models import decoder_unet as t_unet

    _, _, port = legacy_flow
    calls = {"k1": [], "k2": []}

    def spy(name, fn):
        def run(q, k, v, kv_len, chunk, left_chunks):
            calls[name].append((q.shape[2], kv_len.tolist(), chunk))
            return fn(q, k, v, kv_len, chunk, left_chunks)
        return run

    monkeypatch.setattr(t_unet, "flash_attention",
                        spy("k1", t_unet.flash_attention))
    monkeypatch.setattr(t_unet, "splash_chunk_attention",
                        spy("k2", t_unet.splash_chunk_attention))
    x = torch.randn(2, 11, 8)
    mask = (torch.arange(11)[None] < torch.tensor([[11], [7]])).float()
    args = (x, mask, x, torch.tensor([0.2, 0.5]), torch.randn(2, 8), x)
    with torch.no_grad():
        port.estimate(*args)
    want = ([(11, [11, 7], 0)] * 2 + [(6, [6, 4], 0)] * 8
            + [(11, [11, 7], 0)] * 2)
    assert calls == {"k1": want, "k2": []}
    calls["k1"].clear()
    port.estimate(*args).sum().backward()
    assert calls == {"k1": [], "k2": want}


def test_legacy_flow_params_matches_jax_converter(rng):
    """legacy_flow_params on a random upstream-layout state dict (the
    names the JAX converter reads) equals JAX's, leaf for leaf, and the
    tree loads into MaskedDiffWithXvec with no leaf left over."""
    jcfg, pcfg = flow_cfgs()
    model = j_lf.MaskedDiffWithXvec(jcfg)
    variables = jax.eval_shape(functools.partial(
        j_lf.init_legacy_flow_variables, model, jax.random.PRNGKey(0), 1, 6))
    state = upstream_legacy_state(variables["params"], pcfg, rng)
    ours = t_io._flatten(t_conv.legacy_flow_params(dict(state), pcfg))
    theirs = t_io._flatten(j_conv.legacy_flow_params(dict(state), jcfg))
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(np.asarray(ours[k]),
                                      np.asarray(theirs[k]), err_msg=str(k))
    t_io.load_flax_params(t_lf.MaskedDiffWithXvec(pcfg),
                          t_conv.legacy_flow_params(state, pcfg))


def upstream_legacy_state(params, cfg, rng) -> dict:
    """A random state dict in the upstream MaskedDiffWithXvec layout, each
    tensor shaped as the flax leaf it converts to, under a 'module.'
    prefix."""
    s = {}

    def put(name, leaf, kind):
        shape = {"dense": leaf.shape[::-1], "conv": leaf.shape[::-1],
                 "convT": leaf.shape[::-1], "1x1": leaf.shape[::-1] + (1,)
                 }.get(kind, leaf.shape)
        s["module." + name] = rng.standard_normal(shape).astype(np.float32)

    def lin(name, p, kind="dense"):
        put(name + ".weight", p["kernel"], kind)
        if "bias" in p:
            put(name + ".bias", p["bias"], "")

    def norm(name, p):
        put(name + ".weight", p["scale"], "")
        put(name + ".bias", p["bias"], "")

    put("input_embedding.weight", params["input_embedding"]["embedding"], "")
    lin("spk_embed_affine_layer", params["spk_embed_affine_layer"])
    lin("encoder_proj", params["encoder_proj"])
    enc = params["encoder"]
    lin("encoder.embed.out.0", enc["embed_linear"])
    norm("encoder.embed.out.1", enc["embed_norm"])
    norm("encoder.after_norm", enc["after_norm"])
    for i in range(cfg.encoder.num_blocks):
        lay, pre = enc[f"layers_{i}"], f"encoder.encoders.{i}."
        norm(pre + "norm_mha", lay["norm_mha"])
        norm(pre + "norm_ff", lay["norm_ff"])
        sa = lay["self_attn"]
        for nm in ("linear_q", "linear_k", "linear_v", "linear_out",
                   "linear_pos"):
            lin(pre + "self_attn." + nm, sa[nm])
        put(pre + "self_attn.pos_bias_u", sa["pos_bias_u"], "")
        put(pre + "self_attn.pos_bias_v", sa["pos_bias_v"], "")
        for nm in ("w_1", "w_2"):
            lin(pre + "feed_forward." + nm, lay["feed_forward"][nm])
    reg = params["length_regulator"]
    lin("length_regulator.model.0", reg["conv_0"], "conv")
    norm("length_regulator.model.1", reg["norm_0"])
    lin("length_regulator.model.3", reg["out_proj"], "1x1")

    est, d = params["estimator"], "decoder.estimator."
    for nm in ("linear_1", "linear_2"):
        lin(f"{d}time_mlp.{nm}", est["time_mlp"][nm])

    def block(pre, p):
        lin(pre + "block.0", p["conv"], "conv")
        norm(pre + "block.1", p["norm"])

    def stage(name, pre):
        r = est[f"{name}_resnet"]
        block(pre + "0.block1.", r["block1"])
        block(pre + "0.block2.", r["block2"])
        lin(pre + "0.mlp.1", r["mlp"])
        lin(pre + "0.res_conv", r["res_conv"], "1x1")
        for j in range(cfg.unet.n_blocks):
            tf, tp = est[f"{name}_tf_{j}"], pre + f"1.{j}."
            norm(tp + "norm1", tf["norm1"])
            norm(tp + "norm3", tf["norm3"])
            for nm in ("to_q", "to_k", "to_v"):
                lin(tp + "attn1." + nm, tf[nm])
            lin(tp + "attn1.to_out.0", tf["to_out"])
            lin(tp + "ff.net.0.proj", tf["ff_in"])
            lin(tp + "ff.net.2", tf["ff_out"])

    n = len(cfg.unet.channels)
    for kind in ("down", "up"):
        for i in range(n):
            pre = f"{d}{kind}_blocks.{i}."
            stage(f"{kind}_{i}", pre)
            last = i == n - 1
            lin(pre + ("2" if last else "2.conv"), est[f"{kind}_{i}_conv"],
                "conv" if last or kind == "down" else "convT")
    for i in range(cfg.unet.num_mid_blocks):
        stage(f"mid_{i}", f"{d}mid_blocks.{i}.")
    block(d + "final_block.", est["final_block"])
    lin(d + "final_proj", est["final_proj"], "1x1")
    return s


# --- the legacy LM --------------------------------------------------------

LM_KW = dict(text_vocab_size=40, speech_token_size=30,
             text_encoder_input_size=16, llm_input_size=24,
             llm_output_size=24, text_encoder_blocks=2, llm_blocks=2,
             attention_heads=2, linear_units=32, spk_embed_dim=12)


@pytest.fixture(scope="module")
def legacy_lm():
    jcfg = j_llm.LegacyLMConfig(**LM_KW, lsm_weight=0.1)
    pcfg = t_llm.LegacyLMConfig(**LM_KW, lsm_weight=0.1)
    batch = lm_batch(np.random.default_rng(5))
    model = j_llm.LegacyTransformerLM(jcfg)
    variables = random_variables(functools.partial(
        model.init, jax.random.PRNGKey(4), *(
            jnp.asarray(batch[k]) for k in ("src_type", "tok_id", "target",
                                            "seq_len", "spk_emb",
                                            "text_token", "text_len"))), 4)
    port = t_io.load_flax_params(t_llm.LegacyTransformerLM(pcfg), variables)
    return model, variables, port, batch


def lm_batch(rng) -> dict:
    """Two unistream plans (models/llm.build_lm_plan) of ragged text and
    speech, the text ids also as a padded text_token batch."""
    texts = [rng.integers(0, 40, n) for n in (5, 3)]
    speech = [rng.integers(0, 30, n) for n in (9, 6)]
    plan = t_llm_mod.build_lm_plan(texts, speech, mix_ratio=(5, 15),
                                   eos=30, fill=32)
    text_token = np.zeros((2, 5), np.int64)
    for i, t in enumerate(texts):
        text_token[i, :len(t)] = t
    return {**{k: np.asarray(v) for k, v in plan.items()},
            "spk_emb": rng.standard_normal((2, 24)).astype(np.float32),
            "text_token": text_token, "text_len": np.array([5, 3])}


@pytest.mark.parametrize("encode_text", [True, False])
def test_legacy_lm_loss_and_accuracy_match_jax(legacy_lm, encode_text):
    """Loss (label smoothing 0.1) and accuracy within 1e-5 relative, with
    the text encoder's outputs at the text positions or the plain text
    embeddings; with the encoder, every leaf's gradient too."""
    model, variables, port, batch = legacy_lm
    keys = ["src_type", "tok_id", "target", "seq_len", "spk_emb"]
    if encode_text:
        keys += ["text_token", "text_len"]

    def jloss(params):
        return model.apply({"params": params},
                           *(jnp.asarray(batch[k]) for k in keys))

    (ref, racc), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        variables["params"])
    loss, acc = port(*(torch.as_tensor(batch[k]) for k in keys))
    np.testing.assert_allclose(float(loss), float(ref), rtol=1e-5)
    np.testing.assert_allclose(float(acc), float(racc), rtol=1e-5)
    if encode_text:
        params = [p for _, p in t_io.named_flax_params(port)]
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        assert_grads_close(port, [torch.zeros_like(p) if g is None else g
                                  for p, g in zip(params, grads)], jgrads)


def test_legacy_flow_configs_agree():
    """The port's default configs are the JAX package's."""
    for j, p in ((j_lf.LegacyFlowConfig(), t_lf.LegacyFlowConfig()),
                 (j_llm.LegacyLMConfig(), t_llm.LegacyLMConfig())):
        jd, pd = dataclasses.asdict(j), dataclasses.asdict(p)
        assert jd == pd
