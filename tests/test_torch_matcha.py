"""Matcha-TTS in the port against the JAX package, on the CPU: MAS, the
text frontend, the text encoder, the training losses, synthesis, the
HiFi-GAN and its denoiser; text_encoder_state and hifigan_state make
the upstream state dicts of tests/test_torch_convert.py.

Tiny geometries; random weights in the JAX initialiser's shapes loaded
by both packages (test_torch_legacy.random_variables); float32 on both
sides; random draws are JAX's (the CFM's keys as JAX splits them, and
the synthesis noise z), never a seed. Tolerances: maximum_path and the
text ids exact; the text encoder's mu_x and logw within 1e-5 of their
peak |value|; the losses 1e-5 relative and every leaf's gradient within
1e-4 of its largest element; the synthesised mel within 1e-4 of its
peak, the frame lengths exact; the HiFi-GAN's audio within 1e-4 of its
peak, the denoiser's output within 1e-4.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minimax_speech_torch.infer import matcha_text as t_text
from minimax_speech_torch.models import cfm as t_cfm
from minimax_speech_torch.models import decoder_unet as t_unet
from minimax_speech_torch.models import matcha as t_m
from minimax_speech_torch.models import matcha_hifigan as t_voc
from minimax_speech_torch.ops import monotonic_align as t_ma
from minimax_speech_torch.utils import params_io as t_io
from minimax_speech_tpu.infer import matcha_text as j_text
from minimax_speech_tpu.models import cfm as j_cfm
from minimax_speech_tpu.models import decoder_unet as j_unet
from minimax_speech_tpu.models import matcha as j_m
from minimax_speech_tpu.models import matcha_hifigan as j_voc
from minimax_speech_tpu.ops import monotonic_align as j_ma
from tests.test_torch_flow_train import jax_cfm_draws
from tests.test_torch_legacy import (_peak_close, assert_grads_close,
                                     random_variables)
from tests import torch_cpu

torch_cpu.share_cores()

UNET = dict(in_channels=16, out_channels=8, channels=(16,),
            attention_head_dim=8, n_blocks=1, num_mid_blocks=2, num_heads=2)
CFM = dict(use_immiscible=False, use_contrastive_fm=False,
           training_cfg_rate=0.0, inference_cfg_rate=0.0)
TINY = dict(n_vocab=40, n_feats=8, hidden=16, n_heads=2, n_layers=2,
            dp_filters=16, n_timesteps=3)
VOC = dict(in_channels=8, upsample_initial_channel=16, upsample_rates=(4, 2),
           upsample_kernel_sizes=(8, 4), resblock_kernel_sizes=(3, 5),
           resblock_dilation_sizes=((1, 2), (1, 2)))


def cfgs():
    return (j_m.MatchaConfig(**TINY, unet=j_unet.DecoderUNetConfig(**UNET),
                             cfm=j_cfm.CFMConfig(**CFM)),
            t_m.MatchaConfig(**TINY, unet=t_unet.DecoderUNetConfig(**UNET),
                             cfm=t_cfm.CFMConfig(**CFM)))


@pytest.fixture(scope="module")
def matcha():
    jcfg, pcfg = cfgs()
    model = j_m.MatchaTTS(jcfg)
    variables = random_variables(functools.partial(
        model.init, jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
        jnp.array([8]), jnp.zeros((1, 16, 8)), jnp.array([16]),
        jax.random.PRNGKey(1)), seed=7)
    port = t_io.load_flax_params(t_m.MatchaTTS(pcfg), variables)
    return model, variables, port


# --- MAS -------------------------------------------------------------------

def mas_case(rng, b, tx, ty, ties: bool):
    value = rng.standard_normal((b, tx, ty)).astype(np.float32)
    if ties:  # few distinct values: the DP meets equal scores often
        value = np.round(value).astype(np.float32)
    mask = np.zeros((b, tx, ty), bool)
    for i in range(b):
        x = int(rng.integers(2, tx + 1))
        mask[i, :x, :int(rng.integers(x, ty + 1))] = True
    return value, mask


@pytest.mark.parametrize("b,tx,ty,ties", [(4, 6, 12, False),
                                          (3, 9, 30, True),
                                          (2, 5, 5, True)])
def test_maximum_path_matches_jax_and_numpy(rng, b, tx, ty, ties):
    """The same path as JAX's scan DP and as the numpy reference,
    exactly, ties (the diagonal taken on >=) included."""
    value, mask = mas_case(rng, b, tx, ty, ties)
    ours = t_ma.maximum_path(torch.from_numpy(value),
                             torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(
        ours, np.asarray(j_ma.maximum_path(jnp.asarray(value),
                                           jnp.asarray(mask))))
    np.testing.assert_array_equal(ours, t_ma.maximum_path_numpy(value, mask))
    np.testing.assert_array_equal(ours, j_ma.maximum_path_numpy(value, mask))


# --- text -------------------------------------------------------------------

@pytest.mark.parametrize("text,cleaners", [
    ("Hello world!", ("basic_cleaners",)),
    ("Café — naïve «test»", ("transliteration_cleaners",)),
    ("Dr. Smith owes $5.20 to Mrs. Jones on the 3rd.",
     ("english_cleaners2",)),
    ("It cost 1,000 pounds; ok?", ("english_cleaners2",))])
def test_process_text_matches_jax(text, cleaners):
    """process_text's ids and symbols, exactly (espeak or not, as the
    JAX package)."""
    assert t_text.symbols == j_text.symbols
    assert t_text.process_text(text, cleaners) \
        == j_text.process_text(text, cleaners)
    seq, _ = t_text.process_text(text, cleaners)
    assert t_text.intersperse([5, 9], 0) == [0, 5, 0, 9, 0]
    assert t_text.sequence_to_text(seq) == j_text.sequence_to_text(seq)


# --- the acoustic model ---------------------------------------------------

def test_text_encoder_matches_jax(matcha, rng):
    """mu_x and logw within 1e-5 of their peaks; the mask exact."""
    model, variables, port = matcha
    tokens = rng.integers(1, 40, (2, 9))
    lens = np.array([9, 6])
    enc = j_m.TextEncoder(model.cfg)
    mu, logw, mask = enc.apply({"params": variables["params"]["encoder"]},
                               jnp.asarray(tokens), jnp.asarray(lens))
    with torch.no_grad():
        tmu, tlogw, tmask = port.encoder(torch.as_tensor(tokens),
                                         torch.as_tensor(lens))
    _peak_close(tmu.numpy(), mu, 1e-5)
    _peak_close(tlogw.numpy(), logw, 1e-5)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(mask))


def _batch(rng):
    tokens = rng.integers(1, 40, (2, 7))
    mels = rng.standard_normal((2, 20, 8)).astype(np.float32)
    return tokens, np.array([7, 5]), mels, np.array([20, 14])


def test_matcha_losses_and_grads_match_jax(matcha, rng):
    """dur, prior and CFM losses within 1e-5 relative, given JAX's CFM
    draws (MAS the same path on both sides), and every leaf's gradient
    of their sum (assert_grads_close)."""
    model, variables, port = matcha
    batch = _batch(rng)
    key = jax.random.PRNGKey(2)

    def jloss(params):
        d, p, c = model.apply({"params": params},
                              *(jnp.asarray(a) for a in batch), key)
        return d + p + c, (d, p, c)

    (_, refs), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        variables["params"])
    draws = jax_cfm_draws(key, port.cfg.cfm, 2, 20, 8)
    losses = port(*(torch.as_tensor(a) for a in batch), draws)
    for ours, ref in zip(losses, refs):
        np.testing.assert_allclose(float(ours.detach()), float(ref),
                                   rtol=1e-5)
    params = [p for _, p in t_io.named_flax_params(port)]
    grads = torch.autograd.grad(sum(losses), params, allow_unused=True)
    assert_grads_close(port, [torch.zeros_like(p) if g is None else g
                              for p, g in zip(params, grads)], jgrads)


def test_matcha_synthesise_matches_jax(matcha, rng):
    """matcha_synthesise on JAX's z: the mel within 1e-4 of its peak over
    the valid frames, the frame lengths exact."""
    model, variables, port = matcha
    tokens = rng.integers(1, 40, (2, 6))
    lens = np.array([6, 4])
    key = jax.random.PRNGKey(3)
    mel, y_len = jax.jit(functools.partial(
        j_m.matcha_synthesise, model, max_frames=64))(
        variables, jnp.asarray(tokens), jnp.asarray(lens), key)
    z = np.asarray(jax.random.normal(key, (2, 64, 8)))
    tmel, ty_len = t_m.matcha_synthesise(port, tokens, lens, z=z,
                                         max_frames=64, device="cpu")
    np.testing.assert_array_equal(ty_len.numpy(), np.asarray(y_len))
    for i, n in enumerate(np.asarray(y_len)):
        _peak_close(tmel[i, :n].numpy(), np.asarray(mel)[i, :n])


# --- the vocoder ------------------------------------------------------------

@pytest.fixture(scope="module")
def vocoder():
    model = j_voc.MatchaHiFiGAN(j_voc.MatchaHiFiGANConfig(**VOC))
    variables = jax.jit(model.init)(jax.random.PRNGKey(0),
                                    jnp.zeros((1, 8, 8)))
    port = t_io.load_flax_params(
        t_voc.MatchaHiFiGAN(t_voc.MatchaHiFiGANConfig(**VOC)), variables)
    return model, variables, port


def test_matcha_hifigan_matches_jax(vocoder, rng):
    """The audio within 1e-4 of its peak."""
    model, variables, port = vocoder
    mel = rng.standard_normal((2, 11, 8)).astype(np.float32)
    ref = np.asarray(jax.jit(model.apply)(variables, jnp.asarray(mel)))
    with torch.no_grad():
        ours = port(torch.from_numpy(mel)).numpy()
    assert ours.shape == ref.shape == (2, 88)
    _peak_close(ours, ref)


@pytest.mark.parametrize("mode,strength", [("zeros", 1.0), ("zeros", 0.0),
                                           ("normal", 0.5)])
def test_denoiser_matches_jax(vocoder, mode, strength):
    """The bias spectrum and the denoised audio within 1e-4."""
    model, variables, port = vocoder
    kw = dict(filter_length=64, n_overlap=4, mode=mode, mel_frames=16,
              n_mels=8)
    jden = j_voc.Denoiser(lambda m: model.apply(variables, m), **kw)
    tden = t_voc.Denoiser(port, **kw)
    np.testing.assert_allclose(tden.bias_spec.numpy(),
                               np.asarray(jden.bias_spec), atol=1e-4)
    audio = np.asarray(model.apply(variables, jnp.ones((1, 32, 8)) * 0.3))[0]
    np.testing.assert_allclose(
        tden(torch.from_numpy(audio), strength).numpy(),
        np.asarray(jden(jnp.asarray(audio), strength)), atol=1e-4)


# --- upstream state dicts for the converters' tests --------------------------

def text_encoder_state(cfg, rng) -> dict:
    """A random released-layout Matcha acoustic state dict (the encoder's
    keys) for cfg."""
    h, f = cfg.hidden, cfg.filter_channels or 4 * cfg.hidden
    s = {"emb.weight": (cfg.n_vocab, h)}

    def conv(name, o, i, k):
        s[name + ".weight"], s[name + ".bias"] = (o, i, k), (o,)

    def ln(name, c):
        s[name + ".gamma"], s[name + ".beta"] = (c,), (c,)

    for i in range(3):
        conv(f"prenet.conv_layers.{i}", h, h, cfg.prenet_kernel)
        ln(f"prenet.norm_layers.{i}", h)
    conv("prenet.proj", h, h, 1)
    for i in range(cfg.n_layers):
        for nm in "qkvo":
            conv(f"encoder.attn_layers.{i}.conv_{nm}", h, h, 1)
        ln(f"encoder.norm_layers_1.{i}", h)
        ln(f"encoder.norm_layers_2.{i}", h)
        conv(f"encoder.ffn_layers.{i}.conv_1", f, h, cfg.enc_kernel)
        conv(f"encoder.ffn_layers.{i}.conv_2", h, f, cfg.enc_kernel)
    conv("proj_m", cfg.n_feats, h, 1)
    conv("proj_w.conv_1", cfg.dp_filters, h, cfg.dp_kernel)
    ln("proj_w.norm_1", cfg.dp_filters)
    conv("proj_w.conv_2", cfg.dp_filters, cfg.dp_filters, cfg.dp_kernel)
    ln("proj_w.norm_2", cfg.dp_filters)
    conv("proj_w.proj", 1, cfg.dp_filters, 1)
    return {"encoder." + k: rng.standard_normal(v).astype(np.float32)
            for k, v in s.items()}


def hifigan_state(cfg, rng) -> dict:
    """A random generator_v1 state dict (weight_g / weight_v, under a
    'generator.' prefix) for cfg."""
    s = {}

    def wn(name, o, i, k, transposed=False):
        s[name + ".weight_v"] = (i, o, k) if transposed else (o, i, k)
        s[name + ".weight_g"] = (i, 1, 1) if transposed else (o, 1, 1)
        s[name + ".bias"] = (o,)

    ch = cfg.upsample_initial_channel
    wn("conv_pre", ch, cfg.in_channels, 7)
    n_k = len(cfg.resblock_kernel_sizes)
    for i, (u, k) in enumerate(zip(cfg.upsample_rates,
                                   cfg.upsample_kernel_sizes)):
        out = cfg.upsample_initial_channel // 2 ** (i + 1)
        wn(f"ups.{i}", out, ch, k, transposed=True)
        for j, (rk, rd) in enumerate(zip(cfg.resblock_kernel_sizes,
                                         cfg.resblock_dilation_sizes)):
            for jj in range(len(rd)):
                for c in ("convs1", "convs2"):
                    wn(f"resblocks.{i * n_k + j}.{c}.{jj}", out, out, rk)
        ch = out
    wn("conv_post", 1, ch, 7)
    return {"generator." + k: rng.standard_normal(v).astype(np.float32)
            for k, v in s.items()}
