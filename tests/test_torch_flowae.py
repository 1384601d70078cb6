"""flowae's audio track in the port against the JAX package, on the CPU:
the FM formulation, both DiTs, DiTo with the DiT and the UNet renderer,
its train step and EMA, the ZDM prior, GLPTo against the MSD, and the
eval suites.

Tiny geometries; random weights in the JAX initialiser's shapes loaded
by both packages (test_torch_legacy.random_variables); the random draws
are JAX's (t, the immiscible candidates, the encoder's eps, the drop
masks, the Euler start noise), fed to the port, never a seed.
Tolerances: forward outputs within 1e-4 of their peak, the encoders
within 1e-5; losses within 1e-5 relative; every leaf's gradient within
1e-4 of its largest element (a leaf whose gradient is 0 but for
rounding, as the key bias under softmax, within 1e-5 of the model's
largest on both sides); Euler decodes within 1e-4 of their peak from
the same start noise; power_spectrogram within 1e-5 of its peak.
"""
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minimax_speech_torch.flowae import dit as t_dit
from minimax_speech_torch.flowae import dito as t_dito
from minimax_speech_torch.flowae import evaluate as t_ev
from minimax_speech_torch.flowae import fm as t_fm
from minimax_speech_torch.flowae import glpto as t_glp
from minimax_speech_torch.flowae import trainer as t_tr
from minimax_speech_torch.flowae import zdm as t_zdm
from minimax_speech_torch.flowae.consistency_unet import \
    ConsistencyUNetConfig as TUNetCfg
from minimax_speech_torch.models import discriminators as t_disc
from minimax_speech_torch.train import schedule as t_sched
from minimax_speech_torch.train import steps as t_steps
from minimax_speech_torch.utils import params_io as t_io
from minimax_speech_tpu.flowae import dit as j_dit
from minimax_speech_tpu.flowae import dito as j_dito
from minimax_speech_tpu.flowae import evaluate as j_ev
from minimax_speech_tpu.flowae import fm as j_fm
from minimax_speech_tpu.flowae import glpto as j_glp
from minimax_speech_tpu.flowae import trainer as j_tr
from minimax_speech_tpu.flowae import zdm as j_zdm
from minimax_speech_tpu.flowae.consistency_unet import \
    ConsistencyUNetConfig as JUNetCfg
from minimax_speech_tpu.models import discriminators as j_disc
from minimax_speech_tpu.utils import audio_losses as j_al
from tests.test_torch_codec_train import capture
from tests.test_torch_legacy import _peak_close, random_variables
from tests import torch_cpu

torch_cpu.share_cores()

SEED = 17


def T(a):
    """numpy or JAX array -> a torch tensor of its own copy."""
    return torch.from_numpy(np.array(a))


def np_(x):
    return np.asarray(x.detach().cpu().float() if torch.is_tensor(x) else x)


def rel_close(ours, ref, rtol=1e-5):
    ours, ref = float(ours), float(ref)
    assert abs(ours - ref) <= rtol * max(abs(ref), 1e-12), (ours, ref)


def assert_grads_close(port, grads, jgrads, min_checked=8):
    """Each leaf's gradient within 1e-4 of its largest element (JAX's); a
    leaf that is 0 but for rounding (JAX's largest under 1e-5 of the
    model's largest, as a key bias under softmax) within 1e-5 of the
    model's largest on both sides."""
    theirs = t_io._flatten(jgrads.get("params", jgrads))
    top = max(float(np.abs(np.asarray(g)).max()) for g in theirs.values())
    checked = 0
    for (path, _, _, to_flax), g in zip(t_io._params_with_paths(port),
                                        grads):
        ref = np.asarray(theirs[path], np.float32)
        ours = to_flax(np_(g))
        scale = float(np.abs(ref).max())
        if scale <= 1e-5 * top:
            assert float(np.abs(ours).max()) <= 1e-5 * top, "/".join(path)
            continue
        err = float(np.abs(ours - ref).max())
        assert err <= 1e-4 * scale, ("/".join(path), err, scale)
        checked += 1
    assert checked >= min_checked


def port_grads(module, loss):
    params = [p for _, p in t_io.named_flax_params(module)]
    return torch.autograd.grad(loss, params, allow_unused=True)


# --- JAX's draws, as its functions split their keys --------------------------

def jax_fm_draws(key, x_shape, cfg, t=None):
    """FMDraws of j_fm.fm_loss(key, x) for an x of x_shape."""
    k_t, k_n = jax.random.split(key)
    if t is None:
        t = jax.random.uniform(k_t, (x_shape[0],))
    shape = ((x_shape[0], cfg.k_candidates) + tuple(x_shape[1:])
             if cfg.use_immiscible else tuple(x_shape))
    return t_fm.FMDraws(T(np.asarray(t, np.float32)),
                        T(jax.random.normal(k_n, shape)))


def jax_dito_draws(key, x_shape, z_shape, cfg, zaug_p):
    """DiToDraws of DiToAudio/DiToImage.loss(x, key, zaug_p)."""
    k_enc, k_fm, k_drop = jax.random.split(key, 3)
    eps = jax.random.normal(k_enc, z_shape)
    drop = jax.random.bernoulli(k_drop, zaug_p,
                                (x_shape[0],) + (1,) * (len(x_shape) - 1))
    return t_dito.DiToDraws(T(np.asarray(eps)),
                            T(np.asarray(drop).reshape(-1).copy()),
                            jax_fm_draws(k_fm, x_shape, cfg.fm))


def mixed_drop_key(b, zaug_p):
    """The first key from PRNGKey(SEED) on whose zaug drop mask (as
    jax_dito_draws splits it) holds for some rows and not for others."""
    for i in range(100):
        key = jax.random.PRNGKey(SEED + i)
        drop = np.asarray(jax.random.bernoulli(jax.random.split(key, 3)[2],
                                               zaug_p, (b,)))
        if drop.any() and not drop.all():
            return key
    raise AssertionError("no key with a mixed drop mask")


# --- configurations ----------------------------------------------------------

DIT = dict(hidden=32, depth=2, num_heads=4, patch=4, in_channels=1,
           out_channels=1, cond_dim=4)
UNET = dict(c0=16, c1=32, c2=32, pe_dim=16, t_dim=32, groups=8)
AUDIO_LEN = 64


def dito_cfgs(renderer_type="dit", immiscible=True):
    kw = dict(z_dim=4, enc_channels=8, enc_strides=(2, 2),
              renderer_type=renderer_type, render_n_steps=3)
    return (j_dito.DiToConfig(**kw, renderer=j_dit.DiTConfig(**DIT),
                              unet=JUNetCfg(dims=1, **UNET),
                              fm=j_fm.FMConfig(use_immiscible=immiscible)),
            t_dito.DiToConfig(**kw, renderer=t_dit.DiTConfig(**DIT),
                              unet=TUNetCfg(dims=1, **UNET),
                              fm=t_fm.FMConfig(use_immiscible=immiscible)))


def audio(rng, b=2, n=AUDIO_LEN):
    return (0.3 * rng.standard_normal((b, n, 1))).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _dito(renderer_type, seed=3):
    jcfg, pcfg = dito_cfgs(renderer_type)
    model = j_dito.DiToAudio(jcfg)
    x = jnp.zeros((1, AUDIO_LEN, 1))
    variables = random_variables(functools.partial(
        model.init, jax.random.PRNGKey(0), x, jax.random.PRNGKey(1), 0.1,
        method=j_dito.DiToAudio.loss), seed=seed)
    return model, variables, pcfg


def dito_pair(renderer_type="dit"):
    """(JAX model, its variables, the port's model holding them)."""
    model, variables, pcfg = _dito(renderer_type)
    port = t_io.load_flax_params(t_dito.DiToAudio(pcfg, AUDIO_LEN),
                                 variables)
    return model, variables, port


# --- fm ----------------------------------------------------------------------

def test_fm_schedule_and_time_steps_match_jax():
    cfg = t_fm.FMConfig()
    t = np.linspace(0, 1, 7, dtype=np.float32)
    np.testing.assert_array_equal(
        np_(t_fm.sigma(T(t), cfg)),
        np.asarray(j_fm.sigma(jnp.asarray(t), j_fm.FMConfig())))
    for n in (1, 3, 18, 50):
        np.testing.assert_array_equal(
            t_fm.time_steps(n), np.asarray(jnp.linspace(1.0, 0.0, n + 1)))


@pytest.mark.parametrize("immiscible", [True, False])
def test_fm_loss_and_euler_match_jax(rng, immiscible):
    """fm_loss with JAX's draws (the nearest of 4 candidates or plain
    noise) within 1e-5 relative; euler_sample of a linear net with CFG
    within 1e-4 of the peak from JAX's start noise."""
    jcfg = j_fm.FMConfig(use_immiscible=immiscible)
    pcfg = t_fm.FMConfig(use_immiscible=immiscible)
    x = rng.standard_normal((3, 10, 2)).astype(np.float32)
    w = rng.standard_normal((2, 2)).astype(np.float32)

    def j_net(x_t, t, bias=0.0):
        return x_t @ w * (1 + t[:, None, None]) + bias

    def p_net(x_t, t, bias=0.0):
        return x_t @ T(w) * (1 + t[:, None, None]) + bias

    key = jax.random.PRNGKey(SEED)
    ref = j_fm.fm_loss(j_net, key, jnp.asarray(x), jcfg)
    ours = t_fm.fm_loss(p_net, T(x), pcfg, jax_fm_draws(key, x.shape, jcfg))
    rel_close(ours, ref)

    noise = jax.random.normal(jax.random.PRNGKey(5), x.shape)
    kw = dict(net_kwargs={"bias": 0.5}, uncond_net_kwargs={"bias": -0.2},
              guidance=2.0)
    ref = j_fm.euler_sample(j_net, x.shape, 5, jcfg, noise=noise, **kw)
    ours = t_fm.euler_sample(p_net, T(np.asarray(noise)), 5, pcfg, **kw)
    _peak_close(np_(ours), ref)


# --- DiT ---------------------------------------------------------------------

@pytest.mark.parametrize("z_frames", [4, 16, 0])
def test_dit1d_matches_jax(rng, z_frames):
    """DiT1D with token-aligned z (each z token repeated 4 times, or one
    per token) and unconditional, within 1e-4 of the peak; a longer input
    than the position table raises (JAX fails on the broadcast)."""
    cfg = dict(DIT, cond_dim=4 if z_frames else 0)
    jm = j_dit.DiT1D(j_dit.DiTConfig(**cfg))
    x = rng.standard_normal((2, 64, 1)).astype(np.float32)
    t = rng.uniform(size=2).astype(np.float32)
    z = rng.standard_normal((2, max(z_frames, 1), 4)).astype(np.float32)
    zz = z if z_frames else None
    v = random_variables(functools.partial(jm.init, jax.random.PRNGKey(0),
                                           x, t, zz), seed=1)
    pm = t_io.load_flax_params(t_dit.DiT1D(t_dit.DiTConfig(**cfg), 16), v)
    with torch.no_grad():
        _peak_close(np_(pm(T(x), T(t), None if zz is None else T(zz))),
                    jm.apply(v, x, t, zz))
        with pytest.raises(ValueError, match="position table"):
            pm(T(np.zeros((1, 68, 1), np.float32)), T(t[:1]))


def test_dit2d_matches_jax(rng):
    """DiT2D with a latent-grid condition (spatially averaged) and with
    a vector (the class embedding's path), within 1e-4 of the peak."""
    cfg = dict(DIT, in_channels=3, out_channels=3)
    jm = j_dit.DiT2D(j_dit.DiTConfig(**cfg))
    x = rng.standard_normal((2, 16, 8, 3)).astype(np.float32)
    t = rng.uniform(size=2).astype(np.float32)
    for z in (rng.standard_normal((2, 2, 1, 4)).astype(np.float32),
              rng.standard_normal((2, 4)).astype(np.float32)):
        v = random_variables(functools.partial(
            jm.init, jax.random.PRNGKey(0), x, t, z), seed=2)
        pm = t_io.load_flax_params(
            t_dit.DiT2D(t_dit.DiTConfig(**cfg), hw=(16, 8)), v)
        with torch.no_grad():
            _peak_close(np_(pm(T(x), T(t), T(z))), jm.apply(v, x, t, z))


# --- DiTo --------------------------------------------------------------------

@pytest.mark.parametrize("renderer", ["dit", "unet"])
def test_dito_encode_render_loss_and_grads_match_jax(rng, renderer):
    """The encoder (even kernels, flax's SAME) within 1e-5 of its peak,
    the renderer within 1e-4, the FM + KL loss with zaug within 1e-5
    relative on JAX's draws, and with the DiT renderer every leaf's
    gradient (the UNet's gradients: the 2-D renderer's, in
    test_torch_flowae_image.py, whose JAX side compiles once)."""
    model, variables, port = dito_pair(renderer)
    x = audio(rng)
    z_ref, mu_ref, lv_ref = model.apply(variables, x,
                                        method=j_dito.DiToAudio.encode)
    with torch.no_grad():
        _, mu, lv = port.encode(T(x))
    _peak_close(np_(mu), mu_ref, 1e-5)
    _peak_close(np_(lv), lv_ref, 1e-5)
    if renderer == "dit":  # the UNet's forward: the loss below and
        # test_torch_flowae_image.py's test of the 1-D UNet
        t = np.array([0.3, 0.8], np.float32)
        x_t = rng.standard_normal(x.shape).astype(np.float32)
        ref = model.apply(variables, x_t, t, mu_ref,
                          method=j_dito.DiToAudio.render_net)
        with torch.no_grad():
            _peak_close(np_(port.render_net(T(x_t), T(t), mu)), ref)

    zaug_p = 0.5
    key = mixed_drop_key(x.shape[0], zaug_p)

    def j_loss(params):
        rec, kl, _ = model.apply({"params": params}, x, key, zaug_p,
                                 method=j_dito.DiToAudio.loss)
        return rec + 1e-2 * kl, (rec, kl)

    draws = jax_dito_draws(key, x.shape, mu_ref.shape, port.cfg, zaug_p)
    rec, kl, _ = port.loss(T(x), draws, zaug_p)
    if renderer == "unet":
        _, (jrec, jkl) = jax.jit(j_loss)(variables["params"])
    else:
        (_, (jrec, jkl)), jg = jax.jit(jax.value_and_grad(
            j_loss, has_aux=True))(variables["params"])
        assert_grads_close(port, port_grads(port, rec + 1e-2 * kl), jg)
    rel_close(rec.detach(), jrec)
    rel_close(kl.detach(), jkl)


@pytest.mark.parametrize("guidance", [1.0, 2.0])
def test_dito_decode_matches_jax(rng, guidance):
    """dito_decode with and without renderer CFG (the drop-z embedding as
    the unconditional branch), within 1e-4 of the peak from JAX's start
    noise; eval_reconstruction's MSE and SNR from the same noise."""
    model, variables, port = dito_pair("dit")
    x = audio(rng)
    _, mu, _ = model.apply(variables, x, method=j_dito.DiToAudio.encode)
    key = jax.random.PRNGKey(SEED)
    ref = j_dito.dito_decode(model, variables, mu, x.shape[1], key,
                             guidance=guidance)
    noise = T(np.asarray(jax.random.normal(key, x.shape)))
    ours = t_dito.dito_decode(port, T(np.asarray(mu)), x.shape[1], noise,
                              guidance=guidance)
    _peak_close(np_(ours), ref)
    jm = j_tr.eval_reconstruction(model, variables, jnp.asarray(x), key)
    pm = t_tr.eval_reconstruction(port, T(x), noise)
    for k in jm:
        rel_close(pm[k], jm[k], 1e-4)


@pytest.mark.parametrize("bf16", [False, True])
def test_dito_step_matches_jax(rng, bf16):
    """make_dito_step: loss, rec, kl, grad_norm and every leaf's gradient
    against JAX's step on the same draws, and the EMA after the update
    against j_tr.ema_update of the same parameters. bf16 rounds the audio
    to bfloat16 and computes in float32, so it is held against JAX's
    float32 step on the rounded audio (JAX's own bf16=True step raises in
    safe_conv.SlicedConv on the bf16 input and float32 kernel)."""
    model, variables, port = dito_pair("dit")
    x = audio(rng, b=4)
    xr = T(x).to(torch.bfloat16).float().numpy() if bf16 else x
    key = mixed_drop_key(4, 0.5)
    jstep = j_tr.make_dito_step(model, kl_weight=1e-2, zaug_p=0.5,
                                ema_decay=0.9, bf16=False)
    jstate, _, jm = jax.jit(jstep)(capture(variables["params"]),
                                   variables["params"],
                                   {"audio": jnp.asarray(xr)}, key)
    captured = []
    orig = t_tr.backward_and_update
    pstate = t_steps.make_train_state(
        port, t_sched.make_optimizer(lr=1e-3, warmup_steps=0))
    ema = t_tr.ema_init(port)
    step = t_tr.make_dito_step(port, kl_weight=1e-2, zaug_p=0.5,
                               ema_decay=0.9, bf16=bf16, device="cpu")
    _, mu, _ = model.apply(variables, xr, method=j_dito.DiToAudio.encode)
    draws = jax_dito_draws(key, x.shape, mu.shape, port.cfg, 0.5)
    t_tr.backward_and_update = lambda s, loss: captured.append(
        orig(s, loss)) or captured[-1]
    try:
        pstate, ema, pm = step(pstate, ema, {"audio": T(x)}, draws)
    finally:
        t_tr.backward_and_update = orig
    for k in ("loss", "rec", "kl"):
        rel_close(pm[k], jm[k])
    rel_close(pm["grad_norm"], jm["grad_norm"], 1e-4)
    assert pstate.step == 1 and int(jstate.step) == 1
    assert_grads_close(port, captured[0], jstate.params)
    ref_ema = j_tr.ema_update(variables["params"],
                              t_io.to_flax_params(port)["params"], 0.9)
    ours = t_io._flatten(t_io.to_flax_params(t_tr.with_params(port, ema))
                         ["params"])
    for path, a in t_io._flatten(ref_ema).items():
        np.testing.assert_allclose(ours[path], np.asarray(a), rtol=1e-6,
                                   atol=1e-7)


def test_step_builders_refuse_the_cpu_unless_asked():
    """Every step builder (the six of flowae) defaults to cuda and raises
    without a GPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    _, _, port = dito_pair("dit")
    zcfg = t_zdm.ZDMConfig(z_dim=4, net=t_dit.DiTConfig(
        hidden=16, depth=1, num_heads=2, patch=1, in_channels=4,
        out_channels=4))
    g = t_glp.GLPToAudio(t_glp.GLPToConfig(z_dim=4, enc_channels=8,
                                           enc_strides=(4, 4)))
    from minimax_speech_torch.flowae import image as t_img
    from minimax_speech_torch.flowae import vqgan as t_vq
    icfg = t_img.DiToImageConfig(renderer_type="dit")
    ae = t_img.DiToImage(icfg, (16, 16))
    vq = t_vq.VQGAN(t_vq.VQGANConfig(ch=8, ch_mult=(1,)))
    for build in (lambda: t_tr.make_dito_step(port),
                  lambda: t_zdm.make_zdm_step(t_zdm.ZDMNet(zcfg, 16), port),
                  lambda: t_glp.make_glpto_steps(g, t_disc.MSD(),
                                                 g.cfg),
                  lambda: t_img.make_dito_image_step(ae),
                  lambda: t_img.make_image_zdm_step(t_img.ImageZDMNet(
                      t_img.ImageZDMConfig(), (2, 2)), ae),
                  lambda: t_vq.make_vqgan_steps(
                      vq, t_vq.NLayerDiscriminator(8, 1))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()


# --- ZDM ---------------------------------------------------------------------

ZNET = dict(hidden=32, depth=2, num_heads=4, patch=1, in_channels=4,
            out_channels=4, cond_dim=0)


@functools.lru_cache(maxsize=None)
def _zdm():
    jcfg = j_zdm.ZDMConfig(z_dim=4, net=j_dit.DiTConfig(**ZNET), n_steps=3)
    model = j_zdm.ZDMNet(jcfg)
    v = random_variables(functools.partial(
        model.init, jax.random.PRNGKey(0), jnp.zeros((1, 16, 4)),
        jnp.zeros((1,))), seed=5)
    return model, v


def zdm_pair():
    model, v = _zdm()
    pcfg = t_zdm.ZDMConfig(z_dim=4, net=t_dit.DiTConfig(**ZNET), n_steps=3)
    return model, v, t_io.load_flax_params(t_zdm.ZDMNet(pcfg, 16), v)


def test_normalize_latents_and_zaug_match_jax(rng):
    """normalize_latents (population variance) within 1e-5 of the peak;
    zaug with JAX's t, candidates and mask within 1e-5."""
    z = (3 * rng.standard_normal((3, 8, 4)) + 1).astype(np.float32)
    ref = j_zdm.normalize_latents(jnp.asarray(z))
    _peak_close(np_(t_zdm.normalize_latents(T(z))), ref, 1e-5)
    cfg = j_zdm.ZDMConfig(zaug_p=0.5, zaug_tmax=0.7)
    key = jax.random.PRNGKey(SEED)
    ref = j_zdm.zaug(key, jnp.asarray(z), cfg)
    k_t, k_n, k_m = jax.random.split(key, 3)
    t = T(jax.random.uniform(k_t, (3,)))
    cand = T(jax.random.normal(k_n, (3, cfg.fm.k_candidates) + z.shape[1:]))
    mask = T(jax.random.bernoulli(k_m, 0.5, (3, 1, 1))).reshape(-1)
    ours = t_zdm.zaug(T(z), t_zdm.ZDMConfig(zaug_p=0.5, zaug_tmax=0.7),
                      t, cand, mask)
    _peak_close(np_(ours), ref, 1e-5)


def test_zdm_step_generate_and_eval_match_jax(rng):
    """make_zdm_step over the frozen DiTo: loss, grad norm and every
    leaf's gradient; zdm_generate (prior then renderer) within 1e-4 of
    the peak from JAX's two start noises; eval_zdm's loss and sample
    moments."""
    ae, ae_vars, ae_port = dito_pair("dit")
    model, v, port = zdm_pair()
    x = audio(rng, b=3)
    key = jax.random.PRNGKey(SEED + 2)
    jstep = j_zdm.make_zdm_step(model, ae, ae_vars, ema_decay=0.5)
    jstate, _, jm = jax.jit(jstep)(capture(v["params"]), v["params"],
                                   {"audio": jnp.asarray(x)}, key)
    k_enc, k_fm = jax.random.split(key)
    draws = jax_fm_draws(k_fm, (3, 16, 4), model.cfg.fm)
    captured = []
    orig = t_zdm.backward_and_update
    t_zdm.backward_and_update = lambda s, loss: captured.append(
        orig(s, loss)) or captured[-1]
    try:
        state = t_steps.make_train_state(
            port, t_sched.make_optimizer(lr=1e-3, warmup_steps=0))
        step = t_zdm.make_zdm_step(port, ae_port, ema_decay=0.5,
                                   device="cpu")
        _, _, pm = step(state, t_tr.ema_init(port), {"audio": T(x)}, draws)
    finally:
        t_zdm.backward_and_update = orig
    rel_close(pm["zdm/loss"], jm["zdm/loss"])
    rel_close(pm["zdm/grad_norm"], jm["zdm/grad_norm"], 1e-4)
    assert_grads_close(port, captured[0], jstate.params)

    _, _, port = zdm_pair()  # the step moved the first one's weights
    ref = j_zdm.zdm_generate(model, v, ae, ae_vars, 2, 16, AUDIO_LEN, key,
                             render_steps=2)
    k_z, k_dec = jax.random.split(key)
    noise = (T(np.asarray(jax.random.normal(k_z, (2, 16, 4)))),
             T(np.asarray(jax.random.normal(k_dec, (2, AUDIO_LEN, 1)))))
    ours = t_zdm.zdm_generate(port, ae_port, 2, 16, AUDIO_LEN, noise,
                              render_steps=2)
    _peak_close(np_(ours), ref)

    jm = j_zdm.eval_zdm(model, v, ae, ae_vars, jnp.asarray(x), key)
    k_enc, k_fm, k_gen = jax.random.split(key, 3)
    pm = t_zdm.eval_zdm(port, ae_port, T(x),
                        jax_fm_draws(k_fm, (3, 16, 4), model.cfg.fm),
                        T(np.asarray(jax.random.normal(k_gen, (3, 16, 4)))))
    for k in jm:
        rel_close(pm[k], jm[k], 1e-4)


# --- GLPTo -------------------------------------------------------------------

@pytest.mark.parametrize("perceptual", [1.0, 0.0])
def test_glpto_steps_match_jax(rng, perceptual):
    """GLPTo against the MSD, on JAX's eps: the forward (the encoder
    within 1e-5, the transposed-conv decoder within 1e-4 of the peak);
    the generator step's nll, kl and adversarial loss within 1e-5
    relative. Its adaptive weight (two gradient norms over every
    generator leaf), its total and every leaf's gradient of the total
    are held within 1e-4 without the perceptual term: the STFT
    log-magnitude term's input gradient, 2 / (|S| ln 10) per bin, carries
    float32 rounding of the smallest magnitudes (up to a few 1e-4 of its
    largest element, test_stft_loss_on_clips_shorter_than_the_window),
    so with it the weight and total are held within 1e-3.
    The discriminator step's loss within 1e-5 and its gradients."""
    jcfg = j_glp.GLPToConfig(z_dim=4, enc_channels=8, enc_strides=(4, 4),
                             perceptual_weight=perceptual)
    pcfg = t_glp.GLPToConfig(z_dim=4, enc_channels=8, enc_strides=(4, 4),
                             perceptual_weight=perceptual)
    model, disc = j_glp.GLPToAudio(jcfg), j_disc.MSD(rate=1)
    x = audio(rng, b=2, n=1024)
    gv = random_variables(functools.partial(
        model.init, jax.random.PRNGKey(0), x), seed=7)
    dv = random_variables(functools.partial(
        disc.init, jax.random.PRNGKey(1), x[..., 0]), seed=8)
    port = t_io.load_flax_params(t_glp.GLPToAudio(pcfg), gv)
    pdisc = t_io.load_flax_params(t_disc.MSD(rate=1), dv)
    key = jax.random.PRNGKey(SEED + 3)
    ref, mu, _ = model.apply(gv, x, key)
    eps = T(jax.random.normal(key, mu.shape))
    with torch.no_grad():
        ours, pmu, _ = port(T(x), eps)
    _peak_close(np_(pmu), mu, 1e-5)
    _peak_close(np_(ours), ref)

    jgen, jdisc = j_glp.make_glpto_steps(model, disc, jcfg)
    jg_state, jgm = jax.jit(jgen)(capture(gv["params"]), dv["params"],
                                  {"audio": jnp.asarray(x)}, key)
    captured = []
    orig = t_glp.backward_and_update
    t_glp.backward_and_update = lambda s, loss: captured.append(
        orig(s, loss)) or captured[-1]
    try:
        opt = t_sched.make_optimizer(lr=1e-4, warmup_steps=0)
        pgen, pdisc_step = t_glp.make_glpto_steps(port, pdisc, pcfg,
                                                  device="cpu")
        _, pgm = pgen(t_steps.make_train_state(port, opt), {"audio": T(x)},
                      eps)
        if perceptual:
            # the generator step moved port's weights: a fresh copy
            port.load_state_dict(t_io.load_flax_params(
                t_glp.GLPToAudio(pcfg), gv).state_dict())
            _, pdm = pdisc_step(t_steps.make_train_state(pdisc, opt),
                                {"audio": T(x)}, eps)
    finally:
        t_glp.backward_and_update = orig
    for k in ("nll", "kl", "g_adv"):
        rel_close(pgm[f"gen/{k}"], jgm[f"gen/{k}"])
    tol = 1e-3 if perceptual else 1e-4
    rel_close(pgm["gen/adaptive_w"], jgm["gen/adaptive_w"], tol)
    rel_close(pgm["gen/loss"], jgm["gen/loss"], tol)
    if perceptual:
        jd_state, jdm = jax.jit(jdisc)(capture(dv["params"]), gv["params"],
                                       {"audio": jnp.asarray(x)}, key)
        rel_close(pdm["disc/loss"], jdm["disc/loss"])
        assert_grads_close(pdisc, captured[1], jd_state.params,
                           min_checked=5)
    else:
        assert_grads_close(port, captured[0], jg_state.params)


# --- evaluate ----------------------------------------------------------------

@pytest.mark.parametrize("n_fft,hop", [(1024, 256), (256, 64)])
def test_power_spectrogram_and_metrics_match_jax(rng, n_fft, hop):
    """power_spectrogram within 1e-5 of its peak; batch_audio_metrics'
    L1, SNR and spectral convergence within 1e-5 relative."""
    ref = audio(rng, b=2, n=3000)[..., 0]
    rec = ref + 0.05 * rng.standard_normal(ref.shape).astype(np.float32)
    _peak_close(np_(t_ev.power_spectrogram(T(ref), n_fft, hop)),
                j_ev.power_spectrogram(jnp.asarray(ref), n_fft, hop), 1e-5)
    jm = j_ev.batch_audio_metrics(jnp.asarray(ref), jnp.asarray(rec))
    pm = t_ev.batch_audio_metrics(T(ref), T(rec))
    for k in jm:
        rel_close(pm[k], jm[k])


@pytest.mark.parametrize("n", [256, 100, 1024])
def test_stft_loss_on_clips_shorter_than_the_window(rng, n):
    """multi_scale_stft_loss at GLPTo's windows (512, 128) on clips
    shorter than half a window: the reflect pad wraps again, as jnp.pad
    does (torch's F.pad refuses pads past the length), the loss within
    1e-5 relative; its input gradient within 1e-3 of its largest: the
    log-magnitude term's 2 / (|S| ln 10) per bin magnifies float32
    rounding of the smallest magnitudes to a few 1e-4."""
    from minimax_speech_torch.utils import audio_losses as t_al
    x, y = audio(rng, b=2, n=n)[..., 0], audio(rng, b=2, n=n)[..., 0]
    ref, jg = jax.jit(jax.value_and_grad(lambda a, b: j_al.
                      multi_scale_stft_loss(a, b, (512, 128))))(
        jnp.asarray(x), jnp.asarray(y))
    xt = T(x).requires_grad_()
    ours = t_al.multi_scale_stft_loss(xt, T(y), (512, 128))
    rel_close(ours.detach(), ref)
    _peak_close(np_(torch.autograd.grad(ours, xt)[0]), jg, 1e-3)


def test_eval_suites_write_what_jax_writes(rng, tmp_path):
    """evaluate_audio_ae / evaluate_audio_zdm and both visualize passes
    write the files JAX's write (cache/audio_{gt,gen}/<i>.wav,
    audio_samples/<name>_step_<s>.wav and _spec.png), the ground-truth
    wavs byte for byte; the AE eval's metrics equal batch_audio_metrics
    of a decode from the generator's draw; Averager weights by count."""
    ae, ae_vars, ae_port = dito_pair("dit")
    model, v, port = zdm_pair()
    batches = [audio(rng, b=3), audio(rng, b=2)]
    runs = {}
    for pkg in ("jax", "port"):
        d = tmp_path / pkg
        if pkg == "jax":
            key = jax.random.PRNGKey(0)
            m = j_ev.evaluate_audio_ae(ae, ae_vars, batches, key,
                                       n_steps=2, save_dir=str(d))
            j_ev.evaluate_audio_zdm(model, v, ae, ae_vars, batches[:1], key,
                                    save_dir=str(d / "z"))
            j_ev.visualize_audio_ae_random(ae, ae_vars, np.concatenate(
                batches), key, str(d), 5, n_samples=2, n_steps=2)
            j_ev.visualize_audio_zdm_random(model, v, ae, ae_vars,
                                            AUDIO_LEN, key, str(d), 5,
                                            n_samples=2)
        else:
            gen = torch.Generator().manual_seed(0)
            m = t_ev.evaluate_audio_ae(ae_port, batches, gen, n_steps=2,
                                       save_dir=str(d))
            t_ev.evaluate_audio_zdm(port, ae_port, batches[:1], gen,
                                    save_dir=str(d / "z"))
            t_ev.visualize_audio_ae_random(ae_port, np.concatenate(batches),
                                           gen, str(d), 5, n_samples=2,
                                           n_steps=2)
            t_ev.visualize_audio_zdm_random(port, ae_port, AUDIO_LEN, gen,
                                            str(d), 5, n_samples=2)
        runs[pkg] = (m, d)
    (jm, jd), (pm, pd) = runs["jax"], runs["port"]
    assert set(pm) == set(jm)
    def layout(d):  # the random clip indices of the AE's visuals masked
        return sorted(re.sub(r"(original|recons)_\d+", r"\1_i",
                             str(p.relative_to(d))) for p in d.rglob("*")
                      if p.is_file())

    assert layout(jd) == layout(pd)
    for p in (jd / "cache").rglob("*.wav"):
        if "audio_gt" in str(p):
            assert p.read_bytes() == (pd / p.relative_to(jd)).read_bytes()
    assert len(list((pd / "audio_samples").glob("audio_zdm_gen*.wav"))) == 2

    gen = torch.Generator().manual_seed(0)
    avg = {k: t_ev.Averager() for k in ("L1_Loss", "SNR",
                                        "Spectral_Convergence")}
    with torch.no_grad():
        for b in batches:
            _, mu, _ = ae_port.encode(T(b))
            rec = t_dito.dito_decode(ae_port, mu, b.shape[1], generator=gen,
                                     n_steps=2)
            for k, val in t_ev.batch_audio_metrics(T(b[..., 0]),
                                                   rec[..., 0]).items():
                avg[k].add(float(val), n=b.shape[0])
    for k, a in avg.items():
        assert pm[f"eval_ae/{k}"] == pytest.approx(a.item(), rel=1e-6)
    a = t_ev.Averager()
    a.add(1.0, 3)
    a.add(4.0, 1)
    assert a.item() == pytest.approx(1.75)
