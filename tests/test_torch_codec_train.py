"""DAC-VAE GAN training in the port against the JAX package, on the CPU:
the codec's init and posterior (models/dac_vae.py), one iteration of
train/gan_steps.make_dac_steps (the discriminator's step, then the
generator's) and the spectral schedule. tests/test_torch_hift_train.py
holds HiFT's iteration with these helpers.

Tiny geometries, weights from JAX's init loaded by both packages,
float32 on both sides; every iteration feeds the port the draws of one
JAX key, rebuilt as JAX draws them. JAX's gradients are read through a
TrainState whose apply_gradients keeps them as its params.

Tolerances: losses and metrics 1e-5 relative; each leaf's gradient
within 1e-4 of its largest element; parameters after one AdamW step
within 1e-6 where the gradient is pinned (at least 1e-4 of its leaf's
largest), within 2 lr elsewhere.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from minimax_speech_torch.models import dac_vae as t_dac
from minimax_speech_torch.models import discriminators as t_disc
from minimax_speech_torch.train import gan_steps as t_gan
from minimax_speech_torch.train import schedule as t_sched
from minimax_speech_torch.train import steps as t_steps
from minimax_speech_torch.utils import params_io as t_io
from minimax_speech_tpu.models import dac_vae as j_dac
from minimax_speech_tpu.models import discriminators as j_disc
from minimax_speech_tpu.train import gan_steps as j_gan
from minimax_speech_tpu.train import schedule as j_sched
from minimax_speech_tpu.train import steps as j_steps
from tests import torch_cpu

torch_cpu.share_cores()

DAC_KW = dict(encoder_dim=4, encoder_rates=(2, 5), latent_dim=6,
              decoder_dim=16, decoder_rates=(5, 2))
DAC_DISC = dict(periods=(2, 3), fft_sizes=(256,))
LR = 1e-3


class GradCapture(j_steps.TrainState):
    """A JAX TrainState whose update keeps the gradients as its params."""

    def apply_gradients(self, grads):
        return self.replace(step=self.step + 1, params=grads)


def capture(params, step=0):
    return GradCapture(step=jnp.asarray(step, jnp.int32), params=params,
                       opt_state=None, tx=None)


def jax_update(params, grads, **opt):
    """The parameters after JAX's first AdamW update from `grads` (jitted:
    optax's eager ops would compile one by one)."""
    tx = j_sched.make_optimizer(**opt)

    def update(p, g):
        upd, _ = tx.update(g, tx.init(p), p)
        return optax.apply_updates(p, upd)

    return jax.jit(update)(params, grads)


def torch_grads(monkeypatch):
    """{id(state): gradients} of every backward_and_update of gan_steps."""
    seen = {}
    orig = t_gan.steps.backward_and_update

    def spy(state, loss):
        seen[id(state)] = orig(state, loss)
        return seen[id(state)]

    monkeypatch.setattr(t_gan.steps, "backward_and_update", spy)
    return seen


def assert_grads_close(module, grads, ref_tree):
    """Each leaf within 1e-4 of its largest element (JAX's side)."""
    theirs = t_io._flatten(ref_tree)
    for (path, _, _, to_flax), g in zip(t_io._params_with_paths(module),
                                        grads):
        ref = np.asarray(theirs[path])
        err = float(np.abs(to_flax(g.numpy()) - ref).max())
        assert err <= 1e-4 * float(np.abs(ref).max()), ("/".join(path), err)
    assert len(theirs) == len(grads)


def assert_update_close(module, grads, ref_tree):
    """The parameters after the step: within 1e-6 of JAX's where the
    gradient is pinned, within 2 lr everywhere."""
    theirs = t_io._flatten(ref_tree)
    for (path, p, _, to_flax), g in zip(t_io._params_with_paths(module),
                                        grads):
        g = np.abs(to_flax(g.numpy()))
        d = np.abs(to_flax(p.detach().numpy()) - np.asarray(theirs[path]))
        pinned = g >= 1e-4 * g.max()
        assert (d[pinned] <= 1e-6).all(), ("/".join(path), d[pinned].max())
        assert (d <= 2 * LR).all(), "/".join(path)


def assert_metrics_close(ours: dict, ref: dict):
    """1e-5 relative, or 1e-8 absolute: gen/tpr, a mean of squared
    deviations from the median of the score differences, is ~1e-3 here
    and sums terms with cancellation in (d - median)."""
    assert ours.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(float(ours[k]), float(ref[k]), rtol=1e-5,
                                   atol=1e-8, err_msg=k)


# --- DAC-VAE ----------------------------------------------------------------

@pytest.fixture(scope="module")
def dac():
    """(JAX generator, discriminator, their variables, audio (2, 2400))."""
    gen = j_dac.DACVAE(j_dac.DACVAEConfig(**DAC_KW))
    disc = j_disc.DACDiscriminator(**DAC_DISC)
    rng = np.random.default_rng(0)
    audio = (rng.standard_normal((2, 2400)) * 0.3).astype(np.float32)
    gv = jax.jit(gen.init)(jax.random.PRNGKey(0), jnp.asarray(audio)[..., None])
    dv = jax.jit(disc.init)(jax.random.PRNGKey(1), jnp.asarray(audio))
    return gen, disc, gv, dv, audio


def _port_dac(gv, dv):
    g = t_io.load_flax_params(t_dac.DACVAE(t_dac.DACVAEConfig(**DAC_KW)), gv)
    d = t_io.load_flax_params(t_disc.DACDiscriminator(**DAC_DISC), dv)
    return g, d


def test_dac_init_logs_bias_minus_four(dac):
    """The port's random init, as JAX's init: en_conv_post's bias is 0 on
    the mu half and exactly -4 on the logs half."""
    _, _, gv, _, _ = dac
    port = t_io.init_params(t_dac.DACVAE(t_dac.DACVAEConfig(**DAC_KW)),
                            torch.Generator().manual_seed(0))
    ours = port.en_conv_post.bias.detach().numpy()
    ref = np.asarray(gv["params"]["en_conv_post"]["bias"])
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours, [0.0] * 6 + [-4.0] * 6)


def test_dac_encode_and_forward_match_jax(dac):
    """encode with JAX's eps: z, mu, logs within 1e-5 of their largest;
    z is mu without draws; the training forward's dict the same."""
    gen, _, gv, dv, audio = dac
    g, _ = _port_dac(gv, dv)
    key = jax.random.PRNGKey(5)
    x = jnp.asarray(audio)[..., None]
    ref = gen.apply(gv, x, key)
    eps = torch.as_tensor(np.array(jax.random.normal(key, (2, 240, 6))))
    with torch.no_grad():
        ours = g(torch.as_tensor(audio)[..., None], eps=eps)
        z0, mu0, _ = g.encode(torch.as_tensor(audio)[..., None])
    assert ours.keys() == ref.keys()
    for k in ref:
        r = np.asarray(ref[k])
        np.testing.assert_allclose(ours[k].numpy(), r, rtol=0,
                                   atol=1e-5 * np.abs(r).max(), err_msg=k)
    torch.testing.assert_close(z0, mu0, rtol=0, atol=0)
    assert float(ours["logs"].max()) <= 14.0


def test_dac_iteration_matches_jax(dac, monkeypatch):
    """One disc step then one gen step (default lambdas): every metric, both models' gradients and the
    parameters after each AdamW step, at the tolerances above. The
    generator's step sees the discriminator after its update, as the
    CLI runs them."""
    gen, disc, gv, dv, audio = dac
    opt = dict(lr=LR, warmup_steps=0, grad_clip=1e3, weight_decay=1e-3)
    key = jax.random.PRNGKey(3)
    batch = {"audio": jnp.asarray(audio)}
    jg, jd = j_gan.make_dac_steps(gen, disc)
    d_caught, dm = jax.jit(jd)(capture(dv["params"]), gv["params"], batch,
                               key)
    d_new = jax_update(dv["params"], d_caught.params, **opt)
    g_caught, gm = jax.jit(jg)(capture(gv["params"]), d_new, batch, key)
    g_new = jax_update(gv["params"], g_caught.params, **opt)

    g, d = _port_dac(gv, dv)
    seen = torch_grads(monkeypatch)
    g_state = t_steps.make_train_state(g, t_sched.make_optimizer(**opt))
    d_state = t_steps.make_train_state(d, t_sched.make_optimizer(**opt))
    tg, td = t_gan.make_dac_steps(g, d, device="cpu")
    eps = torch.as_tensor(np.array(jax.random.normal(key, (2, 240, 6))))
    tb = {"audio": torch.as_tensor(audio)}
    d_state, tdm = td(d_state, tb, eps)
    g_state, tgm = tg(g_state, tb, eps)
    assert g_state.step == d_state.step == 1
    assert_metrics_close({**tdm, **tgm}, {**dm, **gm})
    assert_grads_close(d, seen[id(d_state)], d_caught.params)
    assert_grads_close(g, seen[id(g_state)], g_caught.params)
    assert_update_close(d, seen[id(d_state)], d_new)
    assert_update_close(g, seen[id(g_state)], g_new)


def test_dac_spectral_schedule_and_gan_gate_match_jax(dac):
    """spectral delay 2 and warm-up 4, the GAN from step 5, the stft and
    waveform terms on: the generator's loss at steps 0 (no spectral
    terms, no GAN), 1, 3 and 5 (in the ramp), 9 (past it, GAN on) and
    20000 (KL beta 1) within 1e-5 relative; kl_beta and spectral_ramp at
    those steps as JAX computes them."""
    gen, disc, gv, dv, audio = dac
    sched = dict(gan_start_step=5, spectral_warmup_steps=4,
                 spectral_delay_steps=2)
    lam = dict(stft=1.0, waveform=1.0)
    key = jax.random.PRNGKey(4)
    jg, _ = j_gan.make_dac_steps(gen, disc, j_gan.DACLambdas(**lam), **sched)
    jg = jax.jit(jg)
    g, d = _port_dac(gv, dv)
    tg, _ = t_gan.make_dac_steps(g, d, t_gan.DACLambdas(**lam), device="cpu",
                                 **sched)
    eps = torch.as_tensor(np.array(jax.random.normal(key, (2, 240, 6))))
    for step in (0, 1, 3, 5, 9, 20000):
        assert t_gan.kl_beta(step) == pytest.approx(
            float(j_gan.kl_beta(jnp.asarray(step))), rel=1e-7)
        _, jm = jg(capture(gv["params"], step), dv["params"],
                   {"audio": jnp.asarray(audio)}, key)
        t_io.load_flax_params(g, gv)
        state = t_steps.make_train_state(g, t_sched.make_optimizer(lr=0.0))
        state.step = step
        _, tm = tg(state, {"audio": torch.as_tensor(audio)}, eps)
        np.testing.assert_allclose(float(tm["gen/loss"]),
                                   float(jm["gen/loss"]), rtol=1e-5,
                                   err_msg=str(step))
    assert [t_gan.spectral_ramp(s, 2, 4) for s in (0, 2, 3, 5, 6, 9)] == [
        0.0, 0.0, 0.25, 0.75, 1.0, 1.0]
    assert t_gan.spectral_ramp(0, 0, 0) == 1.0


def test_dac_steps_refuse_missing_card():
    """Without device="cpu" make_dac_steps asks for the card and raises."""
    g = t_dac.DACVAE(t_dac.DACVAEConfig(**DAC_KW))
    d = t_disc.DACDiscriminator(**DAC_DISC)
    with pytest.raises(RuntimeError, match="no CUDA"):
        t_gan.make_dac_steps(g, d)
