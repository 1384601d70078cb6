"""Flow stack of the port against the JAX package: conformer encoder,
UNet estimator (the port's attention is K1's plain version on the CPU,
the JAX UNet takes its XLA branch at these shapes) and
flow_inference_batched on the fixed noise table.

CPU, float32, tiny geometry of tests/test_pipeline.py with jittered
JAX-initialized weights; two rows with ragged lengths. Tolerances are
float32 sums in other orders, amplified by depth: 1e-4 for one
estimator or encoder call, 5e-4 after the Euler solve.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minimax_speech_torch.models import flow as t_flow
from minimax_speech_torch.models import conformer as t_cf
from minimax_speech_torch.utils import params_io as t_io
from minimax_speech_tpu.models import cfm as j_cfm
from minimax_speech_tpu.models import conformer as j_cf
from minimax_speech_tpu.models import flow as j_flow
from tests.test_torch_bridge import jitter, tiny_port_cfg
from tests import torch_cpu

torch_cpu.share_cores()

TOK_LENS = np.array([9, 6], np.int32)


@pytest.fixture(scope="module")
def flow():
    jcfg, pcfg = tiny_port_cfg()
    model = j_flow.FlowModel(jcfg.flow)
    init = jax.jit(j_flow.init_flow_variables, static_argnums=0)
    variables = jitter(init(model, jax.random.PRNGKey(2)), seed=2)
    port = t_io.load_flax_params(t_flow.FlowModel(pcfg.flow).eval(),
                                 variables)
    return model, variables, port


def _tokens(rng):
    tok = rng.integers(0, 6561, (2, 9)).astype(np.int32)
    tok[1, 6:] = 0
    return tok


def test_rel_pos_emb_and_shift_identical(rng):
    np.testing.assert_array_equal(
        t_cf.espnet_rel_pos_emb(7, 16).numpy(),
        np.asarray(j_cf.espnet_rel_pos_emb(7, 16)))
    x = rng.standard_normal((2, 3, 5, 9)).astype(np.float32)
    np.testing.assert_array_equal(t_cf.rel_shift(torch.as_tensor(x)).numpy(),
                                  np.asarray(j_cf._rel_shift(jnp.asarray(x))))


def test_encoder_matches(flow, rng):
    model, variables, port = flow
    tok = _tokens(rng)
    mu_j, len_j = model.apply(variables, jnp.asarray(tok),
                              jnp.asarray(TOK_LENS),
                              method=j_flow.FlowModel.encode_tokens)
    with torch.no_grad():
        mu_t, len_t = port.encode_tokens(torch.as_tensor(tok).long(),
                                         torch.as_tensor(TOK_LENS).long())
    np.testing.assert_array_equal(len_t.numpy(), np.asarray(len_j))
    for i, n in enumerate(2 * TOK_LENS):
        np.testing.assert_allclose(mu_t.numpy()[i, :n],
                                   np.asarray(mu_j)[i, :n], atol=1e-4,
                                   rtol=1e-4)


def test_unet_matches_xla_branch(flow, rng):
    """The port's UNet (attention through K1's plain version) against the
    JAX UNet, which takes its XLA attention at T=18 (auto rule)."""
    model, variables, port = flow
    t = 18
    x, mu, cond = (rng.standard_normal((2, t, 80)).astype(np.float32)
                   for _ in range(3))
    mask = (np.arange(t)[None] < np.array([[18], [11]])).astype(np.float32)
    tt = np.array([0.3, 0.8], np.float32)
    spks = rng.standard_normal((2, 80)).astype(np.float32)
    args = (x, mask, mu, tt, spks, cond)
    ref = np.asarray(model.apply(variables, *map(jnp.asarray, args),
                                 method=j_flow.FlowModel.estimate))
    with torch.no_grad():
        ours = port.estimate(*map(torch.as_tensor, args)).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=1e-4)


def test_flow_inference_batched_matches(flow, rng):
    model, variables, port = flow
    tok = _tokens(rng)
    pfl = np.array([5, 3], np.int32)
    pf = rng.standard_normal((2, 6, 80)).astype(np.float32)
    emb = rng.standard_normal((2, 12)).astype(np.float32)
    noise = j_cfm.make_fixed_noise(64, 80)[None]
    ref = np.asarray(j_flow.flow_inference_batched(
        model, variables, jnp.asarray(tok), jnp.asarray(TOK_LENS),
        jnp.asarray(pf), jnp.asarray(pfl), jnp.asarray(emb),
        jnp.asarray(noise)))
    ours = t_flow.flow_inference_batched(
        port, tok, TOK_LENS, pf, pfl, torch.as_tensor(emb), noise,
        device="cpu").numpy()
    assert ours.shape == ref.shape == (2, 18, 80)
    for i, n in enumerate(2 * TOK_LENS):
        np.testing.assert_allclose(ours[i, :n], ref[i, :n], atol=5e-4,
                                   rtol=5e-4)


def test_fixed_noise_identical():
    from minimax_speech_torch.models import cfm as t_cfm
    np.testing.assert_array_equal(t_cfm.make_fixed_noise(100, 80),
                                  j_cfm.make_fixed_noise(100, 80))
    ts_t, dts_t = t_cfm.euler_grid(10, t_cfm.CFMConfig())
    ts_j, dts_j = j_cfm._euler_grid(10, j_cfm.CFMConfig())
    # linspace/cos in float32: equal to within one float32 ulp of 1
    np.testing.assert_allclose(ts_t.numpy(), np.asarray(ts_j), atol=2.4e-7)
    np.testing.assert_allclose(dts_t.numpy(), np.asarray(dts_j), atol=2.4e-7)
