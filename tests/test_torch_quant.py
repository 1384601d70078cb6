"""W8A8 Qwen2 projections of the port (QuantDense) against the JAX package.

CPU. The int8 activations and the int32 accumulators must be identical
(an int32 matmul is exact on the CPU); the outputs equal in float32 and
within one bf16 ulp in bf16 (in practice identical: the same operations
on the same values). quantize_lm_params gives identical arrays; the
quantized tiny LM decodes the JAX token ids with the same noise tables;
int8 leaves keep their dtype through params_io both ways.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minimax_speech_torch.models import llm as t_llm
from minimax_speech_torch.models import qwen2 as t_qwen2
from minimax_speech_torch.utils import params_io as t_io
from minimax_speech_tpu.models import llm as j_llm
from minimax_speech_tpu.models import qwen2 as j_qwen2
from minimax_speech_tpu.utils import params_io as j_io
from tests.test_torch_bridge import jitter, tiny_port_cfg
from tests.test_torch_lm import jax_decode_noise
from tests import torch_cpu

torch_cpu.share_cores()

K_IN, N_OUT = 64, 48


def _dense_pair(rng, act_quant, bias=True):
    tree = {"kernel_q": rng.integers(-127, 128, (K_IN, N_OUT)).astype(np.int8),
            "scale": rng.uniform(0.005, 0.02, N_OUT).astype(np.float32)}
    if bias:
        tree["bias"] = rng.standard_normal(N_OUT).astype(np.float32)
    port = t_io.load_flax_params(
        t_qwen2.QuantDense(K_IN, N_OUT, bias, act_quant), {"params": tree})
    return j_qwen2.QuantDense(N_OUT, use_bias=bias, act_quant=act_quant), \
        tree, port


def _x(rng, dtype=np.float32):
    # rows of mixed scale, one all zero (the 1e-8 floor)
    x = rng.standard_normal((5, K_IN)) * np.array([[3.0], [0.01], [1.0],
                                                   [0.0], [40.0]])
    return x.astype(dtype)


def test_int8_activations_and_accumulators_identical(rng, monkeypatch):
    """The JAX layer's own int8 x int8 dot is recorded (the layer runs
    eagerly); the port's quantize_rows and int8_mm give the same int8
    operand and the same int32 sums."""
    model, tree, port = _dense_pair(rng, True)
    x = _x(rng)
    seen = []
    dot = jax.lax.dot_general

    def record(a, b, *args, **kw):
        out = dot(a, b, *args, **kw)
        seen.append((np.asarray(a), np.asarray(out)))
        return out

    monkeypatch.setattr(jax.lax, "dot_general", record)
    model.apply({"params": tree}, jnp.asarray(x))
    monkeypatch.undo()
    (xq_j, acc_j), = seen
    assert xq_j.dtype == np.int8 and acc_j.dtype == np.int32
    xq, _ = t_qwen2.quantize_rows(torch.as_tensor(x))
    np.testing.assert_array_equal(xq.numpy(), xq_j)
    acc = t_qwen2.int8_mm(xq, port.kernel_q)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), acc_j)


@pytest.mark.parametrize("act_quant", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_dense_matches(rng, act_quant, dtype):
    model, tree, port = _dense_pair(rng, act_quant)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    x = _x(rng)
    jtree = {k: (jnp.asarray(v, jdt) if v.dtype == np.float32 else v)
             for k, v in tree.items()}
    ref = np.asarray(model.apply({"params": jtree},
                                 jnp.asarray(x, jdt)).astype(jnp.float32))
    with torch.no_grad():
        ours = port.to(tdt)(torch.as_tensor(x).to(tdt)).float().numpy()
    if dtype == "float32":
        np.testing.assert_array_equal(ours, ref)
    else:  # one bf16 ulp: 2^(exponent - 7)
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
        assert (np.abs(ours - ref) <= ulp).all()


def test_quantize_lm_params_identical(rng):
    """On the flax tree, and through quantize_lm on a torch SpeechLM."""
    jcfg, pcfg = tiny_port_cfg()
    init = jax.jit(j_llm.init_lm_variables, static_argnums=0)
    variables = jitter(init(j_llm.SpeechLM(jcfg.lm), jax.random.PRNGKey(2)),
                       seed=2)
    ref = j_qwen2.quantize_lm_params(variables["params"])
    float_lm = t_io.load_flax_params(t_llm.SpeechLM(pcfg.lm), variables)
    quant_lm = t_llm.quantize_lm(float_lm)
    assert quant_lm.cfg.qwen.quantized and quant_lm.cfg.qwen.act_quant
    flat_r = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    for ours in (t_qwen2.quantize_lm_params(variables["params"]),
                 t_io.to_flax_params(quant_lm)["params"]):
        flat_o = dict(jax.tree_util.tree_flatten_with_path(ours)[0])
        assert flat_r.keys() == flat_o.keys()
        assert any("kernel_q" in str(k) for k in flat_r)
        for k in flat_r:
            a, b = np.asarray(flat_o[k]), np.asarray(flat_r[k])
            assert a.dtype == b.dtype, k
            np.testing.assert_array_equal(a, b, err_msg=str(k))


def _quant_cfgs():
    jcfg, pcfg = tiny_port_cfg()

    def q(lm):
        return dataclasses.replace(lm, qwen=dataclasses.replace(
            lm.qwen, quantized=True))
    return q(jcfg.lm), q(pcfg.lm)


@pytest.fixture(scope="module")
def quant_lm():
    """A float tiny LM, jittered, quantized by the JAX package's
    quantize_lm_params and loaded into both packages' quantized LM."""
    jcfg, _ = tiny_port_cfg()
    jq, pq = _quant_cfgs()
    init = jax.jit(j_llm.init_lm_variables, static_argnums=0)
    variables = jitter(init(j_llm.SpeechLM(jcfg.lm), jax.random.PRNGKey(3)),
                       seed=3)
    qvars = {"params": j_qwen2.quantize_lm_params(variables["params"])}
    qvars = jax.tree_util.tree_map(np.array, qvars)
    qvars["params"]["llm_decoder"]["bias"][123] += 12.0
    port = t_io.load_flax_params(t_llm.SpeechLM(pq).eval(), qvars)
    return j_llm.SpeechLM(jq), qvars, port


@pytest.mark.parametrize("min_len,max_len", [(3, 20), (12, 12)])
def test_quantized_generate_identical_tokens(quant_lm, rng, min_len, max_len):
    model, variables, port = quant_lm
    src, tok, plen = j_llm.build_inference_plan(
        rng.integers(0, 256, 6), rng.integers(0, 6561, 5), pad_to=16)
    spk = rng.standard_normal((1, 32)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    max_steps = 24
    out_j, cnt_j = j_llm.generate(
        model, variables, jnp.asarray(src), jnp.asarray(tok),
        jnp.asarray(plen), jnp.asarray(spk), key, jnp.array([min_len]),
        jnp.array([max_len]), max_steps=max_steps)
    g_top, g_fb = jax_decode_noise(key, port.cfg, max_steps, 1)
    out_t, cnt_t = t_llm.generate(
        port, src, tok, plen, torch.as_tensor(spk), [min_len], [max_len],
        max_steps=max_steps, gumbel_top=g_top, gumbel_fallback=g_fb,
        device="cpu")
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    n = int(cnt_j[0])
    assert min_len <= n <= max_len
    assert (np.asarray(out_j)[0, :n] == 123).sum() >= 2


def test_int8_leaves_round_trip(quant_lm, tmp_path):
    """flax tree -> port -> flax tree keeps int8 kernels int8 and equal;
    the port's .npz loads in the JAX package with int8 leaves."""
    _, variables, port = quant_lm
    back = t_io.to_flax_params(port)
    flat_a = dict(jax.tree_util.tree_flatten_with_path(variables)[0])
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert flat_a.keys() == flat_b.keys()
    n_int8 = 0
    for k in flat_a:
        a, b = np.asarray(flat_a[k]), flat_b[k]
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b)
        n_int8 += a.dtype == np.int8
    assert n_int8 == 2 * 7  # 2 layers x 7 projections
    path = str(tmp_path / "llm.npz")
    t_io.save_params(path, port)
    loaded = j_io.load_params(path)
    kq = loaded["params"]["llm"]["layers_0"]["mlp"]["down_proj"]["kernel_q"]
    assert kq.dtype == np.int8
    np.testing.assert_array_equal(
        kq, variables["params"]["llm"]["layers_0"]["mlp"]["down_proj"]
        ["kernel_q"])
    wrong = jax.tree_util.tree_map(np.array, variables)
    leaf = wrong["params"]["llm"]["layers_0"]["mlp"]["up_proj"]
    leaf["kernel_q"] = leaf["kernel_q"].astype(np.float32)
    with pytest.raises(ValueError, match="up_proj/kernel_q"):
        t_io.load_flax_params(port, wrong)


def test_random_int8_kernels_from_init():
    """init_params draws QuantDense kernels uniformly over [-127, 127]
    with unit scales, as bench.py gives the JAX package's LM; a seed
    fixes them."""
    _, pq = _quant_cfgs()
    a = t_io.init_params(t_llm.SpeechLM(pq), torch.Generator().manual_seed(1))
    b = t_io.init_params(t_llm.SpeechLM(pq), torch.Generator().manual_seed(1))
    w = a.llm.layers[0].mlp.up_proj
    assert isinstance(w, t_qwen2.QuantDense) and w.kernel_q.dtype == torch.int8
    assert int(w.kernel_q.min()) >= -127 and int(w.kernel_q.max()) == 127
    assert torch.equal(w.scale, torch.ones_like(w.scale))
    assert torch.equal(w.kernel_q, b.llm.layers[0].mlp.up_proj.kernel_q)
    with torch.no_grad():
        a.to(torch.bfloat16)
    assert w.kernel_q.dtype == torch.int8 and w.scale.dtype == torch.bfloat16
