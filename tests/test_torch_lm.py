"""SpeechLM (Qwen2 backbone, plan embedding, RAS decode) against JAX.

CPU, float32, tiny geometry of tests/test_pipeline.py with jittered
JAX-initialized weights. Hidden states and logits agree to 1e-4
(float32 sums in other orders through 2 layers); decoded ids must be
identical when both packages get the same noise tables.
"""
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
from tests.test_torch_bridge import jitter, tiny_port_cfg
from tests import torch_cpu

torch_cpu.share_cores()


@pytest.fixture(scope="module")
def lm():
    jcfg, pcfg = tiny_port_cfg()
    model = j_llm.SpeechLM(jcfg.lm)
    init = jax.jit(j_llm.init_lm_variables, static_argnums=0)
    variables = jitter(init(model, jax.random.PRNGKey(1)), seed=1)
    port = t_io.load_flax_params(t_llm.SpeechLM(pcfg.lm).eval(), variables)
    return model, variables, port


def _plan(rng, n_text=6, n_speech=5, pad_to=16):
    return j_llm.build_inference_plan(
        rng.integers(0, 256, n_text), rng.integers(0, 6561, n_speech),
        pad_to=pad_to)


def test_inference_plan_identical(rng):
    text, speech = rng.integers(0, 256, 6), rng.integers(0, 6561, 5)
    for a, b in zip(j_llm.build_inference_plan(text, speech, pad_to=16),
                    t_llm.build_inference_plan(text, speech, pad_to=16)):
        np.testing.assert_array_equal(a, b)


def test_teacher_forced_hidden_and_logits(lm, rng):
    model, variables, port = lm
    src, tok, plen = _plan(rng)
    spk = rng.standard_normal((1, 32)).astype(np.float32)
    t = src.shape[1]
    pad = np.arange(t)[None] < plen[:, None]

    def jax_fwd(m, s, tk, sp, bias):
        emb = m.embed_plan(s, tk, sp)
        hidden, _ = m.llm(emb, jnp.arange(t)[None], bias)
        return emb, hidden, m.llm_decoder(hidden)

    emb_j, hid_j, logit_j = model.apply(
        variables, jnp.asarray(src), jnp.asarray(tok), jnp.asarray(spk),
        j_qwen2.causal_bias(jnp.asarray(pad)), method=jax_fwd)
    with torch.no_grad():
        emb_t = port.embed_plan(torch.as_tensor(src).long(),
                                torch.as_tensor(tok).long(),
                                torch.as_tensor(spk))
        hid_t = port.llm(emb_t, torch.arange(t)[None],
                         t_qwen2.causal_bias(torch.as_tensor(pad)))
        logit_t = port.llm_decoder(hid_t)
    n = int(plen[0])
    np.testing.assert_array_equal(emb_t.numpy(), np.asarray(emb_j))
    np.testing.assert_allclose(hid_t.numpy()[:, :n], np.asarray(hid_j)[:, :n],
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(logit_t.numpy()[:, :n],
                               np.asarray(logit_j)[:, :n], atol=1e-4,
                               rtol=1e-4)


def test_prefill_then_decode_equals_full_forward(lm, rng):
    """Prefill P tokens into the cache, then feed 4 more one step at a
    time: each step's logits equal the full causal forward's at that
    position (1e-5: the same sums, the cache only reorders nothing)."""
    _, _, port = lm
    p, extra = 7, 4
    emb = torch.as_tensor(rng.standard_normal((1, p + extra, 32)),
                          dtype=torch.float32)
    pos = torch.arange(p + extra)[None]
    with torch.no_grad():
        full = port.llm_decoder(port.llm(
            emb, pos, t_qwen2.causal_bias(torch.ones((1, p + extra),
                                                     dtype=torch.bool))))
        cache = t_qwen2.make_cache(port.cfg.qwen, 1, p + extra)
        pad = torch.ones((1, p), dtype=torch.bool)
        hidden = port.prefill(emb[:, :p], pad, pos[:, :p], cache)
        torch.testing.assert_close(port.llm_decoder(hidden), full[:, :p],
                                   atol=1e-5, rtol=1e-5)
        valid = torch.cat([pad, torch.zeros((1, extra), dtype=torch.bool)], 1)
        for s in range(extra):
            logits = port.decode_step(emb[:, p + s: p + s + 1],
                                      torch.tensor([p + s]), valid, cache,
                                      p + s)
            torch.testing.assert_close(logits, full[:, p + s], atol=1e-5,
                                       rtol=1e-5)


def jax_decode_noise(key, cfg, max_steps, b):
    """The noise JAX's generate draws: the nucleus table and, per step,
    the gumbel behind jax.random.categorical(fold_in(key, step))."""
    v = cfg.speech_token_size + 3
    g_top = jax.random.gumbel(jax.random.fold_in(key, t_llm.GUMBEL_FOLD),
                              (max_steps, b, cfg.top_k))
    g_fb = jnp.stack([jax.random.gumbel(jax.random.fold_in(key, s), (b, v))
                      for s in range(max_steps)])
    return np.array(g_top), np.array(g_fb)


@pytest.mark.parametrize("min_len,max_len", [(3, 20), (12, 12)])
def test_generate_identical_tokens(lm, rng, min_len, max_len):
    """A boost on one speech id makes the nucleus pick it often, so it
    repeats within the RAS window and the fallback draw decides steps."""
    model, variables, port = lm
    variables = jax.tree_util.tree_map(np.array, variables)
    variables["params"]["llm_decoder"]["bias"][123] += 12.0
    port = t_io.load_flax_params(t_llm.SpeechLM(port.cfg).eval(), variables)
    src, tok, plen = _plan(rng)
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
    toks = np.asarray(out_j)[0, :n]
    assert (toks == 123).sum() >= 2 and (toks != 123).any()


def test_generate_needs_the_named_device(lm):
    _, _, port = lm
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_llm.generate(port, np.zeros((1, 4), np.int32),
                       np.zeros((1, 4), np.int32), [4],
                       torch.zeros((1, 32)), [1], [2], max_steps=2)
