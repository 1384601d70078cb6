"""Streaming synthesis of the port against the JAX package.

CPU, float32, the tiny streaming geometry of tests/test_stream_flow.py
(4-token hops, 3-token lookahead) with jittered JAX-initialized weights.
Each streaming module of the port is held against its JAX twin: the
encoder's prefill and chunk steps, the UNet's collect and chunk modes,
the collect and chunk Euler solvers, the streaming flow_inference and
flow_inference_unit_grid. One call of a module agrees to 1e-4 (float32
sums in other orders), a whole solve to 5e-4. The JAX package's own
ChunkedFlowSession test is slow, so the chain closes through the port:
the port's ChunkedFlowSession equals the port's unit-grid pass within
the JAX test's limit (atol 5e-4, rtol 1e-2), and that pass equals the
JAX one. Then the decode and session layers: TokenStream bursts against
llm.generate, and StreamingSession in both modes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minimax_speech_torch.infer import pipeline as t_pl
from minimax_speech_torch.infer import session as t_sess
from minimax_speech_torch.infer.stream_flow import ChunkedFlowSession
from minimax_speech_torch.models import cfm as t_cfm
from minimax_speech_torch.models import flow as t_flow
from minimax_speech_torch.models import llm as t_llm
from minimax_speech_torch.models import upsample_encoder as t_enc
from minimax_speech_torch.ops import masks as t_masks
from minimax_speech_torch.utils import params_io as t_io
from minimax_speech_tpu.models import cfm as j_cfm
from minimax_speech_tpu.models import flow as j_flow
from minimax_speech_tpu.models import upsample_encoder as j_enc
from minimax_speech_tpu.ops import masks as j_masks
from tests.conftest import synthetic_audio
from tests.test_stream_flow import ENC_CFG, HOP, LOOK, _tiny_flow
from tests.test_torch_bridge import jitter, port_config, tiny_port_cfg
from tests import torch_cpu

torch_cpu.share_cores()

WINDOW = 6
PLEN, N_GEN = 5, 11
ATOL_CALL = 1e-4
ATOL_SOLVE = 5e-4


def close(a, b, atol=ATOL_CALL, rtol=ATOL_CALL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=rtol)


def t_(x):
    return torch.as_tensor(np.asarray(x))


@pytest.fixture(scope="module")
def enc():
    x = jnp.zeros((1, 8, 16))
    model = j_enc.UpsampleConformerEncoder(ENC_CFG)
    variables = jitter(jax.jit(model.init)(jax.random.PRNGKey(0), x,
                                           jnp.array([8])), seed=4)
    port = t_enc.UpsampleConformerEncoder(
        port_config(ENC_CFG, t_enc.UpsampleEncoderConfig)).eval()
    return model, variables, t_io.load_flax_params(port, variables)


@pytest.fixture(scope="module")
def flow():
    jcfg = _tiny_flow()
    model = j_flow.FlowModel(jcfg)
    init = jax.jit(j_flow.init_flow_variables, static_argnums=(0, 2, 3))
    variables = jitter(init(model, jax.random.PRNGKey(0), 2, 8), seed=5)
    port = t_flow.FlowModel(port_config(jcfg, t_flow.FlowConfig)).eval()
    return model, variables, t_io.load_flax_params(port, variables)


@pytest.fixture(scope="module")
def utt():
    rng = np.random.default_rng(1)
    return dict(prompt=rng.integers(0, 50, PLEN).astype(np.int32),
                gen=rng.integers(0, 50, N_GEN).astype(np.int32),
                feat=rng.standard_normal((2 * PLEN, 8)).astype(np.float32),
                emb=rng.standard_normal((1, 12)).astype(np.float32),
                noise=rng.standard_normal((1, 200, 8)).astype(np.float32))


def test_unit_chunk_mask_identical():
    for size, plen, chunk, window in ((20, 5, 4, -1), (33, 7, 8, 6),
                                      (10, 0, 3, 2)):
        np.testing.assert_array_equal(
            t_masks.unit_chunk_mask(size, plen, chunk, window).numpy(),
            np.asarray(j_masks.unit_chunk_mask(size, plen, chunk, window)))


@pytest.mark.parametrize("chunk_align", [None, PLEN])
def test_encoder_streaming_masks_match(enc, chunk_align):
    """The full pass with the static chunk masks, or on the unit grid."""
    model, variables, port = enc
    xs = np.random.default_rng(2).standard_normal((1, 16, 16)).astype(
        np.float32)
    ref, _ = model.apply(variables, jnp.asarray(xs), jnp.array([16]),
                         streaming=True, chunk_align=chunk_align)
    with torch.no_grad():
        ours, _ = port(t_(xs), torch.tensor([16]), streaming=True,
                       chunk_align=chunk_align)
    close(ours, ref)


def test_encoder_prefill_and_chunks_match(enc):
    """prefill, two hops with context and the final ragged hop: each
    output and the conv tails against JAX, and the chunked outputs
    against the full unit-grid pass."""
    model, variables, port = enc
    xs = np.random.default_rng(0).standard_normal((1, PLEN + N_GEN, 16)) \
        .astype(np.float32)
    buf = np.zeros((1, 8, 16), np.float32)
    buf[:, :PLEN + LOOK] = xs[:, :PLEN + LOOK]
    j_cache = j_enc.make_encoder_cache(ENC_CFG, 1, 32)
    _, j_cache = model.apply(variables, jnp.asarray(buf), jnp.int32(PLEN),
                             j_cache,
                             method=j_enc.UpsampleConformerEncoder.prefill)
    cache = t_enc.make_encoder_cache(port.cfg, 1, 32)
    with torch.no_grad():
        _, cache = port.prefill(t_(buf), PLEN, cache)
    for k in ("pre_c2", "up_c"):
        close(cache[k], j_cache[k])

    outs, off = [], PLEN
    for _ in range(2):
        chunk, ctx = xs[:, off: off + HOP], xs[:, off + HOP: off + HOP + LOOK]
        ref, j_cache = model.apply(
            variables, jnp.asarray(chunk), j_cache, jnp.int32(off),
            jnp.int32(HOP), jnp.asarray(ctx),
            method=j_enc.UpsampleConformerEncoder.chunk_step)
        with torch.no_grad():
            o, cache = port.chunk_step(t_(chunk), cache, off, HOP, t_(ctx))
        close(o, ref)
        outs.append(o.numpy())
        off += HOP
    n = PLEN + N_GEN - off
    fbuf = np.zeros((1, 8, 16), np.float32)
    fbuf[:, :n] = xs[:, off:]
    ref, j_cache = model.apply(
        variables, jnp.asarray(fbuf), j_cache, jnp.int32(off), jnp.int32(n),
        None, method=j_enc.UpsampleConformerEncoder.chunk_step)
    with torch.no_grad():
        o, cache = port.chunk_step(t_(fbuf), cache, off, n)
    close(o[:, : 2 * n], np.asarray(ref)[:, : 2 * n])
    for mine, ref_kv in zip(cache["kv1"] + cache["kv2"],
                            j_cache["kv1"] + j_cache["kv2"]):
        close(mine, ref_kv)
    outs.append(o.numpy()[:, : 2 * n])
    full, _ = model.apply(variables, jnp.asarray(xs), jnp.array([16]),
                          streaming=True, chunk_align=jnp.int32(PLEN))
    close(np.concatenate(outs, axis=1), np.asarray(full)[:, 2 * PLEN:],
          atol=2e-4, rtol=1e-3)


def _unet_inputs(rng, t, b=2):
    x, mu, cond = (rng.standard_normal((b, t, 8)).astype(np.float32)
                   for _ in range(3))
    return x, mu, np.linspace(0.1, 0.9, b).astype(np.float32), \
        rng.standard_normal((b, 8)).astype(np.float32), cond


def _est_j(model, variables, *args, **kw):
    return model.apply(variables, *map(jnp.asarray, args),
                       method=j_flow.FlowModel.estimate, **kw)


def _close_state(ours: dict, ref: dict):
    assert set(ours) == set(ref)
    for k in ref:
        close(ours[k], ref[k])


def test_unet_collect_then_chunk_match(flow):
    """collect over a padded prompt (full mask through K1's plain version
    on the CPU), then one cached chunk of 8 frames, 6 of them valid."""
    model, variables, port = flow
    rng = np.random.default_rng(3)
    t, plen2 = 16, 10
    x, mu, tt, spks, cond = _unet_inputs(rng, t)
    mask = np.ones((2, t), np.float32)
    ref, j_state = _est_j(model, variables, x, mask, mu, tt, spks, cond,
                          False, collect_len=jnp.int32(plen2), window=WINDOW)
    with torch.no_grad():
        ours, state = port.estimate(*map(t_, (x, mask, mu, tt, spks, cond)),
                                    collect_len=plen2, window=WINDOW)
    close(ours, ref)
    _close_state(state, j_state)

    x, mu, tt, spks, cond = _unet_inputs(rng, 8)
    mask = (np.arange(8)[None] < 6).repeat(2, 0).astype(np.float32)
    ref, j_state = _est_j(model, variables, x, mask, mu, tt, spks, cond,
                          False, cache=j_state, cache_offset=jnp.int32(plen2),
                          q_valid=jnp.int32(6), window=WINDOW)
    with torch.no_grad():
        ours, state = port.estimate(*map(t_, (x, mask, mu, tt, spks, cond)),
                                    cache=state, cache_offset=plen2,
                                    q_valid=6, window=WINDOW)
    close(ours[:, :6], np.asarray(ref)[:, :6])
    _close_state(state, j_state)


@pytest.mark.parametrize("unit_align", [None, 6])
def test_unet_streaming_masks_match(flow, unit_align):
    """streaming: the static chunk mask (K1's chunk mode, plain version on
    the CPU) or the unit grid with a window (plain masked attention)."""
    model, variables, port = flow
    x, mu, tt, spks, cond = _unet_inputs(np.random.default_rng(4), 20)
    mask = (np.arange(20)[None] < np.array([[20], [17]])).astype(np.float32)
    kw = {} if unit_align is None else dict(window=WINDOW,
                                            unit_align=unit_align)
    ref = _est_j(model, variables, x, mask, mu, tt, spks, cond, True, **kw)
    with torch.no_grad():
        ours = port.estimate(*map(t_, (x, mask, mu, tt, spks, cond)),
                             streaming=True, **kw)
    for i, n in enumerate((20, 17)):
        close(ours[i, :n], np.asarray(ref)[i, :n])


def test_solve_euler_collect_and_chunk_match(flow):
    model, variables, port = flow
    cfg = model.cfg
    rng = np.random.default_rng(5)
    t, plen2 = 16, 10
    z, mu, cond = (rng.standard_normal((1, t, 8)).astype(np.float32)
                   for _ in range(3))
    spks = rng.standard_normal((1, 8)).astype(np.float32)
    fmask = (np.arange(t)[None] < plen2).astype(np.float32)

    def est_j(v, *a, **kw):
        return model.apply(v, *a, method=j_flow.FlowModel.estimate, **kw)

    xr, j_states = j_cfm.solve_euler_collect(
        est_j, variables, *map(jnp.asarray, (z, mu, fmask, spks, cond)),
        cfg.n_timesteps, cfg.cfm, collect_len=jnp.int32(plen2), window=WINDOW)
    with torch.no_grad():
        xo, states = t_cfm.solve_euler_collect(
            port.estimate, *map(t_, (z, mu, fmask, spks, cond)),
            cfg.n_timesteps, port.cfg.cfm, collect_len=plen2, window=WINDOW)
    close(xo, xr, ATOL_SOLVE, ATOL_SOLVE)
    assert len(states) == cfg.n_timesteps
    for s, state in enumerate(states):
        _close_state(state, jax.tree_util.tree_map(lambda a: a[s], j_states))

    z, mu = (rng.standard_normal((1, 8, 8)).astype(np.float32)
             for _ in range(2))
    xr, j_states = j_cfm.solve_euler_chunk(
        est_j, variables, jnp.asarray(z), jnp.asarray(mu),
        jnp.asarray(spks), jnp.zeros((1, 8, 8)), cfg.n_timesteps, cfg.cfm,
        j_states, jnp.int32(plen2), jnp.int32(6), window=WINDOW)
    with torch.no_grad():
        xo, states = t_cfm.solve_euler_chunk(
            port.estimate, t_(z), t_(mu), t_(spks), torch.zeros((1, 8, 8)),
            cfg.n_timesteps, port.cfg.cfm, states, plen2, 6, window=WINDOW)
    close(xo[:, :6], np.asarray(xr)[:, :6], ATOL_SOLVE, ATOL_SOLVE)
    _close_state(states[-1], jax.tree_util.tree_map(lambda a: a[-1],
                                                    j_states))


def _tokens(utt):
    return np.concatenate([utt["prompt"], utt["gen"]])[None]


def test_flow_inference_streaming_matches(flow, utt):
    """The non-chunked session's flow: chunk masks everywhere and the last
    `lookahead` tokens held back as context (finalize False)."""
    model, variables, port = flow
    tok = _tokens(utt)
    n = tok.shape[1]
    args = (tok, np.array([n]), utt["feat"][None], utt["emb"], utt["noise"])
    ref = j_flow.flow_inference(model, variables, *map(jnp.asarray, args),
                                streaming=True, finalize=False)
    ours = t_flow.flow_inference(port, *args, streaming=True, finalize=False,
                                 device="cpu")
    assert ours.shape == ref.shape == (1, 2 * (n - LOOK) - 2 * PLEN, 8)
    close(ours, ref, ATOL_SOLVE, ATOL_SOLVE)


@pytest.fixture(scope="module")
def unit_grid(flow, utt):
    model, variables, port = flow
    tok = _tokens(utt)
    args = (tok, np.array([tok.shape[1]]), utt["feat"][None])
    ref = j_flow.flow_inference_unit_grid(
        model, variables, *map(jnp.asarray, args), jnp.int32(PLEN),
        jnp.asarray(utt["emb"]), jnp.asarray(utt["noise"]), window=WINDOW)
    ours = t_flow.flow_inference_unit_grid(
        port, *args, PLEN, utt["emb"], utt["noise"], window=WINDOW,
        device="cpu")
    return np.asarray(ref)[0, 2 * PLEN:], ours.numpy()[0, 2 * PLEN:]


def test_flow_inference_unit_grid_matches(unit_grid):
    ref, ours = unit_grid
    close(ours, ref, ATOL_SOLVE, ATOL_SOLVE)


def test_chunked_flow_session_matches_unit_grid(flow, utt, unit_grid):
    """The port's ChunkedFlowSession, hop by hop, against the port's
    full-sequence unit-grid pass, at the limit of the JAX package's own
    test (tests/test_stream_flow.py)."""
    _, _, port = flow
    gen = utt["gen"]
    s = ChunkedFlowSession(port, utt["noise"], token_hop=HOP, lookahead=LOOK,
                           max_tokens=32, window=WINDOW, final_bucket=8,
                           prompt_buckets=(8, 16), device="cpu")
    s.prefill(utt["prompt"], utt["feat"], torch.as_tensor(utt["emb"]),
              gen[:LOOK])
    chunked = np.concatenate([s.step(gen[0:4], gen[4:7]),
                              s.step(gen[4:8], gen[8:11]),
                              s.final(gen[8:])])
    assert chunked.shape == unit_grid[1].shape
    np.testing.assert_allclose(chunked, unit_grid[1], atol=5e-4, rtol=1e-2)


def test_chunked_flow_session_refuses_overflow(flow, utt):
    _, _, port = flow
    s = ChunkedFlowSession(port, utt["noise"], token_hop=HOP, lookahead=LOOK,
                           max_tokens=12, window=WINDOW, final_bucket=8,
                           prompt_buckets=(8,), device="cpu")
    with pytest.raises(ValueError, match="max_tokens"):
        s.prefill(np.zeros(10, np.int32), np.zeros((20, 8), np.float32),
                  torch.as_tensor(utt["emb"]), np.zeros(3, np.int32))
    s.prefill(utt["prompt"], utt["feat"], torch.as_tensor(utt["emb"]),
              utt["gen"][:LOOK])
    with pytest.raises(ValueError, match="max_tokens"):
        s.final(utt["gen"][:4])


@pytest.fixture(scope="module")
def tiny_pipe():
    _, pcfg = tiny_port_cfg()
    pcfg = dataclasses.replace(pcfg, max_speech_tokens=40)
    return t_pl.TTSPipeline.from_random(pcfg, seed=2, device="cpu")


def test_token_stream_bursts_give_generate_tokens(tiny_pipe):
    """Bursts of 28 and of 7 steps give llm.generate's ids with the same
    noise tables (a boost on one id makes the repetition fallback
    decide some steps)."""
    pipe = tiny_pipe
    cfg = pipe.cfg.lm
    rng = np.random.default_rng(6)
    src, tok, plen = t_llm.build_inference_plan(rng.integers(0, 200, 6),
                                                rng.integers(0, 40, 8))
    spk = torch.as_tensor(rng.standard_normal((1, 32)), dtype=torch.float32)
    g_top, g_fb = t_llm.decode_noise(cfg, 40, 1,
                                     torch.Generator().manual_seed(3))
    with torch.no_grad():
        pipe.lm.llm_decoder.bias[123] += 8.0
    try:
        out, cnt = t_llm.generate(pipe.lm, src, tok, plen, spk, [10], [40],
                                  max_steps=40, gumbel_top=g_top,
                                  gumbel_fallback=g_fb, device="cpu")
        ref = out[0, : int(cnt[0])].tolist()
        ts = t_sess.TokenStream(pipe.lm, max_steps=40, device="cpu")
        for burst in (28, 7):
            got = list(ts.generate(src, tok, plen, spk, 10, 40,
                                   burst_size=burst, gumbel_top=g_top,
                                   gumbel_fallback=g_fb))
            assert got == ref, burst
    finally:
        with torch.no_grad():
            pipe.lm.llm_decoder.bias[123] -= 8.0
    assert 10 <= len(ref) <= 40 and ref.count(123) >= 2


@pytest.mark.parametrize("chunked", [True, False])
def test_streaming_session_chunks(tiny_pipe, chunked):
    pipe = tiny_pipe
    rng = np.random.default_rng(7)
    prompt_tokens = pipe.extract_prompt_tokens(
        synthetic_audio(rng, 0.5, 16000))
    a24 = synthetic_audio(rng, 0.5, 24000)
    latent = pipe.extract_prompt_latent(a24)
    lm_spk, flow_emb = pipe.speaker_embedding(pipe.extract_prompt_mel(a24))
    sess = t_sess.StreamingSession(pipe, token_hop=8, lookahead=3,
                                   overlap_frames=2, chunked=chunked)
    chunks = list(sess.synthesize_stream(
        rng.integers(0, 256, 6), rng.integers(0, 256, 2), prompt_tokens,
        latent, lm_spk, flow_emb,
        generator=torch.Generator().manual_seed(3)))
    assert len(chunks) >= 2 and chunks[-1].final
    assert not any(c.final for c in chunks[:-1])
    total = np.concatenate([c.audio for c in chunks])
    assert np.isfinite(total).all()
    n_tok = chunks[-1].tokens
    if chunked:  # the prompt's frames forced to 2x its tokens
        frames = 2 * n_tok
    else:
        frames = 2 * (len(prompt_tokens) + n_tok) - latent.shape[0]
    assert len(total) == frames * t_pl.SAMPLES_PER_FRAME


def test_session_fade_matches_jax():
    from minimax_speech_tpu.infer.session import fade_in_out
    rng = np.random.default_rng(8)
    a, b = rng.standard_normal(40), rng.standard_normal(40)
    win = np.hamming(16)
    np.testing.assert_array_equal(t_sess.fade_in_out(a, b, win),
                                  fade_in_out(a, b, win))


def test_mel_mode_streaming_raises(tiny_pipe):
    """Mel mode streams since HiFT is ported (tests/test_torch_mel_mode.py
    holds it against JAX): a mel-mode session builds; what still raises
    is an output_type that is neither 'latent' nor 'mel'."""
    cfg = dataclasses.replace(tiny_pipe.cfg, output_type="mel")
    sess = t_sess.StreamingSession(t_pl.TTSPipeline(cfg, device="cpu"))
    assert sess.p.hift is not None and sess.p.dac is None
    with pytest.raises(ValueError, match="output_type"):
        t_pl.TTSPipeline(dataclasses.replace(cfg, output_type="wave"),
                         device="cpu")
