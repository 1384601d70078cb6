"""Continuous batching and bistream decoding of the port.

CPU, float32, the tiny geometry of tests/test_pipeline.py, weights
jittered and loaded by both packages. Against JAX, with JAX's own noise
rebuilt from its keys (jax.random.categorical(k, x) is argmax(x +
gumbel(k, x.shape))):
- `ContinuousBatcher` decode bursts over a pool of 3 lanes, a request
  joining after the first burst: token ids identical, burst by burst;
- `BistreamDecoder` over streamed text chunks: token ids identical.
Against the port's own `llm.generate`: each request through a
`ContinuousBatcher` of 2 lanes (requests joining and leaving, a
zero-token request, an oversize one refused) gives generate's ids with
the noise rows its lane drew, and audio of exactly 960 samples per token.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from minimax_speech_torch.infer import pipeline as t_pl
from minimax_speech_torch.infer.bistream import BistreamDecoder
from minimax_speech_torch.infer.continuous import ContinuousBatcher
from minimax_speech_torch.models import llm as t_llm
from minimax_speech_torch.utils import params_io as t_io
from minimax_speech_tpu.infer import continuous as j_cont
from minimax_speech_tpu.infer import pipeline as j_pl
from minimax_speech_tpu.infer import serving as j_serving
from minimax_speech_tpu.infer.bistream import BistreamDecoder as JBistream
from minimax_speech_tpu.models import llm as j_llm
from tests.test_torch_bridge import jitter, port_config, tiny_port_cfg
from tests.test_torch_serving import make_requests, trees  # noqa: F401
from tests import torch_cpu

torch_cpu.share_cores()

MAX_TOKENS = 24
BURST_FOLD = 0x62757273  # folded into JAX's batcher key after each burst


def _cfg(cfg):
    # 3 speech tokens per text token at most, so requests end apart
    return dataclasses.replace(cfg, max_speech_tokens=MAX_TOKENS,
                               max_token_text_ratio=3.0)


@pytest.fixture(scope="module")
def pipe(trees):  # noqa: F811
    _, pcfg = tiny_port_cfg()
    return t_pl.TTSPipeline.from_flax(_cfg(pcfg), trees["lm"], trees["flow"],
                                      trees["codec"], trees["s3"],
                                      device="cpu")


def continuous_noise(key, slots, top_k, vocab):
    """JAX's ContinuousBatcher noise as an llm.NoiseFn: burst i's step j
    draws gumbel(fold_in(fold_in(key_i, j), 0), (slots, top_k)) and the
    categorical over fold_in(fold_in(key_i, j), 1); the key advances by
    fold_in(key_i, BURST_FOLD) after each burst."""
    state = {"key": key}

    def noise(burst, first_step, n):
        k = state["key"]
        state["key"] = jax.random.fold_in(k, BURST_FOLD)
        steps = [jax.random.fold_in(k, j) for j in range(n)]
        return (np.stack([jax.random.gumbel(jax.random.fold_in(s, 0),
                                            (slots, top_k)) for s in steps]),
                np.stack([jax.random.gumbel(jax.random.fold_in(s, 1),
                                            (slots, vocab)) for s in steps]))
    return noise


def test_continuous_bursts_match_jax(trees, pipe):  # noqa: F811
    jcfg, _ = tiny_port_cfg()
    jcfg = _cfg(jcfg)
    kw = dict(slots=3, token_hop=5, lookahead=3, overlap_frames=2,
              prompt_buckets=(32, 64))
    key = jax.random.PRNGKey(21)
    jcb = j_cont.ContinuousBatcher(
        j_pl.TTSPipeline(jcfg, trees["lm"], trees["flow"], trees["codec"]),
        key=key, **kw)
    lm = pipe.cfg.lm
    tcb = ContinuousBatcher(pipe, noise=continuous_noise(key, 3, lm.top_k,
                                                         lm.vocab), **kw)
    reqs = make_requests(pipe, (0.4, 0.6, 0.52), seed=12)
    for r in reqs[:2]:
        jcb.submit(j_serving.Request(**dataclasses.asdict(r)))
        tcb.submit(r)
    seen = 0
    for burst in range(4):
        if burst == 1:  # joins the running decode at its own position
            jcb.submit(j_serving.Request(**dataclasses.asdict(reqs[2])))
            tcb.submit(reqs[2])
        jcb._admit()
        tcb._admit()
        (jcb._key, jcb._logits, jcb._cache, jcb._valid, jcb._recent,
         jcb._counts, jcb._done, jcb._active, toks_j) = jcb._burst(
            jcb.p.lm_vars, jcb._key, jcb._cache, jcb._valid, jcb._logits,
            jcb._recent, jcb._counts, jcb._done, jcb._active, jcb._plen,
            jcb._min_len, jcb._max_len, n=jcb.token_hop)
        toks_t, done_t = tcb._burst(tcb.token_hop)
        np.testing.assert_array_equal(toks_t, np.asarray(toks_j))
        np.testing.assert_array_equal(done_t, np.asarray(jcb._done))
        seen += int((toks_t >= 0).sum())
    assert seen >= 25


def test_continuous_requests_equal_generate(pipe):
    """Each request's ids equal llm.generate's with the noise rows of its
    lane, wherever and whenever it rode the pool."""
    cfg = pipe.cfg
    rng = np.random.default_rng(13)
    reqs = make_requests(pipe, (0.4, 0.6, 0.5, 0.44), seed=13)
    empty = dataclasses.replace(reqs[1], text_tokens=reqs[1].text_tokens[:0])
    gen = torch.Generator().manual_seed(3)
    tables, lanes_at, toks_at = [], [], []

    def noise(burst, first_step, n):
        lanes_at.append([-1 if lane.free else lane.request_id
                         for lane in cb.lanes])
        tables.append(t_llm.decode_noise(cfg.lm, n, 2, gen))
        return tables[-1]

    cb = ContinuousBatcher(pipe, slots=2, token_hop=5, lookahead=3,
                           overlap_frames=2, prompt_buckets=(32, 64),
                           noise=noise)

    def recording_burst(n, burst=cb._burst):
        toks, done = burst(n)
        toks_at.append(toks)
        return toks, done

    cb._burst = recording_burst
    big = dataclasses.replace(reqs[0], text_tokens=rng.integers(0, 256, 80))
    with pytest.raises(ValueError, match="prompt bucket"):
        cb.submit(big)
    order = [reqs[0], empty]
    rids = [cb.submit(r) for r in order]
    events, ticks = [], 0
    while cb.busy():
        events.extend(cb.tick())
        ticks += 1
        if ticks == 2:  # two arrivals while request 0 is mid-decode
            order += reqs[2:]
            rids += [cb.submit(r) for r in reqs[2:]]
        assert ticks < 60, "the batcher did not drain"
    assert all(lane.free for lane in cb.lanes)

    for rid, r in zip(rids, order):
        evs = [e for e in events if e.stream == rid]
        assert evs and evs[-1].final and not any(e.final for e in evs[:-1])
        ids, g_top, g_fb = [], [], []
        for b, lanes in enumerate(lanes_at):
            if rid in lanes:
                lane = lanes.index(rid)
                row = toks_at[b][lane]
                ids += row[row >= 0].tolist()
                g_top.append(tables[b][0][:, lane])
                g_fb.append(tables[b][1][:, lane])
        assert evs[-1].tokens == len(ids)
        assert sum(len(e.audio) for e in evs) == len(ids) * 960
        if r is empty:
            assert ids == []
            continue
        g_top, g_fb = torch.cat(g_top), torch.cat(g_fb)
        src, tok, plen = t_llm.build_inference_plan(
            np.concatenate([r.prompt_text_tokens, r.text_tokens]),
            r.prompt_speech_tokens)
        n_text = len(r.text_tokens)
        out, cnt = t_llm.generate(
            pipe.lm, src, tok, plen, torch.as_tensor(r.lm_spk[None]),
            [int(n_text * cfg.min_token_text_ratio)],
            [min(int(n_text * cfg.max_token_text_ratio),
                 cfg.max_speech_tokens)],
            max_steps=len(g_top), gumbel_top=g_top[:, None],
            gumbel_fallback=g_fb[:, None], device="cpu")
        assert out[0, : int(cnt[0])].tolist() == ids and len(ids) >= 6


@pytest.fixture(scope="module")
def small_lm():
    """The tiny LM with 40 speech codes (eos 40, fill 42), fill made
    likelier, so bistream chunks end by sampling as well as by force."""
    jcfg, _ = tiny_port_cfg()
    jlm = dataclasses.replace(jcfg.lm, speech_token_size=40)
    model = j_llm.SpeechLM(jlm)
    init = jax.jit(j_llm.init_lm_variables, static_argnums=0)
    variables = jax.tree_util.tree_map(
        np.array, jitter(init(model, jax.random.PRNGKey(3)), seed=3))
    variables["params"]["llm_decoder"]["bias"][42] += 1.5
    port = t_llm.SpeechLM(port_config(jlm, t_llm.LMConfig)).eval()
    return model, variables, t_io.load_flax_params(port, variables)


def bistream_noise(key, top_k, vocab):
    """JAX's BistreamDecoder noise: per step key, k1 = split(key), and
    ras_sample's split of k1 into the nucleus and fallback keys."""
    state = {"key": key}

    def noise(burst, n):
        g_top, g_fb = [], []
        for _ in range(n):
            state["key"], k1 = jax.random.split(state["key"])
            a, b = jax.random.split(k1)
            g_top.append(jax.random.gumbel(a, (top_k,)))
            g_fb.append(jax.random.gumbel(b, (vocab,)))
        return np.stack(g_top), np.stack(g_fb)
    return noise


def test_bistream_matches_jax(small_lm):
    model, variables, port = small_lm
    rng = np.random.default_rng(14)
    chunks = [rng.integers(0, 250, 3) for _ in range(6)]
    ptext, pspeech = rng.integers(0, 250, 2), rng.integers(0, 40, 6)
    spk = rng.standard_normal((1, 32)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    ref = list(JBistream(model, variables, max_steps=64).generate(
        iter(chunks), ptext, pspeech, jax.numpy.asarray(spk), key))
    ours = list(BistreamDecoder(port, max_steps=64, device="cpu").generate(
        iter(chunks), ptext, pspeech, torch.as_tensor(spk),
        noise=bistream_noise(key, port.cfg.top_k, port.cfg.vocab)))
    assert ours == ref
    assert len(ref) >= 20 and all(0 <= t < 40 for t in ref)


def test_serving_entry_points_need_the_named_device(small_lm, tmp_path):
    """Without a GPU the entry points that build on their own raise
    unless given the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from minimax_speech_torch import config as t_config
    from minimax_speech_torch.cli import serve
    from minimax_speech_torch.infer.api import TTS
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BistreamDecoder(small_lm[2])
    cfg = t_config.load_tts_config("configs/tiny.yaml")
    src = t_pl.TTSPipeline.from_random(cfg, device="cpu")
    for name, m in src.models().items():
        t_io.save_params(str(tmp_path / f"{'llm' if name == 'lm' else name}"
                                         ".npz"), m)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TTS(model_dir=str(tmp_path), config="configs/tiny.yaml")
    assert TTS(model_dir=str(tmp_path), config="configs/tiny.yaml",
               device="cpu").pipeline.device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.build_server(serve.parse_args(
            ["--random_init", "--config", "configs/tiny.yaml", "--no_warm",
             "--port", "0"]))
