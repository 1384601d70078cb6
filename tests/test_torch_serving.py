"""The serving slice of the port against the JAX package and itself.

CPU, float32, the tiny geometry of tests/test_pipeline.py (the
streaming flow of tests/test_stream_flow.py for the batched streaming
flow), weights jittered and loaded by both packages. Against JAX, with
the same weights and noise:
- per-row cache writes and `decode_step_rows` (lanes at different
  positions, one parked): logits within 1e-4, the cache within 1e-5,
  the parked lane's `valid` row unchanged;
- `extend`, block by block, against `prefill` and against JAX's
  `extend`, with and without a padded tail: logits within 2e-5 (the
  JAX test's limit) of the prefill, 1e-4 of JAX;
- `ras_sample` and `push_recent`: identical ids;
- `flow_inference_batched(streaming=True)` with ragged rows: within
  1e-4 on every valid frame;
- `BatchSynthesizer`, 3 requests padded to 4: token counts identical,
  PCM within 2 LSB (float32 sums in other orders through LM, flow and
  codec, as tests/test_torch_pipeline.py).
Against the port's own verified pieces: a `BatchSynthesizer` row equals
`synthesize_fused` of that request alone (tokens identical, PCM within 2
LSB); each stream of a `BatchStreamingSession` of 3 equals the same
session run on that stream alone (tokens identical, audio within 1e-4);
the `TTS` API's four modes, its speaker cache and speed; and
`TTS.inference_vc` against JAX's `TTS` (PCM within 2 LSB).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minimax_speech_torch.infer import api as t_api
from minimax_speech_torch.infer import pipeline as t_pl
from minimax_speech_torch.infer.serving import BatchSynthesizer, Request
from minimax_speech_torch.infer.stream_batch import BatchStreamingSession
from minimax_speech_torch.models import flow as t_flow
from minimax_speech_torch.models import llm as t_llm
from minimax_speech_torch.models import qwen2 as t_qwen2
from minimax_speech_torch.ops import sampling as t_sampling
from minimax_speech_torch.utils import params_io as t_io
from minimax_speech_tpu.infer import pipeline as j_pl
from minimax_speech_tpu.infer import serving as j_serving
from minimax_speech_tpu.models import flow as j_flow
from minimax_speech_tpu.models import llm as j_llm
from minimax_speech_tpu.models import qwen2 as j_qwen2
from minimax_speech_tpu.ops import sampling as j_sampling
from tests.conftest import synthetic_audio
from tests.test_stream_flow import _tiny_flow
from tests.test_torch_bridge import jitter, port_config, tiny_port_cfg
from tests.test_torch_lm import jax_decode_noise
from tests import torch_cpu

torch_cpu.share_cores()

MAX_TOKENS = 16


@pytest.fixture(scope="module")
def lm():
    jcfg, pcfg = tiny_port_cfg()
    model = j_llm.SpeechLM(jcfg.lm)
    init = jax.jit(j_llm.init_lm_variables, static_argnums=0)
    variables = jitter(init(model, jax.random.PRNGKey(2)), seed=2)
    port = t_io.load_flax_params(t_llm.SpeechLM(pcfg.lm).eval(), variables)
    return model, variables, port


def test_decode_step_rows_matches_jax(lm):
    """Three lanes: two at their own decode slots, one parked (inactive)
    whose context must not grow."""
    model, variables, port = lm
    rng = np.random.default_rng(0)
    q = port.cfg.qwen
    b, k = 3, 16
    shape = (q.n_layers, b, k, q.n_kv_heads, q.head_dim)
    ck, cv = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    valid = np.arange(k)[None] < np.array([[5], [9], [3]])
    emb = rng.standard_normal((b, 1, 32)).astype(np.float32)
    slots = np.array([5, 9, 3], np.int32)
    active = np.array([True, True, False])
    logit_j, (ck_j, cv_j), valid_j = model.apply(
        variables, jnp.asarray(emb), jnp.asarray(slots), jnp.asarray(valid),
        (jnp.asarray(ck), jnp.asarray(cv)), jnp.asarray(slots),
        jnp.asarray(active), method=j_llm.SpeechLM.decode_step_rows)
    cache = (torch.as_tensor(ck), torch.as_tensor(cv))
    valid_t = torch.as_tensor(valid)
    with torch.no_grad():
        logit_t = port.decode_step_rows(
            torch.as_tensor(emb), torch.as_tensor(slots).long(), valid_t,
            cache, torch.as_tensor(slots).long(), torch.as_tensor(active))
    np.testing.assert_allclose(logit_t.numpy(), np.asarray(logit_j),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
    np.testing.assert_array_equal(valid_t.numpy()[2], valid[2])
    for mine, ref in zip(cache, (ck_j, cv_j)):
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=1e-5)


def _extend_blocks(model, variables, port, emb_all, blocks, k):
    """Extend block by block in both packages; blocks: (emb, n_true, slot)
    with emb (1, n, C). Returns the logits after each block."""
    q = port.cfg.qwen
    j_cache = j_qwen2.make_cache(model.cfg.qwen, 1, k)
    j_valid = jnp.zeros((1, k), bool)
    t_cache = t_qwen2.make_cache(q, 1, k)
    t_valid = torch.zeros((1, k), dtype=torch.bool)
    out = []
    for emb, n_true, slot in blocks:
        n = emb.shape[1]
        pos = slot + np.arange(n)[None]
        lj, j_cache, j_valid = model.apply(
            variables, jnp.asarray(emb), jnp.asarray(pos),
            jnp.array([n_true]), j_valid, j_cache, slot,
            method=j_llm.SpeechLM.extend)
        with torch.no_grad():
            lt = port.extend(torch.as_tensor(emb), torch.as_tensor(pos),
                             [n_true], t_valid, t_cache, slot)
        np.testing.assert_array_equal(t_valid.numpy(), np.asarray(j_valid))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4,
                                   rtol=1e-4)
        out.append(lt.numpy())
    return out


def _prefill_logits(port, emb_all):
    n = emb_all.shape[1]
    with torch.no_grad():
        cache = t_qwen2.make_cache(port.cfg.qwen, 1, 2 * n)
        hidden = port.prefill(torch.as_tensor(emb_all),
                              torch.ones((1, n), dtype=torch.bool),
                              torch.arange(n)[None], cache)
        return port.llm_decoder(hidden[:, -1]).numpy()


def test_extend_matches_prefill_and_jax(lm):
    """5 + 4 + 3 blocks give one prefill's last logits (JAX
    tests/test_bistream.py:21-51)."""
    model, variables, port = lm
    rng = np.random.default_rng(1)
    emb_all = rng.standard_normal((1, 12, 32)).astype(np.float32)
    blocks, slot = [], 0
    for n in (5, 4, 3):
        blocks.append((emb_all[:, slot:slot + n], n, slot))
        slot += n
    logits = _extend_blocks(model, variables, port, emb_all, blocks, 24)
    np.testing.assert_allclose(logits[-1], _prefill_logits(port, emb_all),
                               atol=2e-5)


def test_extend_with_padded_tail(lm):
    """A block of 6 with 5 real rows and a garbage pad, then 3 real rows
    written over the pad slot (JAX tests/test_bistream.py:54-84)."""
    model, variables, port = lm
    rng = np.random.default_rng(2)
    emb_all = rng.standard_normal((1, 8, 32)).astype(np.float32)
    first = np.concatenate([emb_all[:, :5], np.full((1, 1, 32), 77.0,
                                                    np.float32)], axis=1)
    logits = _extend_blocks(model, variables, port, emb_all,
                            [(first, 5, 0), (emb_all[:, 5:8], 3, 5)], 16)
    np.testing.assert_allclose(logits[-1], _prefill_logits(port, emb_all),
                               atol=2e-5)


@pytest.mark.parametrize("repeat", [0, 1, 3])
def test_ras_sample_and_push_recent_match_jax(repeat):
    """One row: the nucleus draw, and with the nucleus pick already in
    the window `repeat` times, the full-distribution fallback. The noise
    is JAX's own: gumbel(split(key)[0], (top_k,)) and gumbel(split(key)[1],
    (V,))."""
    rng = np.random.default_rng(repeat)
    v, top_k, win = 60, 25, 10
    for seed in range(6):
        logits = rng.standard_normal(v).astype(np.float32)
        logits[7] += 4.0  # the nucleus picks 7 most of the time
        logp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits)))
        recent = np.full((win,), -1, np.int32)
        recent[:repeat] = 7
        recent[repeat:repeat + 2] = [3, 11]
        key = jax.random.PRNGKey(seed)
        ref = j_sampling.ras_sample(key, jnp.asarray(logp),
                                    jnp.asarray(recent), 0.8, top_k, win, 0.1)
        k1, k2 = jax.random.split(key)
        ours = t_sampling.ras_sample(
            torch.as_tensor(np.array(jax.random.gumbel(k1, (top_k,)))),
            torch.as_tensor(np.array(jax.random.gumbel(k2, (v,)))),
            torch.as_tensor(logp), torch.as_tensor(recent), 0.8, top_k, win,
            0.1)
        assert int(ours) == int(ref), (repeat, seed)
        np.testing.assert_array_equal(
            t_sampling.push_recent(torch.as_tensor(recent), ours).numpy(),
            np.asarray(j_sampling.push_recent(jnp.asarray(recent), ref)))


def test_flow_inference_batched_streaming_matches_jax():
    """Two ragged rows (16 and 12 tokens, 10 and 6 prompt frames) through
    the chunk masks of the encoder and the UNet."""
    jcfg = _tiny_flow()
    model = j_flow.FlowModel(jcfg)
    init = jax.jit(j_flow.init_flow_variables, static_argnums=(0, 2, 3))
    variables = jitter(init(model, jax.random.PRNGKey(0), 2, 8), seed=6)
    port = t_io.load_flax_params(
        t_flow.FlowModel(port_config(jcfg, t_flow.FlowConfig)).eval(),
        variables)
    rng = np.random.default_rng(3)
    tok = rng.integers(0, 50, (2, 16)).astype(np.int32)
    tl = np.array([16, 12], np.int32)
    pf = rng.standard_normal((2, 10, 8)).astype(np.float32)
    pfl = np.array([10, 6], np.int32)
    emb = rng.standard_normal((2, 12)).astype(np.float32)
    noise = rng.standard_normal((1, 200, 8)).astype(np.float32)
    args = (tok, tl, pf, pfl, emb, noise)
    ref = jax.jit(lambda *a: j_flow.flow_inference_batched(
        model, variables, *a, streaming=True))(*map(jnp.asarray, args))
    ours = t_flow.flow_inference_batched(port, *args, streaming=True,
                                         device="cpu")
    for i, n in enumerate(tl):
        np.testing.assert_allclose(ours[i, : 2 * n].numpy(),
                                   np.asarray(ref)[i, : 2 * n], atol=1e-4,
                                   rtol=1e-4)


@pytest.fixture(scope="module")
def trees():
    _, pcfg = tiny_port_cfg()
    seed_pipe = t_pl.TTSPipeline.from_random(pcfg, seed=4, device="cpu")
    return {name: jitter(t_io.to_flax_params(m), seed=i)
            for i, (name, m) in enumerate(seed_pipe.models().items())}


@pytest.fixture(scope="module")
def port_pipe(trees):
    _, pcfg = tiny_port_cfg()
    pcfg = dataclasses.replace(pcfg, max_speech_tokens=MAX_TOKENS)
    return t_pl.TTSPipeline.from_flax(pcfg, trees["lm"], trees["flow"],
                                      trees["codec"], trees["s3"],
                                      device="cpu")


def make_requests(pipe, seconds, seed=5):
    """Requests of ragged prompts (tokens, latents, speaker) and texts."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i, secs in enumerate(seconds):
        a24 = synthetic_audio(rng, secs, 24000)
        lm_spk, femb = pipe.speaker_embedding(pipe.extract_prompt_mel(a24))
        reqs.append(Request(
            text_tokens=rng.integers(0, 256, 3 + i),
            prompt_text_tokens=rng.integers(0, 256, 2 + i % 2),
            prompt_speech_tokens=rng.integers(0, 6561, int(secs * 25)),
            prompt_feat=pipe.extract_prompt_latent(a24),
            lm_spk=lm_spk.numpy()[0], flow_emb=femb.numpy()[0]))
    return reqs


def _pcm(w):
    return np.round(np.asarray(w) * 32767).astype(np.int32)


def test_batch_synthesizer_matches_jax(trees, port_pipe):
    """3 ragged requests, padded to a batch of 4, with the noise JAX's
    generate draws for that batch."""
    jcfg, _ = tiny_port_cfg()
    jcfg.max_speech_tokens = MAX_TOKENS
    ref = j_serving.BatchSynthesizer(j_pl.TTSPipeline(
        jcfg, trees["lm"], trees["flow"], trees["codec"]))
    reqs = make_requests(port_pipe, (0.4, 0.7, 0.56))
    assert len({r.prompt_feat.shape[0] for r in reqs}) == 3
    key = jax.random.PRNGKey(13)
    wavs_j, tim_j = ref.synthesize_batch(
        [j_serving.Request(**dataclasses.asdict(r)) for r in reqs], key=key,
        return_timings=True)
    g_top, g_fb = jax_decode_noise(key, port_pipe.cfg.lm, MAX_TOKENS, 4)
    wavs_t, tim_t = BatchSynthesizer(port_pipe).synthesize_batch(
        reqs, gumbel_top=g_top, gumbel_fallback=g_fb, return_timings=True)
    assert tim_t["tokens"] == tim_j["tokens"] and tim_t["batch"] == 4
    for wt, wj, n in zip(wavs_t, wavs_j, tim_j["tokens"]):
        assert len(wt) == len(wj) == n * 960 and n >= 6
        assert np.abs(_pcm(wt) - _pcm(wj)).max() <= 2


def test_batch_row_equals_synthesize_fused(port_pipe):
    """Each row of a batch of 3 (padded to 4) against synthesize_fused of
    its request alone with that row's noise."""
    reqs = make_requests(port_pipe, (0.36, 0.6, 0.48), seed=6)
    g_top, g_fb = t_llm.decode_noise(port_pipe.cfg.lm, MAX_TOKENS, 4,
                                     torch.Generator().manual_seed(8))
    wavs, tim = BatchSynthesizer(port_pipe).synthesize_batch(
        reqs, gumbel_top=g_top, gumbel_fallback=g_fb, return_timings=True)
    for i, r in enumerate(reqs):
        wav, t1 = port_pipe.synthesize_fused(
            r.text_tokens, r.prompt_text_tokens, r.prompt_speech_tokens,
            r.prompt_feat, torch.as_tensor(r.lm_spk[None]),
            torch.as_tensor(r.flow_emb[None]), gumbel_top=g_top[:, i:i + 1],
            gumbel_fallback=g_fb[:, i:i + 1], return_timings=True)
        assert t1["tokens"] == tim["tokens"][i]
        assert len(wav) == len(wavs[i])
        assert np.abs(_pcm(wav) - _pcm(wavs[i])).max() <= 2


def _rows(noise_fn, i):
    return lambda burst, step0, n: tuple(
        t[:, i:i + 1] for t in noise_fn(burst, step0, n))


def test_batch_streaming_equals_each_stream_alone(port_pipe):
    """Lockstep streaming of 3 requests: every active stream emits the
    same tokens per burst, so each stream hops where it would alone; its
    events equal a session over that stream alone (tokens identical,
    audio within 1e-4: other batch shapes through flow and codec). The
    noise is indexed by the global step, so each solo run takes its
    stream's rows."""
    cfg = port_pipe.cfg
    reqs = make_requests(port_pipe, (0.4, 0.6, 0.52), seed=7)
    table = t_llm.decode_noise(cfg.lm, 64, 3,
                               torch.Generator().manual_seed(9))

    def noise(burst, step0, n):
        return table[0][step0:step0 + n], table[1][step0:step0 + n]

    sess = BatchStreamingSession(port_pipe, token_hop=5, lookahead=3,
                                 overlap_frames=2)
    events = list(sess.run(reqs, noise=noise))
    for i, r in enumerate(reqs):
        mine = [e for e in events if e.stream == i]
        alone = list(sess.run([r], noise=_rows(noise, i)))
        assert len(mine) == len(alone) >= 2
        assert mine[-1].final and not any(e.final for e in mine[:-1])
        assert [e.tokens for e in mine] == [e.tokens for e in alone]
        total = np.concatenate([e.audio for e in mine])
        np.testing.assert_allclose(
            total, np.concatenate([e.audio for e in alone]), atol=1e-4)
        assert len(total) == ((len(r.prompt_speech_tokens) + mine[-1].tokens)
                              * 2 - r.prompt_feat.shape[0]) * 480


@pytest.fixture(scope="module")
def tts(port_pipe):
    return t_api.TTS(pipeline=port_pipe)


def test_tts_modes(tts):
    rng = np.random.default_rng(10)
    prompt = synthetic_audio(rng, 0.5, 16000)
    for outs in (list(tts.inference_zero_shot("hello world", "reference",
                                              prompt)),
                 list(tts.inference_zero_shot("hello world", "reference",
                                              prompt, stream=True)),
                 list(tts.inference_cross_lingual("short", prompt)),
                 list(tts.inference_instruct2("short", "speak slowly",
                                              prompt))):
        wav = np.concatenate([o["tts_speech"] for o in outs], axis=1)
        assert wav.ndim == 2 and wav.shape[0] == 1 and wav.shape[1] > 0
        assert np.isfinite(wav).all()
    source = synthetic_audio(rng, 0.8, 16000)
    wav = list(tts.inference_vc(source, prompt))[0]["tts_speech"]
    # the output tracks the source's token count exactly
    assert wav.shape[1] == len(tts.pipeline.extract_prompt_tokens(source)) \
        * 2 * 480


def test_tts_inference_vc_matches_jax(trees, tts):
    """TTS.inference_vc (S3 tokens of the source, flow and DAC; no LM and
    no noise draws) against JAX's TTS on the same weights and audio: the
    same number of samples, PCM within 2 LSB."""
    from minimax_speech_tpu.infer import api as j_api

    jcfg, _ = tiny_port_cfg()
    ref_tts = j_api.TTS(pipeline=j_pl.TTSPipeline(
        jcfg, trees["lm"], trees["flow"], trees["codec"], trees["s3"]))
    rng = np.random.default_rng(12)
    prompt = synthetic_audio(rng, 0.5, 16000)
    source = synthetic_audio(rng, 0.8, 16000)
    ref = list(ref_tts.inference_vc(source, prompt))[0]["tts_speech"]
    ours = list(tts.inference_vc(source, prompt))[0]["tts_speech"]
    assert ours.shape == ref.shape and ours.shape[1] > 0
    assert np.abs(_pcm(ours) - _pcm(ref)).max() <= 2


def test_tts_speaker_cache_round_trip_and_speed(tts, tmp_path):
    rng = np.random.default_rng(11)
    prompt = synthetic_audio(rng, 0.5, 16000)
    assert tts.add_zero_shot_spk("ref text", prompt, "spk_a")
    path = str(tmp_path / "spk2info.npz")
    tts.save_spkinfo(path)
    again = t_api.TTS(pipeline=tts.pipeline)
    again.load_spkinfo(path)
    assert again.list_available_spks() == ["spk_a"]
    for k, v in tts.spk2info["spk_a"].items():
        np.testing.assert_array_equal(again.spk2info["spk_a"][k], v)
    normal = list(again.inference_zero_shot("same words", "", None,
                                            zero_shot_spk_id="spk_a", seed=5))
    cached = list(tts.inference_zero_shot("same words", "", None,
                                          zero_shot_spk_id="spk_a", seed=5))
    np.testing.assert_array_equal(normal[0]["tts_speech"],
                                  cached[0]["tts_speech"])
    fast = list(again.inference_zero_shot("same words", "", None,
                                          zero_shot_spk_id="spk_a", seed=5,
                                          speed=2.0))
    n1 = sum(o["tts_speech"].shape[1] for o in normal)
    n2 = sum(o["tts_speech"].shape[1] for o in fast)
    assert n1 > 0 and abs(n2 - n1 / 2) <= 2


def test_campplus_raises(port_pipe, tmp_path):
    """A missing CAM++ file raises. With the flow's speaker encoder on,
    CAM++ weights load but the conditioning stays the speaker encoder's,
    as in JAX's TTS (the x-vector path is held against JAX in
    tests/test_torch_campplus.py)."""
    import chip_smoke
    from tests.test_campplus import TorchCAMPPlus

    with pytest.raises(FileNotFoundError):
        t_api.TTS(pipeline=port_pipe, campplus=str(tmp_path / "no.onnx"))
    torch.manual_seed(0)
    state = {k: v.numpy() for k, v in TorchCAMPPlus(
        80, 192, 32, 4, 128, 32, (12, 24, 16), (1, 2, 2)).state_dict()
        .items()}
    path = chip_smoke.write_onnx(tmp_path / "campplus.onnx", state)
    prompt = synthetic_audio(np.random.default_rng(13), 0.5, 16000)
    with_cp = t_api.TTS(pipeline=port_pipe, campplus=str(path))
    assert with_cp.xvector(prompt).shape == (1, 192)
    with_cp.add_zero_shot_spk("", prompt, "a")
    plain = t_api.TTS(pipeline=port_pipe)
    plain.add_zero_shot_spk("", prompt, "a")
    for k in ("lm_spk", "flow_emb"):
        np.testing.assert_array_equal(with_cp.spk2info["a"][k],
                                      plain.spk2info["a"][k])
