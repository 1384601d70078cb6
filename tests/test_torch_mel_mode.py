"""The mel output mode (HiFT vocoder) of the port against the JAX package's,
on every synthesis and serving path.

CPU, float32, configs/tiny.yaml with model.output_type=mel (flow to an
80-bin mel, HiFT 64 wide with up rates 8, 5, 3), at most MAX_TOKENS
speech tokens. The weights are the port's seeded init, jittered, written
as flax trees and loaded by both packages. Random weights leave f0 far
below HiFT's 10 Hz voicing threshold, which would make the sine source
exactly 0; so the f0 classifier's bias is set to F0_HZ (drawn from the
seed in [100, 300]) in both trees, and each path asserts that at least
half of the frames HiFT sees are voiced. Both sides get the same prompt,
text and decode noise (JAX's own draws, rebuilt from its keys), so the
token ids must be identical and the PCM within PCM_TOL_LSB of it.

PCM_TOL_LSB, derived:
- 2 LSB, the latent mode's limit (tests/test_torch_pipeline.py): float32
  sums in other orders through LM, flow and vocoder;
- plus the harmonic phases. JAX cumsums f h / sr in float32, the port
  in float64: tests/test_torch_hift.py holds each within
  chip_smoke.phase_tol(n, S) cycles of a float64 cumsum, so they lie
  within twice that of each other, n = MAX_TOKENS * 2 * 480 samples and
  S at most n (nb_harmonics + 1) F0_HZ / sr cycles. Each harmonic's 0.1
  sin moves by at most 0.1 * 2 pi times that, the merge tanh(w . sines)
  by sum|w| times that, and the waveform by the decode's gain from source to waveform,
  which tests/test_torch_hift.py holds under chip_smoke.DECODE_GAIN. The
  flow's mel differs by float32 noise between the packages and moves f0
  with it; at these lengths that drift stays well below the bound.
"""
import base64
import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minimax_speech_torch import config as t_config
from minimax_speech_torch.cli import synthesize as t_cli
from minimax_speech_torch.infer import api as t_api
from minimax_speech_torch.infer import pipeline as t_pl
from minimax_speech_torch.infer import session as t_sess
from minimax_speech_torch.infer.bistream import BistreamDecoder
from minimax_speech_torch.infer.continuous import ContinuousBatcher
from minimax_speech_torch.infer.frontend import Frontend
from minimax_speech_torch.infer.serving import BatchSynthesizer, Request
from minimax_speech_torch.infer.stream_batch import BatchStreamingSession
from minimax_speech_torch.models import hifigan as t_h
from minimax_speech_torch.models.flow import flow_inference
from minimax_speech_torch.utils import params_io as t_io
from minimax_speech_tpu import config as j_config
from minimax_speech_tpu.infer import api as j_api
from minimax_speech_tpu.infer import continuous as j_cont
from minimax_speech_tpu.infer import pipeline as j_pl
from minimax_speech_tpu.infer import serving as j_serving
from minimax_speech_tpu.infer import session as j_sess
from minimax_speech_tpu.infer import stream_batch as j_sb
from minimax_speech_tpu.infer.bistream import BistreamDecoder as JBistream
from chip_smoke import DECODE_GAIN, phase_tol
from tests.conftest import synthetic_audio
from tests.test_torch_bridge import jitter
from tests.test_torch_continuous import bistream_noise, continuous_noise
from tests.test_torch_lm import jax_decode_noise
from tests import torch_cpu

torch_cpu.share_cores()

MAX_TOKENS = 24
# Every utterance makes 3 speech tokens per text token. HiFT keeps
# tiny.yaml's widths and up rates (480 samples per frame) with one
# resblock of one dilation per stage. Both keep the JAX side's programs
# few and small: it compiles one for each new shape
OVERRIDES = ["model.output_type=mel", f"model.max_speech_tokens={MAX_TOKENS}",
             "model.min_token_text_ratio=3.0",
             "model.max_token_text_ratio=3.0",
             "model.hift.resblock_kernel_sizes=[3]",
             "model.hift.resblock_dilations=[[1]]",
             "model.hift.source_resblock_kernel_sizes=[3, 3, 3]",
             "model.hift.source_resblock_dilations=[[1], [1], [1]]"]
F0_HZ = float(np.random.default_rng(7).uniform(100.0, 300.0))
HOP = dict(token_hop=5, lookahead=3, overlap_frames=2)


def pcm_tol(hift_tree, cfg) -> int:
    """PCM_TOL_LSB of the module docstring for these weights."""
    n = MAX_TOKENS * 2 * 480
    s_max = n * (cfg.hift.nb_harmonics + 1) * F0_HZ / cfg.hift.sampling_rate
    w = np.abs(hift_tree["params"]["source_linear"]["kernel"]).sum()
    phase = 2 * phase_tol(n, s_max) * 2 * math.pi * cfg.hift.nsf_alpha
    return 2 + math.ceil(32767 * DECODE_GAIN * w * phase)


@pytest.fixture(scope="module")
def both():
    """(port pipeline, JAX pipeline, trees, PCM tolerance in LSB)."""
    pcfg = t_config.load_tts_config("configs/tiny.yaml", OVERRIDES)
    jcfg = j_config.load_tts_config("configs/tiny.yaml", OVERRIDES)
    seed_pipe = t_pl.TTSPipeline.from_random(pcfg, seed=3, device="cpu")
    trees = {name: jitter(t_io.to_flax_params(m), seed=i)
             for i, (name, m) in enumerate(seed_pipe.models().items())}
    trees["codec"]["params"]["f0_predictor"]["classifier"]["bias"][:] = F0_HZ
    port = t_pl.TTSPipeline.from_flax(
        pcfg, *(trees[n] for n in ("lm", "flow", "codec", "s3")),
        device="cpu")
    ref = j_pl.TTSPipeline(jcfg, trees["lm"], trees["flow"], trees["codec"],
                           trees["s3"])
    return port, ref, trees, pcm_tol(trees["codec"], pcfg)


@pytest.fixture
def voiced(both):
    """The f0 of every frame a HiFT f0 predictor of the port sees during
    the test; at least half of them must be voiced."""
    seen = []
    forward = t_h.ConvRNNF0Predictor.forward

    def recorded(self, mel):
        out = forward(self, mel)
        seen.append(out.detach().flatten())
        return out

    t_h.ConvRNNF0Predictor.forward = recorded
    yield seen
    t_h.ConvRNNF0Predictor.forward = forward
    f0 = torch.cat(seen)
    share = float((f0 > both[0].cfg.hift.nsf_voiced_threshold).float().mean())
    print(f"voiced share {share:.3f} of {f0.numel()} frames")
    assert share >= 0.5


def _pcm(w):
    return np.round(np.asarray(w, np.float64) * 32767).astype(np.int32)


def _prompt(port, seed):
    rng = np.random.default_rng(seed)
    a24 = synthetic_audio(rng, 0.6, 24000)
    lm_spk, femb = port.speaker_embedding(port.extract_prompt_mel(a24))
    return (rng.integers(0, 256, 5), rng.integers(0, 256, 3),
            rng.integers(0, 6561, 15), port.extract_prompt_feat(a24),
            lm_spk, femb)


def make_requests(port, seconds, seed, ragged_text=True):
    """Requests of ragged prompts, and ragged texts unless told otherwise
    (streams of one length hop together)."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i, secs in enumerate(seconds):
        a24 = synthetic_audio(rng, secs, 24000)
        lm_spk, femb = port.speaker_embedding(port.extract_prompt_mel(a24))
        reqs.append(Request(
            text_tokens=rng.integers(0, 256, 4 + 2 * i * ragged_text),
            prompt_text_tokens=rng.integers(0, 256, 2 + i % 2),
            prompt_speech_tokens=rng.integers(0, 6561, int(secs * 25)),
            prompt_feat=port.extract_prompt_feat(a24),
            lm_spk=lm_spk.numpy()[0], flow_emb=femb.numpy()[0]))
    return reqs


def pregen_noise(key, lm_cfg, steps: int, b: int, top_shape):
    """The decode noise of JAX's streaming decoders (pregen_noise): step s
    draws its nucleus gumbel `top_shape` from fold_in(fold_in(key, s), 0)
    and its fallback categorical over (b, vocab) from fold_in(fold_in(key,
    s), 1). As tables (steps, b, top_k) and (steps, b, vocab)."""
    def at(s, i):
        return jax.random.fold_in(jax.random.fold_in(key, s), i)
    g_top = np.stack([np.broadcast_to(np.asarray(jax.random.gumbel(
        at(s, 0), top_shape)).reshape(-1, lm_cfg.top_k), (b, lm_cfg.top_k))
        for s in range(steps)])
    g_fb = np.stack([np.asarray(jax.random.gumbel(at(s, 1),
                                                  (b, lm_cfg.vocab)))
                     for s in range(steps)])
    return g_top, g_fb


def test_synthesize_fused_matches_jax(both, voiced):
    """synthesize_fused; the unfused synthesize is held through the
    synthesis CLI below."""
    port, ref, _, tol = both
    text, ptext, ptoks, pmel, lm_spk, femb = _prompt(port, 1)
    assert pmel.shape[1] == 80
    key = jax.random.PRNGKey(11)
    wav_j, tim_j = ref.synthesize_fused(
        text, ptext, ptoks, pmel, jnp.asarray(lm_spk.numpy()),
        jnp.asarray(femb.numpy()), key=key, return_timings=True)
    g_top, g_fb = jax_decode_noise(key, port.cfg.lm, MAX_TOKENS, 1)
    wav_t, tim_t = port.synthesize_fused(
        text, ptext, ptoks, pmel, lm_spk, femb, gumbel_top=g_top,
        gumbel_fallback=g_fb, return_timings=True)
    assert tim_t["tokens"] == tim_j["tokens"] >= 10
    assert len(wav_t) == len(wav_j) == tim_j["tokens"] * 2 * 480
    assert np.abs(_pcm(wav_j)).max() > 300
    assert np.abs(_pcm(wav_t) - _pcm(wav_j)).max() <= tol


@pytest.mark.parametrize("chunked", [True, False])
def test_streaming_session_matches_jax(both, voiced, chunked):
    """Each hop decodes the whole mel so far with the source cache spliced
    in; the tokens come from JAX's TokenStream noise."""
    port, ref, _, tol = both
    text, ptext, ptoks, pmel, lm_spk, femb = _prompt(port, 2)
    key = jax.random.PRNGKey(12)
    kw = dict(HOP, token_hop=8, chunked=chunked)
    ref_chunks = list(j_sess.StreamingSession(ref, **kw).synthesize_stream(
        text, ptext, ptoks, pmel, jnp.asarray(lm_spk.numpy()),
        jnp.asarray(femb.numpy()), key=key))
    g_top, g_fb = pregen_noise(key, port.cfg.lm, MAX_TOKENS, 1,
                               (port.cfg.lm.top_k,))
    sess = t_sess.StreamingSession(port, **kw)
    chunks = list(sess.synthesize_stream(text, ptext, ptoks, pmel, lm_spk,
                                         femb, gumbel_top=g_top,
                                         gumbel_fallback=g_fb))
    assert [(c.tokens, c.final) for c in chunks] == \
        [(c.tokens, c.final) for c in ref_chunks]
    assert len(chunks) >= 2 and sess._src_cache is None
    for c, r in zip(chunks, ref_chunks):
        assert len(c.audio) == len(r.audio)
        assert np.abs(_pcm(c.audio) - _pcm(r.audio)).max() <= tol


def test_batch_synthesizer_matches_jax(both, voiced):
    """3 ragged requests padded to 4; HiFT is not causal, so a padded
    row's last samples see frames past its own mel, in both packages."""
    port, ref, _, tol = both
    reqs = make_requests(port, (0.4, 0.7, 0.56), seed=5)
    key = jax.random.PRNGKey(13)
    wavs_j, tim_j = j_serving.BatchSynthesizer(ref).synthesize_batch(
        [j_serving.Request(**dataclasses.asdict(r)) for r in reqs], key=key,
        return_timings=True)
    g_top, g_fb = jax_decode_noise(key, port.cfg.lm, MAX_TOKENS, 4)
    wavs_t, tim_t = BatchSynthesizer(port).synthesize_batch(
        reqs, gumbel_top=g_top, gumbel_fallback=g_fb, return_timings=True)
    assert tim_t["tokens"] == tim_j["tokens"] and tim_t["batch"] == 4
    for wt, wj, n in zip(wavs_t, wavs_j, tim_j["tokens"]):
        assert len(wt) == len(wj) == n * 960 and n >= 6
        assert np.abs(_pcm(wt) - _pcm(wj)).max() <= tol


def _events(events):
    return [(e.stream, e.tokens, e.final, len(e.audio)) for e in events]


def _same_audio(ours, ref, tol):
    for a, b in zip(ours, ref):
        assert np.abs(_pcm(a.audio) - _pcm(b.audio)).max() <= tol


def test_continuous_batcher_matches_jax(both, voiced):
    """2 requests in 2 lanes, ticked until idle: the same events, each
    lane's audio from the whole batch's flow and HiFT call of its hop."""
    port, ref, _, tol = both
    reqs = make_requests(port, (0.4, 0.6), seed=6, ragged_text=False)
    kw = dict(slots=2, prompt_buckets=(32,), **HOP)
    key = jax.random.PRNGKey(14)
    lm = port.cfg.lm
    jcb = j_cont.ContinuousBatcher(ref, key=key, **kw)
    tcb = ContinuousBatcher(port, noise=continuous_noise(key, 2, lm.top_k,
                                                         lm.vocab), **kw)
    out = {}
    for name, cb, wrap in (("jax", jcb, lambda r: j_serving.Request(
            **dataclasses.asdict(r))), ("port", tcb, lambda r: r)):
        for r in reqs:
            cb.submit(wrap(r))
        events = []
        while cb.busy():
            events += cb.tick()
        out[name] = events
    assert _events(out["port"]) == _events(out["jax"])
    assert sum(e.final for e in out["port"]) == 2 and len(out["port"]) >= 4
    _same_audio(out["port"], out["jax"], tol)


def test_batch_streaming_session_matches_jax(both, voiced):
    port, ref, _, tol = both
    reqs = make_requests(port, (0.4, 0.6), seed=7, ragged_text=False)
    key = jax.random.PRNGKey(15)
    events_j = list(j_sb.BatchStreamingSession(ref, **HOP).run(
        [j_serving.Request(**dataclasses.asdict(r)) for r in reqs], key=key))
    lm = port.cfg.lm
    table = pregen_noise(key, lm, MAX_TOKENS + 8, 2, (2, lm.top_k))
    events_t = list(BatchStreamingSession(port, **HOP).run(
        reqs, noise=lambda burst, s, n: (table[0][s:s + n],
                                         table[1][s:s + n])))
    assert _events(events_t) == _events(events_j)
    assert sum(e.final for e in events_t) == 2 and len(events_t) >= 4
    _same_audio(events_t, events_j, tol)


def test_tts_and_bistream_match_jax(both, voiced):
    """TTS takes the prompt mel as the flow's prompt, and its inference_vc
    (no LM, no noise) gives JAX's TTS's audio. Then the bistream decoder
    (the LM alone) on the mel-mode pipeline's LM gives JAX's ids under
    JAX's noise, and those ids through each package's flow and HiFT with
    that prompt give the same audio (at the vc call's shapes, so that JAX
    reuses its programs)."""
    port, ref, trees, tol = both
    rng = np.random.default_rng(17)
    prompt = synthetic_audio(rng, 0.5, 16000)
    source = synthetic_audio(rng, 0.8, 16000)
    tts, ref_tts = t_api.TTS(pipeline=port), j_api.TTS(pipeline=ref)
    info = tts._prompt_features(prompt)
    np.testing.assert_array_equal(
        info["prompt_feat"], ref_tts._prompt_features(prompt)["prompt_feat"])
    assert info["prompt_feat"].shape[1] == 80
    ours = list(tts.inference_vc(source, prompt))[0]["tts_speech"]
    theirs = list(ref_tts.inference_vc(source, prompt))[0]["tts_speech"]
    assert ours.shape == theirs.shape and ours.shape[1] > 0
    assert np.abs(_pcm(ours) - _pcm(theirs)).max() <= tol

    chunks = [rng.integers(0, 250, 3) for _ in range(4)]
    ptext, pspeech = rng.integers(0, 250, 2), rng.integers(0, 6561, 8)
    key = jax.random.PRNGKey(16)
    ids_j = list(JBistream(ref.lm, trees["lm"], max_steps=MAX_TOKENS)
                 .generate(iter(chunks), ptext, pspeech,
                           jnp.asarray(info["lm_spk"]), key))
    ids_t = list(BistreamDecoder(port.lm, max_steps=MAX_TOKENS, device="cpu")
                 .generate(iter(chunks), ptext, pspeech,
                           torch.as_tensor(info["lm_spk"]),
                           noise=bistream_noise(key, port.cfg.lm.top_k,
                                                port.cfg.lm.vocab)))
    assert ids_t == ids_j and len(ids_j) >= 10
    tokens = np.concatenate([pspeech, ids_t])
    buf = np.zeros((1, t_pl.next_bucket(len(tokens))), np.int32)
    buf[0, : len(tokens)] = tokens
    pf = info["prompt_feat"][None].astype(np.float32)
    feat_j = ref._flow_infer(trees["flow"], jnp.asarray(buf),
                             jnp.array([len(tokens)]), jnp.asarray(pf),
                             info["flow_emb"], ref.noise)
    wav_j = np.asarray(ref._decode(trees["codec"], feat_j))
    with torch.no_grad():
        feat_t = flow_inference(port.flow, buf.astype(np.int64),
                                [len(tokens)], pf,
                                torch.as_tensor(info["flow_emb"]),
                                port.noise, device="cpu")
        wav_t = port.decode(feat_t).numpy()
    assert wav_t.shape == wav_j.shape
    assert np.abs(_pcm(wav_t) - _pcm(wav_j)).max() <= tol


def test_synthesis_cli_mel_mode_matches_jax(both, voiced, tmp_path,
                                            monkeypatch):
    """cli/synthesize.main --override model.output_type=mel on the trees
    written as a checkpoint directory, through the unfused
    TTSPipeline.synthesize with JAX's decode noise for --seed: the wav
    equals JAX's unfused synthesis of the same pieces."""
    port, ref, trees, tol = both
    for name in ("llm", "flow", "codec", "s3"):
        t_io.save_tree(str(tmp_path / f"{name}.npz"),
                       trees["lm" if name == "llm" else name])
    key = jax.random.PRNGKey(0)
    g_top, g_fb = jax_decode_noise(key, port.cfg.lm, MAX_TOKENS, 1)
    synthesize = t_pl.TTSPipeline.synthesize

    def with_jax_noise(self, *a, generator=None, **kw):
        return synthesize(self, *a, gumbel_top=g_top, gumbel_fallback=g_fb,
                          **kw)

    monkeypatch.setattr(t_pl.TTSPipeline, "synthesize", with_jax_noise)
    text = "Hello there."
    out = t_cli.main(["--ckpt_dir", str(tmp_path), "--device", "cpu",
                      "--config", "configs/tiny.yaml", "--text", text,
                      "--out", str(tmp_path / "out.wav")]
                     + sum((["--override", o] for o in OVERRIDES), []))
    tone = t_cli.tone()
    n16 = int(len(tone) * 16000 / 24000)
    a16 = np.interp(np.linspace(0, 1, n16, endpoint=False),
                    np.linspace(0, 1, len(tone), endpoint=False),
                    tone).astype(np.float32)
    ptoks = port.extract_prompt_tokens(a16)
    pmel = port.extract_prompt_mel(tone)
    lm_spk, femb = port.speaker_embedding(pmel)
    fe = Frontend(None)
    pieces = [np.asarray(ref.synthesize(
        fe.extract_text_tokens(p), np.zeros((0,), np.int32), ptoks, pmel,
        jnp.asarray(lm_spk.numpy()), jnp.asarray(femb.numpy()), key=key))
        for p in fe.text_normalize(text)]
    wav_j = np.concatenate(pieces)
    assert out.shape == wav_j.shape and len(out) > 0
    assert np.abs(_pcm(out) - _pcm(wav_j)).max() <= tol


def test_serve_daemon_and_warm_serving_in_mel_mode(both, voiced):
    """cli/serve.py with --override model.output_type=mel and the
    continuous scheduler, its HiFT voiced as above: warm_serving runs
    every serving path and leaves no speaker behind, and /synthesize
    answers with a 24 kHz WAV of 960 samples per token. The port alone:
    the JAX daemon decodes through the same classes held above."""
    import io
    import threading
    import urllib.request
    import wave

    from minimax_speech_torch.cli import serve
    from minimax_speech_torch.infer.warmup import warm_serving

    argv = ["--random_init", "--config", "configs/tiny.yaml", "--device",
            "cpu", "--port", "0", "--scheduler", "continuous", "--slots",
            "2", "--no_warm", "--override", "model.output_type=mel",
            "--override", "model.max_speech_tokens=12"]
    httpd, server, _ = serve.build_server(serve.parse_args(argv))
    hift = server.tts.pipeline.hift
    with torch.no_grad():
        hift.f0_predictor.classifier.bias.fill_(F0_HZ)
    warm_serving(server.tts, scheduler="continuous", slots=2, verbose=False)
    assert server.tts.list_available_spks() == []
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def post(path, payload):
        req = urllib.request.Request(base + path, method="POST",
                                     data=json.dumps(payload).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.read()
    try:
        prompt = synthetic_audio(np.random.default_rng(1), 0.5, 16000)
        post("/register_speaker", {"id": "spk", "wav_b64": base64.b64encode(
            serve.wav_bytes(prompt, 16000)).decode()})
        with wave.open(io.BytesIO(post("/synthesize", {
                "text": "one two three.", "speaker": "spk"}))) as w:
            assert w.getframerate() == 24000
            assert w.getnframes() > 0 and w.getnframes() % 960 == 0
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()
        thread.join(30)
