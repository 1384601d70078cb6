"""The port's spans and request stamps (utils/logging.py).

CPU, no JAX: the recorder off and on, its spans as torch.profiler ranges
on the profiler's clock (off, bare ranges while a profiler records), the stamps of a tiny `ContinuousBatcher.run`,
and the spans of one LM train step over the port's data stages.
"""
import json

import numpy as np
import pytest
import torch

from minimax_speech_torch import config
from minimax_speech_torch.data import pipeline as dp
from minimax_speech_torch.infer.continuous import ContinuousBatcher
from minimax_speech_torch.infer.pipeline import TTSPipeline
from minimax_speech_torch.infer.serving import Request
from minimax_speech_torch.models import llm as llm_mod
from minimax_speech_torch.train import schedule, steps
from minimax_speech_torch.utils import logging as tlog
from minimax_speech_torch.utils import params_io
from tests import torch_cpu

torch_cpu.share_cores()

STAMPS = ("due", "submit", "grant", "first_audio")
STEP_SPANS = ("train.forward", "train.backward", "train.optim",
              "train.norms")


@pytest.fixture(autouse=True)
def tracing_off():
    """Every test starts and ends with tracing off and nothing kept."""
    tlog.disable()
    tlog.take()
    yield
    tlog.disable()
    tlog.take()


def names(spans):
    return [s[0] for s in spans]


def test_off_span_is_one_shared_no_op_and_records_nothing():
    a, b = tlog.span("a"), tlog.span("b", rid=3)
    assert a is b
    with a:
        with b:
            tlog.stamp(1, "submit")
    assert tlog.take() == {"spans": [], "stamps": {}}


def test_off_spans_are_bare_ranges_under_a_profiler(tmp_path):
    """Off, a span under a recording profiler is a user_annotation range
    of its name, nested as the code nests it, and nothing is kept; once
    the profiler stops, `span` is the shared no-op again."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tlog.span("outer", rid=1):
            with tlog.span("inner"):
                torch.ones(8) @ torch.ones(8)
        tlog.stamp(1, "submit")
    assert tlog.span("a") is tlog.span("b")
    assert tlog.take() == {"spans": [], "stamps": {}}
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    ranges = {e["name"]: (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
              for e in events if e.get("ph") == "X"
              and e.get("cat") == "user_annotation"}
    assert set(ranges) == {"outer", "inner"}
    (o0, o1), (i0, i1) = ranges["outer"], ranges["inner"]
    assert o0 <= i0 <= i1 <= o1


def test_on_spans_nest_with_parents_and_carry_rid():
    tlog.enable()
    with tlog.span("outer", rid=7):
        with tlog.span("inner"):
            with tlog.span("leaf", rid=7):
                pass
        with tlog.span("second"):
            pass
    tlog.stamp(7, "grant", t=1.0)
    tlog.stamp(7, "grant", t=2.0)  # the first stamp stands
    got = tlog.take()
    by = {s[0]: s for s in got["spans"]}
    assert names(got["spans"]) == ["leaf", "inner", "second", "outer"]
    assert by["outer"][3] is None and by["outer"][4] == 7
    assert by["inner"][3] == "outer" and by["inner"][4] is None
    assert by["leaf"][3] == "inner" and by["leaf"][4] == 7
    assert by["second"][3] == "outer"
    for name, start, end, _, _ in got["spans"]:
        assert start <= end
    o, i, leaf = by["outer"], by["inner"], by["leaf"]
    assert o[1] <= i[1] <= leaf[1] <= leaf[2] <= i[2] <= o[2]
    assert got["stamps"] == {7: {"grant": 1.0}}
    assert tlog.take() == {"spans": [], "stamps": {}}


def test_spans_are_profiler_ranges_on_its_clock(tmp_path):
    """Every span kept in memory is a user_annotation range of the CPU
    profiler's trace, starting within 0.1 ms of its recorded start once
    the one offset between the clocks is read from the first range."""
    tlog.enable()
    x = torch.ones(64, 64)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for k in range(3):
            with tlog.span("outer", rid=k):
                with tlog.span("matmul"):
                    x = x @ x / 64.0
                with tlog.span("sum"):
                    x.sum()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    ranges = sorted((float(e["ts"]) * 1e-6, e["name"]) for e in events
                    if e.get("ph") == "X"
                    and e.get("cat") == "user_annotation")
    spans = sorted((s[1], s[0]) for s in tlog.take()["spans"])
    assert len(spans) == 9
    assert [n for _, n in ranges] == [n for _, n in spans]
    offset = ranges[0][0] - spans[0][0]
    for (ts, _), (start, _) in zip(ranges, spans):
        assert abs(ts - offset - start) < 1e-4


def _requests(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        p_len = 6 + 2 * i
        femb = rng.standard_normal(cfg.flow.spk_embed_dim)
        out.append(Request(
            text_tokens=rng.integers(1, cfg.lm.qwen.vocab_size, 2),
            prompt_text_tokens=rng.integers(1, cfg.lm.qwen.vocab_size, 3),
            prompt_speech_tokens=rng.integers(0, cfg.lm.speech_token_size,
                                              p_len),
            prompt_feat=rng.standard_normal(
                (cfg.token_latent_ratio * p_len, cfg.flow.output_size))
            .astype(np.float32),
            lm_spk=(rng.standard_normal(cfg.lm.llm_input_size) / 8.0)
            .astype(np.float32),
            flow_emb=(femb / np.linalg.norm(femb)).astype(np.float32)))
    return out


@pytest.fixture(scope="module")
def tiny_pipe():
    import dataclasses
    cfg = config.load_tts_config("configs/tiny.yaml")
    # 12 speech tokens for every 2-token text
    cfg = dataclasses.replace(cfg, max_speech_tokens=12,
                              min_token_text_ratio=6.0,
                              max_token_text_ratio=6.0)
    return TTSPipeline.from_random(cfg, device="cpu")


def test_continuous_run_stamps_each_stream_in_order(tiny_pipe):
    """Three staggered arrivals through two lanes on the simulated clock:
    every stream is stamped due <= submit <= grant <= first_audio, and
    the tick spans hold their children."""
    reqs = _requests(tiny_pipe.cfg, 3)
    b = ContinuousBatcher(tiny_pipe, slots=2, token_hop=4, lookahead=2,
                          overlap_frames=2, prompt_buckets=(32, 64),
                          generator=torch.Generator().manual_seed(0))
    tlog.enable()
    events = list(b.run([(0.0, reqs[0]), (0.0, reqs[1]), (0.05, reqs[2])]))
    got = tlog.take()
    assert {ev.stream for _, ev in events} == {0, 1, 2}
    stamps = got["stamps"]
    assert sorted(stamps) == [0, 1, 2]
    for rid, st in stamps.items():
        assert sorted(st) == sorted(STAMPS), st
        t = [st[k] for k in STAMPS]
        assert t == sorted(t), (rid, st)
    spans = got["spans"]
    n_ticks = names(spans).count("serve.tick")
    assert n_ticks >= 3
    prefills = [s for s in spans if s[0] == "lm.prefill"]
    assert sorted(s[4] for s in prefills) == [0, 1, 2]
    parents = {(s[0], s[3]) for s in spans}
    for child, parent in [("serve.admit", "serve.tick"),
                          ("lm.prefill", "serve.admit"),
                          ("prefill.plan", "lm.prefill"),
                          ("prefill.lm", "lm.prefill"),
                          ("prefill.write", "lm.prefill"),
                          ("decode.burst", "serve.tick"),
                          ("decode.sample", "decode.burst"),
                          ("decode.step", "decode.burst"),
                          ("decode.sync", "decode.burst"),
                          ("serve.hop", "serve.tick"),
                          ("hop.flow", "serve.hop"),
                          ("hop.codec", "serve.hop"),
                          ("hop.copy", "serve.hop"),
                          ("hop.cut", "serve.hop")]:
        assert (child, parent) in parents, (child, parent)
    bursts = names(spans).count("decode.burst")
    assert names(spans).count("decode.step") == 4 * bursts
    assert names(spans).count("decode.sample") == 4 * bursts


def _samples(lm_cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        s_len = int(rng.integers(5, 12))
        out.append({
            "text_token": rng.integers(1, lm_cfg.qwen.vocab_size,
                                       int(rng.integers(2, 6))).tolist(),
            "speech_token": rng.integers(0, lm_cfg.speech_token_size,
                                         s_len).tolist(),
            "speech_latent": np.zeros((2 * s_len, 0), np.float32),
            "reference_mels": [rng.standard_normal(
                (int(rng.integers(8, 20)), 80)).astype(np.float32)]})
    return out


def test_lm_train_step_opens_each_phase_once_a_step():
    """Two LM train steps on the CPU over the port's data stages:
    train.forward, .backward, .optim and .norms once each per step under
    train.step; data.pad once a batch, open under no other span."""
    cfg = config.load_tts_config("configs/tiny.yaml").lm
    model = llm_mod.SpeechLM(cfg)
    params_io.init_params(model, torch.Generator().manual_seed(0))
    model.train()
    state = steps.make_train_state(model, schedule.make_optimizer(
        lr=1e-3, warmup_steps=0))
    step = steps.make_lm_train_step(model, device="cpu")
    tlog.enable()
    feed = dp.padding_llm(dp.dynamic_batch(iter(_samples(cfg, 12)), 40),
                          mix_ratio=tuple(cfg.mix_ratio),
                          eos=cfg.eos_token, fill=cfg.fill_token)
    n_steps = 2
    keys = ("src_type", "tok_id", "target", "seq_len", "reference_mel",
            "reference_mel_len")
    for _ in range(n_steps):
        hb = next(feed)
        state, metrics = step(state, {k: torch.as_tensor(hb[k])
                                      for k in keys})
    assert torch.isfinite(metrics["loss"])
    spans = tlog.take()["spans"]
    assert names(spans).count("train.step") == n_steps
    for name in STEP_SPANS:
        mine = [s for s in spans if s[0] == name]
        assert len(mine) == n_steps, name
        assert all(s[3] == "train.step" for s in mine), name
    data = [s for s in spans if s[0].startswith("data.")]
    assert names(data) == ["data.pad"] * n_steps
    assert all(s[3] is None for s in data)
