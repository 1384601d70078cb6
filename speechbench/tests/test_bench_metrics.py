"""The metric arithmetic: tails over all requests, rates over the whole
window, the roofline and mfu counts against hand-worked numbers, the
trace reduction."""
import math

import pytest

from speechbench import readers, roofline, stats, trace
from speechbench.run import metric_reader


def test_p90_is_over_every_request_and_moves_when_one_stalls():
    ttfa = [1.0, 1.1, 1.2, 1.3, 1.4, 1.5, 1.6, 1.7, 1.8, 1.9]
    assert stats.percentile(ttfa, 90) == 1.8
    stalled = list(ttfa)
    stalled[0] = 30.0  # one request waits 30 s
    assert stats.percentile(stalled, 90) == 1.9
    assert stats.percentile(ttfa, 50) == 1.4
    with pytest.raises(ValueError):
        stats.percentile([], 90)


def test_spread_is_the_quartile_distance_over_the_median():
    v = [10.0, 10.0, 11.0, 12.0, 12.0, 12.0]
    q1, med, q3 = 10.0, 11.5, 12.0
    assert math.isclose(stats.spread(v), (q3 - q1) / med)


def test_train_rate_and_pad_waste_over_the_window():
    rec = {"kind": "train", "steps": [
        {"seq_len": [100, 50], "shape": [2, 128], "traced": False},
        {"seq_len": [64], "shape": [1, 64], "traced": False}]}
    assert math.isclose(metric_reader("pad_waste.train")(rec),
                        100.0 * (320 - 214) / 320)


def test_roofline_counts_by_hand():
    # 4 valid keys: full 16 pairs, chunk 2 -> 2*2 + 2*4, causal 10
    assert roofline.visible_pairs(4) == 16
    assert roofline.visible_pairs(4, chunk=2) == 12
    assert roofline.visible_pairs(5, chunk=2) == 2 * 2 + 2 * 4 + 1 * 5
    assert roofline.visible_pairs(4, causal=True) == 10
    flops, nbytes = roofline.attention_work([4, 2], heads=2, head_dim=8,
                                            elem_bytes=4)
    assert flops == 4 * 8 * 2 * (16 + 4)
    assert nbytes == 4 * (4 + 2) * 2 * 8 * 4
    fb, bb = roofline.attention_work([4], 1, 8, 4, causal=True,
                                     backward=True)
    assert fb == 8 * 8 * 10 and bb == 8 * 4 * 8 * 4
    assert roofline.bound_s(1e12, 1.0, 1e15) == 1e-3
    assert roofline.bound_s(1.0, 3.35e9, 1.0) == 1.0


def test_lm_flops_by_hand():
    q = {"hidden_size": 4, "intermediate_size": 8, "n_heads": 2,
         "n_kv_heads": 1, "head_dim": 2, "n_layers": 3}
    per_layer = 4 * 2 * 2 * 2 + 2 * 4 * 1 * 2 + 3 * 4 * 8
    assert roofline.lm_token_flops(q, 10, ctx=5) == \
        2.0 * (3 * per_layer + 4 * 10) + 4.0 * 3 * 2 * 2 * 5
    n = roofline.lm_nonembedding_params(q, 10)
    assert n == 3 * (4 * 4 + 4 + 2 * (4 * 2 + 2) + 4 * 4 + 3 * 32 + 8) \
        + 4 + 40 + 10


def test_kernel_roofline_and_mfu_and_idle_readers():
    # one call of 2 rows, 4 keys each, 1 head of 8, chunk 0, twice
    flops, nbytes = roofline.attention_work([4, 4], 1, 8, 4)
    least = 2 * roofline.bound_s(flops, nbytes, roofline.PEAK_ATTN_FP32)
    rec = {"k1_calls": [([4, 4], 1, 8, 0, 2)],
           "trace": {"kernel_s": {"void attn_fwd<float, 64>": 4 * least,
                                  "gemm": 1.0},
                     "busy_s": 3.0, "window_s": 4.0}}
    assert math.isclose(readers.kernel_roofline(rec, "attn_fwd", "k1_calls"),
                        25.0)
    assert readers.kernel_roofline({"k1_calls": []}, "attn_fwd",
                                   "k1_calls") is None
    assert math.isclose(readers.idle_share(rec), 25.0)
    assert math.isclose(readers.mfu({"useful_flops": 989e12,
                                     "useful_window_s": 10.0}), 10.0)
    assert readers.mfu({}) is None


def test_trace_reduction_busy_idle_and_owner_of_each_gap():
    ev = [
        {"ph": "X", "name": trace.MARK_START, "cat": "user_annotation",
         "ts": 0.0, "dur": 1.0},
        {"ph": "X", "name": "k1", "cat": "kernel", "ts": 10.0, "dur": 10.0},
        {"ph": "X", "name": "k1", "cat": "kernel", "ts": 15.0, "dur": 10.0},
        {"ph": "X", "name": "copy", "cat": "gpu_memcpy", "ts": 60.0,
         "dur": 5.0},
        {"ph": "X", "name": "burst", "cat": "user_annotation", "ts": 20.0,
         "dur": 50.0},
        {"ph": "X", "name": "hop", "cat": "user_annotation", "ts": 70.0,
         "dur": 30.0},
        {"ph": "X", "name": "aten::mm", "cat": "cpu_op", "ts": 30.0,
         "dur": 2.0},
        {"ph": "X", "name": trace.MARK_END, "cat": "user_annotation",
         "ts": 99.0, "dur": 1.0},
    ]
    s = trace.reduce_events(ev)
    assert math.isclose(s["window_s"], 100e-6)
    assert math.isclose(s["busy_s"], 20e-6)  # [10, 25] and [60, 65]
    assert math.isclose(s["kernel_s"]["k1"], 20e-6)
    gaps = dict(s["idle_gaps"])
    # [0, 10] host, [25, 60] burst, [65, 100] hop (its middle at 82.5)
    assert math.isclose(gaps["host"], 10e-6)
    assert math.isclose(gaps["burst"], 35e-6)
    assert math.isclose(gaps["hop"], 35e-6)
    assert s["device_ops"][0][0] == "k1"


def test_traced_admission_waits_end_before_the_profiler():
    """In a traced stream run every request due in the clean part of the
    window holds a lane before the profiler starts, so none of the
    host-timed waits carries the profiler's slowdown."""
    import torch

    from speechbench.drivers import stream
    from speechbench.tests import support
    torch.set_num_threads(2)
    ctx = support.context("dac.stream-open", seconds=3.0,
                          mix={"trace_s": 1.5, "slots": 16})
    run = stream.Run(ctx)

    class Tracer:
        host = None
        active = False

        def start(self):
            self.active, self.t = True, run.clock()

        def stop(self):
            self.active, self.host = False, (0.0, 0.0)

    ctx.trace, ctx.tracer = True, Tracer()
    run.run()
    rec = run.record
    c0, c1 = rec["clean"]
    t_start = ctx.tracer.t
    assert c0 < c1 <= t_start
    assert run.window == (c0, c1)
    clean = [i for i in rec["in_window"] if c0 <= rec["due"][i] < c1]
    assert clean
    assert all(rec["admitted"][i] <= t_start for i in clean)
