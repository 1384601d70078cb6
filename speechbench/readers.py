"""What several per-layer readers share: a kernel's roofline share from
the calls the benchmark saw and the trace's device time, a whole step's
share of the bf16 peak, and the device's idle share."""
from __future__ import annotations

from speechbench import roofline


def kernel_roofline(rec, name_part: str, calls_key: str,
                    peak: float = roofline.PEAK_ATTN_FP32):
    """The least time of the traced window's calls over the device time of
    the kernels whose name holds `name_part`, as a percentage; None
    without a trace or without such kernels. A call is (key lengths,
    heads, head dim, chunk, count[, causal, backward])."""
    trace = rec.get("trace")
    calls = rec.get(calls_key)
    if not trace or not calls:
        return None
    spent = sum(s for n, s in trace["kernel_s"].items() if name_part in n)
    if spent <= 0:
        return None
    least = 0.0
    for call in calls:
        kv, heads, d, chunk, count = call[:5]
        causal = bool(call[5]) if len(call) > 5 else False
        backward = bool(call[6]) if len(call) > 6 else False
        flops, n_bytes = roofline.attention_work(kv, heads, d, 4, chunk,
                                                 causal, backward)
        least += count * roofline.bound_s(flops, n_bytes, peak)
    return 100.0 * least / spent


def mfu(rec):
    """Useful model FLOPs over the time they took (the window, less a
    traced run's profiler part) times the dense bf16 peak, percent."""
    flops, window = rec.get("useful_flops"), rec.get("useful_window_s")
    if not flops or not window:
        return None
    return 100.0 * flops / (window * roofline.PEAK_BF16)


def idle_share(rec):
    """The traced window's share with no device operation, percent."""
    trace = rec.get("trace")
    if not trace or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
