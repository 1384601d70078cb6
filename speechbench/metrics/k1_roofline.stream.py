"""Kernel K1 (kernels/flash_attention.py, csrc/flash_attention.cu): the
least time of K1's calls in the traced window (their key lengths and
masks as the benchmark handed them to the flow, counted by
speechbench/roofline.py at 3xTF32's peak for float32) over K1's device
time by kernel name (attn_fwd) in the profiler's trace, percent."""
from speechbench.readers import kernel_roofline


def read(rec):
    return kernel_roofline(rec, "attn_fwd", "k1_calls")
