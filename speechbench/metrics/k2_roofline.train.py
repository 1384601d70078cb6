"""Kernel K2 (kernels/splash.py, csrc/splash_attention.cu): the least
time of K2's forward and backward calls in the traced steps (causal over
each row's true length, 14 heads of 64, one call each way per layer,
counted by speechbench/roofline.py at 3xTF32's peak for float32) over
K2's device time by kernel name (splash_) in the profiler's trace,
percent."""
from speechbench.readers import kernel_roofline


def read(rec):
    return kernel_roofline(rec, "splash_", "k2_calls")
