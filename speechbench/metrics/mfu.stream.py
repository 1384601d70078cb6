"""The whole step: useful model FLOPs of the window (each generated token
once through the LM, each emitted frame once through the flow's encoder
and its 10 CFG Euler steps, each output sample once through the
vocoder) over the window times 989 TFLOP/s, percent."""
from speechbench.readers import mfu


def read(rec):
    return mfu(rec)
