"""The whole step: model FLOPs (6 x the non-embedding parameters per true
token, plus the causal attention's forward and backward) of the untraced
steps over their time times 989 TFLOP/s, percent."""
from speechbench.readers import mfu


def read(rec):
    return mfu(rec)
