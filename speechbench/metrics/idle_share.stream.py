"""The device: the share of the traced window with no kernel, copy or
memset running, percent."""
from speechbench.readers import idle_share


def read(rec):
    return idle_share(rec)
