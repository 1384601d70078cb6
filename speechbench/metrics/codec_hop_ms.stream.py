"""Codec (models/dac_vae.py through the pipeline's `decode`): the mean
milliseconds of one hop's codec call in the window, the device
synchronised at its end."""


def read(rec):
    sp = rec.get("spans", {})
    hops, codec = sp.get("hop", []), sp.get("codec", [])
    if rec.get("kind") != "stream" or not hops or not codec:
        return None
    return 1000.0 * sum(e - s for s, e in codec) / len(hops)
