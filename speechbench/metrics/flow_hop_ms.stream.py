"""Streaming flow (infer/stream_batch.py `flow_audio`: models/flow.py,
cfm.py, decoder_unet.py, upsample_encoder.py): the mean milliseconds of
one hop's flow call in the window, its codec call taken out."""


def read(rec):
    sp = rec.get("spans", {})
    hops, codec = sp.get("hop", []), sp.get("codec", [])
    if rec.get("kind") != "stream" or not hops:
        return None
    total = sum(e - s for s, e in hops) - sum(e - s for s, e in codec)
    return 1000.0 * total / len(hops)
