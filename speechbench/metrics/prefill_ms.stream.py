"""LM prefill (models/llm.py `prefill` through the batcher's
`_prefill_into`): the mean wall milliseconds of one admission's prefill
in the window, the device synchronised at its end."""


def read(rec):
    spans = rec.get("spans", {}).get("prefill", [])
    if rec.get("kind") != "stream" or not spans:
        return None
    return 1000.0 * sum(e - s for s, e in spans) / len(spans)
