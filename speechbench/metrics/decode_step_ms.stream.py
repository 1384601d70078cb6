"""LM decode (models/llm.py `decode_step_rows`, models/qwen2.py): the
host milliseconds of the window's decode bursts (each ends in a copy to
the host) over their steps."""


def read(rec):
    spans = rec.get("spans", {}).get("burst", [])
    if rec.get("kind") != "stream" or not spans:
        return None
    return 1000.0 * sum(e - s for s, e in spans) / (len(spans)
                                                    * rec["token_hop"])
