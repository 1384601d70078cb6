"""Training data (data/pipeline.py `dynamic_batch`, `padding_llm`): pad
tokens over all tokens of the window's batches (rows padded to the
batch's multiple of 64), percent."""


def read(rec):
    if rec.get("kind") != "train" or not rec["steps"]:
        return None
    total = sum(s["shape"][0] * s["shape"][1] for s in rec["steps"])
    true = sum(sum(s["seq_len"]) for s in rec["steps"])
    return 100.0 * (total - true) / total
