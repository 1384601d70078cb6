"""Serving scheduler (infer/continuous.py): the mean number of occupied
lanes at the end of each tick in the window (before a traced run's
profiler part)."""


def read(rec):
    if rec.get("kind") != "stream":
        return None
    c0, c1 = rec["clean"]
    busy = [n for t, n in rec["ticks"] if c0 <= t < c1]
    return sum(busy) / len(busy) if busy else None
