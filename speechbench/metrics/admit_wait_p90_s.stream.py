"""Serving scheduler (infer/continuous.py): the 90th percentile, over the
requests due in the window (before a traced run's profiler part), of
the wait from when a request was due to the end of the tick after which
its id holds a lane (batcher.lanes), seconds. A request never admitted
enters as its wait until the run stopped."""
from speechbench.stats import percentile


def read(rec):
    if rec.get("kind") != "stream":
        return None
    c0, c1 = rec["clean"]
    adm, due = rec["admitted"], rec["due"]
    waits = [adm.get(i, rec["t_stop"]) - due[i]
             for i in rec["in_window"] if c0 <= due[i] < c1]
    return percentile(waits, 90) if waits else None
