"""The knee of the streaming cell's pool: the highest open-loop rate whose
backlog does not grow over a window.

    python3 -m speechbench.sweep --workload dac.stream-open --slots 32,64 \
        --rates 1.5,2.0,2.5 [--seconds 51] [--lead S] [--seed 7] [--out F]

One process builds the pipeline once and runs the cell's driver, with
the mix's own arrival process and lead-in (unless --lead), at each
(slots, rate): the lead-in, then the window. For each it prints one JSON
line: the backlog (requests due and not yet holding a lane) sampled each
second of the window, its least-squares slope in requests per second,
the requests due, TTFA's p50 and p90 and the mean busy lanes. Last, for
each pool, the knee: the highest rate at and below which no swept rate's
backlog grew by more than KNEE_GROWTH requests over the window. The
mix's file takes a rate from it as a
number (PERF.md records the readings); the benchmark's runs never search
for a rate.
"""
from __future__ import annotations

import argparse
import json
import sys
import types

import numpy as np

# a backlog that grows by fewer requests than this over the window has
# not grown: the schedule's own bursts move it by about that much
KNEE_GROWTH = 5.0


def backlog(rec, step: float = 1.0):
    due, adm = rec["due"], rec["admitted"]
    w0, w1 = rec["lead"], rec["lead"] + rec["window_s"]
    ts = np.arange(w0, w1 + 1e-9, step)
    out = []
    for t in ts:
        n_due = int(np.sum(np.asarray(due) <= t))
        n_adm = sum(1 for i, a in adm.items() if a <= t and due[i] <= t)
        out.append(n_due - n_adm)
    slope = float(np.polyfit(ts - w0, out, 1)[0]) if len(ts) > 1 else 0.0
    return [int(x) for x in out], slope


def knee(lines, seconds: float) -> float | None:
    """The highest swept rate at and below which every rate's backlog
    grew by at most KNEE_GROWTH requests over the window of `seconds`;
    None if the lowest already grew."""
    best = None
    for line in sorted(lines, key=lambda x: x["rate_per_s"]):
        if line["backlog_slope_per_s"] * seconds > KNEE_GROWTH:
            break
        best = line["rate_per_s"]
    return best


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", default="dac.stream-open")
    p.add_argument("--slots", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--lead", type=float, default=None)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    from speechbench import run as harness
    harness.set_cache_dirs()
    import torch

    from speechbench import program, traffic
    from speechbench.drivers import stream
    from speechbench.stats import percentile
    manifest = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    cell = harness.find(manifest["workloads"], args.workload, "workload")
    entry = harness.find(manifest["configs"], cell["config"], "configuration")
    config = json.loads((harness.ROOT / entry["file"]).read_text())
    base = traffic.load(cell["traffic"])
    dev = torch.device("cuda", 0)
    pipe, states = program.serving_pipeline(config["model"],
                                            config["serving"], args.seed, dev)
    out = open(args.out, "a") if args.out else None
    lead = base["lead_s"] if args.lead is None else args.lead
    pools = [int(s) for s in args.slots.split(",")]
    rates = [float(r) for r in args.rates.split(",")]
    lines = []
    for slots, rate in ((s, r) for s in pools for r in rates):
        mix = dict(base, slots=slots, rate_per_s=rate, lead_s=lead,
                   drain_max_s=0.0)
        a = types.SimpleNamespace(workload=args.workload, seed=args.seed,
                                  seconds=args.seconds, trace=0)
        ctx = harness.Context(a, manifest, cell, config, mix, dev)
        run = stream.StreamRun(ctx)
        e2e = run.run(pipe, states)
        rec = run.record
        series, slope = backlog(rec)
        w0, w1 = rec["lead"], rec["lead"] + rec["window_s"]
        busy = [n for t, n in rec["ticks"] if w0 <= t < w1]
        line = {"slots": slots, "rate_per_s": rate, "lead_s": lead,
                "due_in_window": len(rec["in_window"]),
                "served_first": sum(1 for i in rec["in_window"]
                                    if i in rec["first"]),
                "backlog": series, "backlog_slope_per_s": slope,
                "ttfa_p50_s": percentile(rec["ttfa"], 50),
                "ttfa_p90_s": e2e["ttfa_p90_s"],
                "stream_rtf_p90": e2e.get("stream_rtf_p90"),
                "lanes_busy": sum(busy) / max(len(busy), 1),
                "tick_s": float(np.mean(np.diff([t for t, _ in rec["ticks"]
                                                  if w0 <= t < w1]))),
                "device": torch.cuda.get_device_name(0)}
        lines.append(line)
        emit(line, out)
        del run, ctx
        torch.cuda.empty_cache()
    for slots in pools:
        emit({"slots": slots, "knee_per_s": knee(
            [x for x in lines if x["slots"] == slots], args.seconds),
            "knee_growth": KNEE_GROWTH}, out)
    return 0


def emit(line, out):
    print(json.dumps(line), flush=True)
    if out:
        out.write(json.dumps(line) + "\n")
        out.flush()


if __name__ == "__main__":
    sys.exit(main())
