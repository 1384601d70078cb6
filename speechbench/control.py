"""The readings that the output check's limits are set from.

    python3 -m speechbench.control --workload NAME --seeds 11,12,13 \
        [--seconds S] [--lower 3] [--out FILE]

For each seed, in one process: the cell's run at `--seconds` (short: the
cell's own load, long enough to finish its longest requests), then the
numbers compared for the program against the plain reference (its sound
readings), and for the first `--lower` seeds the same numbers for the
control: the reference one precision step below what the configuration
states, put in the program's place (the LM's matrix inputs at float8 and
its W8A8 activations at int4 for bfloat16 and int8; the float32 flow and
vocoder at bfloat16; training's float32 with TF32 on). For the training
cell also the fault of a step that leaves out half of each batch. One
JSON line per seed. PERF.md records the readings and the limits set
between them.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import types


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--lower", type=int, default=3)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    from speechbench import run as harness
    harness.set_cache_dirs()
    import torch

    from speechbench import traffic
    manifest = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    cell = harness.find(manifest["workloads"], args.workload, "workload")
    entry = harness.find(manifest["configs"], cell["config"], "configuration")
    config = json.loads((harness.ROOT / entry["file"]).read_text())
    mix = traffic.load(cell["traffic"])
    driver = importlib.import_module(f"speechbench.drivers.{mix['driver']}")
    out = open(args.out, "a") if args.out else None
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        a = types.SimpleNamespace(workload=args.workload, seed=seed,
                                  seconds=args.seconds, trace=0)
        ctx = harness.Context(a, manifest, cell, config, mix,
                              torch.device("cuda", 0))
        run = driver.Run(ctx)
        e2e = run.run()
        run.free_program()
        line = {"workload": args.workload, "seed": seed, "e2e": e2e,
                "sound": run.check()}
        if i < args.lower:
            line["control"] = run.check(lower=True)
            if mix["driver"] == "train":
                line["fault_half_batch"] = run.check(half=True)
        line["device"] = torch.cuda.get_device_name(0)
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
        del run, ctx
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
