"""Run one cell of the benchmark of minimax_speech_torch on this machine.

    python3 -m speechbench.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. The cell (BENCHMARK.json's `workloads`)
names a configuration (its file under speechbench/configs) and a
traffic mix (speechbench/traffic/<name>.json), whose `driver` names the
module under speechbench/drivers that runs it. With --trace 0 the
result's metrics are the cell's end-to-end metrics; with --trace 1 its
per-layer metrics, each read by speechbench/metrics/<name>.py from the
run's spans, counters and profiler trace. The last line of standard
output is one JSON object; the numbers the output check compared, each
with its limit, are the last lines of standard error and the result's
last key.

Exits 3 without a CUDA device (or fewer than the cell asks for), 4
without the program beside the benchmark, 5 if JAX or the JAX package
got loaded, and prints no result then.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "speechbench"
CACHE = ROOT / "build" / "speechbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "minimax_speech_tpu")


def process_start() -> float:
    """The process's start on the time.perf_counter clock (from
    /proc/self/stat), so that set-up counts the interpreter's start."""
    now_pc, now_up = time.perf_counter(), None
    try:
        with open("/proc/uptime") as f:
            now_up = float(f.read().split()[0])
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return now_pc - (now_up - started)
    except (OSError, ValueError, IndexError):
        return now_pc


T_PROCESS = process_start()


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def set_cache_dirs():
    """Fixed cache directories inside the checkout, so that a cell's
    later runs in it reuse what its first built (the port builds its
    kernels under build/kernels itself)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ.setdefault("USE_FLAX", "0")


class Context:
    """One run: its arguments, cell, configuration, mix, and what the
    driver records."""

    def __init__(self, args, manifest, cell, config, mix, device):
        self.args = args
        self.seed = int(args.seed)
        self.seconds = float(args.seconds)
        self.trace = bool(args.trace)
        self.manifest = manifest
        self.cell = cell
        self.workload = cell["name"]
        self.config = config
        self.traffic = mix
        self.device = device
        self.t0 = T_PROCESS
        self.window_start = None
        self.memory_peak_bytes = 0
        self.attempted = self.failed = 0
        self.notes = {}  # printed to stderr before the checks
        from speechbench.spans import Recorder
        from speechbench.trace import TraceWindow
        self.recorder = Recorder(trace=self.trace)
        self.tracer = TraceWindow() if self.trace else None


def find(items, name, what):
    for it in items:
        if it["name"] == name:
            return it
    raise SystemExit(f"speechbench: no {what} named {name!r}")


def metric_reader(name: str):
    """The reader of per-layer metric `name`: read(record) -> number or
    None, from speechbench/metrics/<name>.py."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "speechbench_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def per_layer(manifest, cell, record) -> dict:
    out = {}
    for m in manifest["per_layer"]:
        if "workloads" in m and cell["name"] not in m["workloads"]:
            continue
        value = metric_reader(m["name"])(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def end_to_end(manifest, cell, e2e: dict, setup_s: float) -> dict:
    out = {}
    for m in manifest["end_to_end"]:
        if "workloads" in m and cell["name"] not in m["workloads"]:
            continue
        value = setup_s if m["name"] == "setup_s" else e2e.get(m["name"])
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def loaded_forbidden() -> list:
    return sorted({n.split(".")[0] for n in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    args = parse(argv)
    set_cache_dirs()
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = find(manifest["workloads"], args.workload, "workload")
    cfg_entry = find(manifest["configs"], cell["config"], "configuration")
    config = json.loads((ROOT / cfg_entry["file"]).read_text())
    from speechbench import traffic
    mix = traffic.load(cell["traffic"])

    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"speechbench: the cell needs {cell['chips']} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    if importlib.util.find_spec("minimax_speech_torch") is None:
        print("speechbench: minimax_speech_torch, the system under test, is "
              "not beside the benchmark", file=sys.stderr)
        return 4
    torch.set_num_threads(4)
    ctx = Context(args, manifest, cell, config, mix, torch.device("cuda", 0))
    driver = importlib.import_module(f"speechbench.drivers.{mix['driver']}")
    result = driver.measure(ctx)
    return report(ctx, result)


def report(ctx, result: dict, out=None, err=None) -> int:
    """Print the compared numbers (stderr) and the result line (stdout);
    refuse if JAX or the JAX package is loaded."""
    out, err = out or sys.stdout, err or sys.stderr
    bad = loaded_forbidden()
    if bad:
        print(f"speechbench: the run loaded {', '.join(bad)}; the benchmark "
              f"measures the PyTorch port alone", file=err)
        return 5
    import torch
    setup_s = ctx.window_start - ctx.t0
    if ctx.trace:
        metrics = per_layer(ctx.manifest, ctx.cell, result["record"])
    else:
        metrics = end_to_end(ctx.manifest, ctx.cell, result["e2e"], setup_s)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": ctx.cell["chips"],
              "memory_peak_bytes": int(ctx.memory_peak_bytes)}
    line = {"correct": bool(result["correct"]),
            "attempted": int(ctx.attempted), "failed": int(ctx.failed),
            "metrics": metrics, "device": device}
    trace = result.get("record", {}).get("trace")
    if ctx.trace and trace is not None:
        device["busy_s"] = trace["busy_s"]
        device["window_s"] = trace["window_s"]
        line["breakdown"] = {"device_ops": trace["device_ops"],
                             "idle_gaps": trace["idle_gaps"]}
    line["checks"] = result["checks"]
    notes = dict(ctx.notes, end_s=time.perf_counter() - ctx.t0)
    print("notes " + json.dumps(notes, default=float), file=err)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=err)
    print(json.dumps(line), file=out)
    out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
