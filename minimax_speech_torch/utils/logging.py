"""Metrics logging: console + JSONL, and per-phase host timers.

Port of minimax_speech_tpu/utils/logging.py for one process: every
`log_interval`-th step (or a forced call) appends one JSON row to
`<directory>/<name>_metrics.jsonl` and prints a short line. `profile`
traces a region with torch.profiler (the JAX package's takes a
jax.profiler trace).
"""
from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path


class MetricsLogger:
    def __init__(self, directory: str, name: str = "train",
                 log_interval: int = 5):
        self.log_interval = log_interval
        d = Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        self.path = d / f"{name}_metrics.jsonl"
        self._t0 = time.time()

    def log(self, step: int, metrics: dict, force: bool = False):
        if step % self.log_interval and not force:
            return
        row = {"step": step, "time": round(time.time() - self._t0, 2)}
        for k, v in metrics.items():
            row[k] = float(v) if hasattr(v, "item") or isinstance(
                v, (int, float)) else v
        with open(self.path, "a") as fh:
            fh.write(json.dumps(row) + "\n")
        head = " ".join(f"{k}={row[k]:.4g}" for k in list(row)[2:8]
                        if isinstance(row[k], float))
        print(f"[step {step}] {head}", flush=True)


class Timer:
    """Accumulating per-phase wall-clock timer."""

    def __init__(self):
        self.totals: dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] = (self.totals.get(name, 0.0)
                                 + time.perf_counter() - t0)

    def snapshot_and_reset(self) -> dict:
        out = {f"time/{k}": v for k, v in self.totals.items()}
        self.totals = {}
        return out


@contextlib.contextmanager
def profile(log_dir: str):
    """torch.profiler trace around a code region, the host's and (where
    there is a GPU) the device's activities, written into `log_dir` as a
    TensorBoard / Chrome trace (`*.pt.trace.json`)."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                str(log_dir))):
        yield
