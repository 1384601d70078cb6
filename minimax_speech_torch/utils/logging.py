"""Metrics logging: console + JSONL, per-phase host timers, and the
program's spans and request stamps.

Port of minimax_speech_tpu/utils/logging.py for one process: every
`log_interval`-th step (or a forced call) appends one JSON row to
`<directory>/<name>_metrics.jsonl` and prints a short line. `profile`
traces a region with torch.profiler (the JAX package's takes a
jax.profiler trace).

Tracing (off by default): `span(name, rid)` times a region and
`stamp(rid, event)` marks a request's event, both on time.perf_counter.
Off, `span` returns one shared no-op context manager and `stamp` returns
at once; while a torch.profiler is recording, `span` opens a
`torch.profiler.record_function` range of its name all the same, so that
any trace of the program (`profile`'s, or a benchmark's) names the
program's regions on the device trace's clock, and keeps nothing. On
(`enable()`), each span also is kept in memory as (name, start, end,
parent name, rid), in the order the spans close, with its parent from a
per-thread stack, and opens its range with or without a profiler.
`take()` returns what was kept and clears it.
"""
from __future__ import annotations

import contextlib
import json
import threading
import time
from pathlib import Path

from torch._C._autograd import _profiler_enabled
from torch.profiler import record_function

_on = False
_lock = threading.Lock()
_local = threading.local()
_spans: list = []   # (name, start, end, parent, rid)
_stamps: dict = {}  # rid -> {event: time}


class _NoSpan:
    """The span of a program that is not tracing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "rid", "parent", "start", "range")

    def __init__(self, name: str, rid):
        self.name, self.rid = name, rid

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.range = record_function(self.name)
        self.range.__enter__()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        self.range.__exit__(*exc)
        _local.stack.pop()
        with _lock:
            _spans.append((self.name, self.start, end, self.parent,
                           self.rid))
        return False


def span(name: str, rid=None):
    """A context manager that records the region as span `name` (of
    request `rid`) while tracing is on; off, a bare profiler range while a
    profiler records, else the shared no-op."""
    if _on:
        return _Span(name, rid)
    return record_function(name) if _profiler_enabled() else _NO_SPAN


def stamp(rid, event: str, t: float | None = None) -> None:
    """Mark `event` of request `rid` at `t` (now by default, on
    time.perf_counter); the first stamp of an event stands."""
    if not _on:
        return
    t = time.perf_counter() if t is None else t
    with _lock:
        _stamps.setdefault(rid, {}).setdefault(event, t)


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def take() -> dict:
    """{"spans": [(name, start, end, parent, rid)], "stamps": {rid:
    {event: time}}} kept since the last take, which this clears."""
    global _spans, _stamps
    with _lock:
        out = {"spans": _spans, "stamps": _stamps}
        _spans, _stamps = [], {}
    return out


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
    TensorBoard / Chrome trace (`*.pt.trace.json`); the program's spans
    are ranges in it."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                str(log_dir))):
        yield
