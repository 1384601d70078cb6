"""A profiler window over part of the measured window, reduced to what
the per-layer metrics read: the device's busy seconds, each kernel's
device seconds by name, and the idle gaps by the span the host was in.

The profiler (torch.profiler, CUPTI) records CPU and CUDA activity; its
Chrome trace is written to a temporary file, read back and deleted.
Device operations are the events of category kernel, gpu_memcpy and
gpu_memset; busy time is the union of their intervals inside the
window. The spans are the profiler ranges the benchmark's wrappers open
(speechbench/spans.py)."""
from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARK_START, MARK_END = "speechbench_trace_start", "speechbench_trace_end"


class TraceWindow:
    """start() and stop() a profiler; summary() reduces what it saw."""

    def __init__(self):
        self.prof = None
        self.host = None  # (start, end) on time.perf_counter
        self.summary_ = None

    @property
    def active(self) -> bool:
        return self.prof is not None and self.host is None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self._t0 = time.perf_counter()
        with record_function(MARK_START):
            torch.cuda.synchronize()

    def stop(self):
        import torch
        from torch.profiler import record_function
        with record_function(MARK_END):
            torch.cuda.synchronize()
        self.host = (self._t0, time.perf_counter())
        self.prof.stop()

    def summary(self):
        """The window reduced. The trace is exported and read here, once
        the run's timed part is over: done where the profiler stops, the
        export would stall the serving loop that is still draining."""
        if self.summary_ is None and self.prof is not None:
            fd, path = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            try:
                self.prof.export_chrome_trace(path)
                with open(path) as f:
                    events = json.load(f)
            finally:
                os.unlink(path)
            self.prof = None
            evs = (events["traceEvents"] if isinstance(events, dict)
                   else events)
            self.summary_ = reduce_events(evs)
        return self.summary_


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def reduce_events(events) -> dict:
    """Chrome-trace events -> busy_s, window_s, kernel_s (name ->
    seconds), device_ops (top 10), idle_gaps (span name -> seconds,
    top 10). Times in the trace are microseconds."""
    marks, dev, spans = {}, [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        name, cat = e.get("name", ""), e.get("cat", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if name in (MARK_START, MARK_END):
            marks[name] = (ts, ts + dur)
        elif cat in DEVICE_CATS:
            dev.append((name, ts, ts + dur))
        elif cat == "user_annotation" and not name.startswith("ProfilerStep"):
            spans.append((name, ts, ts + dur))
    if MARK_START in marks and MARK_END in marks:
        w0, w1 = marks[MARK_START][0], marks[MARK_END][1]
    elif dev:
        w0, w1 = min(d[1] for d in dev), max(d[2] for d in dev)
    else:
        return {"busy_s": 0.0, "window_s": 0.0, "kernel_s": {},
                "device_ops": [], "idle_gaps": []}
    kernel_s = defaultdict(float)
    inside = []
    for name, s, e in dev:
        s, e = max(s, w0), min(e, w1)
        if e > s:
            kernel_s[name] += (e - s) * 1e-6
            inside.append((s, e))
    busy = _union(inside)
    busy_us = sum(e - s for s, e in busy)
    gaps = []
    cursor = w0
    for s, e in busy:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if w1 > cursor:
        gaps.append((cursor, w1))
    spans.sort(key=lambda x: x[1])
    by_span = defaultdict(float)
    active, j = [], 0
    for g0, g1 in gaps:  # in time order: sweep the spans once
        mid = 0.5 * (g0 + g1)
        while j < len(spans) and spans[j][1] <= mid:
            active.append(spans[j])
            j += 1
        active = [sp for sp in active if sp[2] >= mid]
        owner = min(((e - s, n) for n, s, e in active), default=None)
        by_span[owner[1] if owner else "host"] += (g1 - g0) * 1e-6
    ops = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_us * 1e-6, "window_s": (w1 - w0) * 1e-6,
            "kernel_s": dict(kernel_s),
            "device_ops": [[n[:96], s] for n, s in ops],
            "idle_gaps": sorted(([n, s] for n, s in by_span.items()),
                                key=lambda kv: -kv[1])[:10]}
