"""Spans around the calls into the program's layers, recorded from the
benchmark's side: a wrapper bound on the instance replaces one method,
times each call on the host clock and keeps it. In a traced run the
wrapper also synchronises the device at the call's end (so a span holds
its device work) and opens a profiler range under the span's name, which
the trace reduction uses to say what the host was doing in each idle
gap."""
from __future__ import annotations

import time
from collections import defaultdict
from contextlib import nullcontext


class Recorder:
    """Spans: name -> [(start, end)] on the host's clock."""

    def __init__(self, trace: bool = False, clock=time.perf_counter):
        self.trace = trace
        self.clock = clock
        self.spans: dict[str, list] = defaultdict(list)
        self.window = None  # (start, end) on self.clock
        self._bound = []

    def wrap(self, obj, method: str, name: str, sync: bool = False):
        """Replace obj.method by a timed wrapper; `sync` synchronises the
        device at its end in a traced run."""
        inner = getattr(obj, method)
        spans = self.spans[name]
        trace = self.trace
        clock = self.clock
        if trace:
            import torch
            from torch.profiler import record_function
        else:
            record_function = None

        def wrapped(*a, **kw):
            ctx = record_function(name) if trace else nullcontext()
            t0 = clock()
            with ctx:
                out = inner(*a, **kw)
                if trace and sync:
                    torch.cuda.synchronize()
            spans.append((t0, clock()))
            return out

        setattr(obj, method, wrapped)
        self._bound.append((obj, method))
        return wrapped

    def unwrap(self):
        for obj, method in self._bound:
            try:
                delattr(obj, method)
            except AttributeError:
                pass
        self._bound.clear()

    def in_window(self, name: str) -> list:
        """The spans of `name` that start inside the window."""
        if self.window is None:
            return list(self.spans.get(name, ()))
        w0, w1 = self.window
        return [s for s in self.spans.get(name, ()) if w0 <= s[0] < w1]
