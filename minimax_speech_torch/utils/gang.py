"""A gang of torch.distributed ranks, one process each, that runs jobs.

The multi-process tests and chip_smoke.py's phases 32-33 start a gang
once (its start-up is paid once) and send it jobs. A job is a function
of a named module (the gang's job table), called on every rank with
picklable arguments once the rank has joined the world of `size` ranks
(utils/distributed.initialize with the gang's backend and device); the
gang returns each rank's result in rank order. A rank that raises, or
does not answer within the timeout, fails the call.
"""
from __future__ import annotations

import importlib
import multiprocessing as mp
import os
import queue
import traceback

from minimax_speech_torch.cli.launch import free_port


def _rank_main(rank: int, size: int, port: int, backend, device,
               jobs_module: str, threads, jobs, results):
    import torch

    from minimax_speech_torch.utils import distributed

    if threads:
        torch.set_num_threads(threads)
    table = importlib.import_module(jobs_module)
    distributed.initialize(f"127.0.0.1:{port}", size, rank, backend, device)
    try:
        while True:
            job = jobs.get()
            if job is None:
                return
            name, args = job
            try:
                results.put((rank, True, getattr(table, name)(*args)))
            except Exception:  # noqa: BLE001 - reported to the caller
                results.put((rank, False, traceback.format_exc()))
    finally:
        distributed.shutdown()


class Gang:
    """`size` ranks over `backend` on `device` ("cpu", or "cuda": rank r
    on cuda:(r % device_count)), started here. run(name, *args) calls
    `jobs_module`.`name` on every rank and returns the ranks' results in
    rank order. threads: torch's and OpenMP's threads a rank (ranks that
    share the cores with every thread each run ten times slower on the
    CPU); None leaves the defaults."""

    def __init__(self, size: int, jobs_module: str, backend=None,
                 device="cuda", threads=None, timeout: float = 600):
        ctx = mp.get_context("spawn")
        self.size, self.timeout = size, timeout
        port = free_port()
        self.jobs = [ctx.Queue() for _ in range(size)]
        self.results = ctx.Queue()
        env = os.environ.get("OMP_NUM_THREADS")
        if threads:  # read by the ranks' OpenMP at start-up
            os.environ["OMP_NUM_THREADS"] = str(threads)
        try:
            self.procs = [ctx.Process(target=_rank_main, daemon=True, args=(
                r, size, port, backend, device, jobs_module, threads,
                self.jobs[r], self.results)) for r in range(size)]
            for p in self.procs:
                p.start()
        finally:
            if env is None:
                os.environ.pop("OMP_NUM_THREADS", None)
            else:
                os.environ["OMP_NUM_THREADS"] = env

    def run(self, name: str, *args) -> list:
        for q in self.jobs:
            q.put((name, args))
        out = {}
        for _ in range(self.size):
            try:
                rank, ok, res = self.results.get(timeout=self.timeout)
            except queue.Empty:
                raise RuntimeError(f"gang job {name}: a rank did not answer "
                                   f"within {self.timeout} s") from None
            if not ok:
                raise RuntimeError(f"gang job {name}, rank {rank}:\n{res}")
            out[rank] = res
        return [out[r] for r in range(self.size)]

    def close(self):
        for q in self.jobs:
            q.put(None)
        for p in self.procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join(timeout=30)
