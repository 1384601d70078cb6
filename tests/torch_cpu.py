"""CPU threads for the port's tests.

Torch starts one intra-op thread per core in every process. Under
pytest-xdist each worker does so, and their OpenMP pools spin against
one another: with six workers on eight cores a float64 GAN iteration
ran more than ten times slower than with one thread each. `share_cores`
gives each worker its share of the cores, in this process and in the
CLI subprocesses it starts (OMP_NUM_THREADS)."""
import os

import torch


def share_cores() -> None:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    n = max(1, (os.cpu_count() or 1) // workers)
    os.environ["OMP_NUM_THREADS"] = str(n)
    torch.set_num_threads(n)
