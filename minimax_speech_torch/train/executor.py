"""Training executor: the epoch loop with periodic save, and cv.

Port of minimax_speech_tpu/train/executor.py. The step
counter is the host's (TrainState.step), so no step waits on the device;
metrics are read (which synchronizes) only on logging steps.

A step that takes random draws (the flow step) gets them from a
torch.Generator on the device seeded with (DRAW_SEED << 32) | global
step, the two words of the key JAX's executor builds from (seed, step): a
resumed run draws what the uninterrupted run would have drawn. cv batch
i draws from seed i, as JAX's PRNGKey(i).

Under a dp x tp mesh (the state's), one process per rank: each rank puts
its own batch (its dp rank's share of the global batch), draws for the
global batch of dp times its rows from the same seed and keeps its own
rows, so every rank draws what one process draws for the global batch;
rank 0 alone logs, and every rank enters the checkpoint's collectives.
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional

import torch

from minimax_speech_torch.train.checkpoint import CheckpointManager
from minimax_speech_torch.utils.device import check_on, resolve_device
from minimax_speech_torch.utils.logging import MetricsLogger, Timer

DRAW_SEED = 1986  # JAX's Executor's default seed, the first word of its keys


class Executor:
    def __init__(self, step_fn: Callable, state, logger: MetricsLogger,
                 ckpt: Optional[CheckpointManager] = None,
                 save_per_step: int = 2000,
                 put_batch: Optional[Callable] = None, device=None,
                 make_draws: Optional[Callable] = None):
        """The state's module must live on `device` (default cuda, which
        raises without a GPU). make_draws(batch, generator[, rows]): the
        draws step_fn(state, batch, draws) and cv's loss_fn(state, batch,
        draws) take as their last argument (for `rows` rows, default the
        batch's; a value with .rows(start, n)); None for steps without
        draws."""
        self.device = resolve_device(device)
        check_on(state.module, self.device, "the trained model")
        self.step_fn = step_fn
        self.state = state
        self.logger = logger
        self.ckpt = ckpt
        self.save_per_step = save_per_step
        self.put_batch = put_batch or (lambda b: b)
        self.make_draws = make_draws
        self.timer = Timer()

    @property
    def step(self) -> int:
        return self.state.step

    def _args(self, batch: dict, seed: int, split: bool = True) -> tuple:
        """(batch,) or (batch, its draws from a generator seeded `seed`):
        with `split` under a mesh, this dp rank's rows of the global
        batch's draws."""
        if self.make_draws is None:
            return (batch,)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        mesh = self.state.mesh
        if not split or mesh is None or mesh.dp == 1:
            return batch, self.make_draws(batch, gen)
        b = next(iter(batch.values())).shape[0]
        draws = self.make_draws(batch, gen, b * mesh.dp)
        return batch, draws.rows(mesh.dp_rank * b, b)

    @property
    def is_main(self) -> bool:
        return self.state.mesh is None or self.state.mesh.is_main

    def train_one_epoch(self, batches: Iterable[dict]):
        for batch in batches:
            with self.timer("data"):
                batch = self.put_batch(batch)
            if batch is None:  # dropped remainder batch
                continue
            with self.timer("step"):
                args = self._args(batch, (DRAW_SEED << 32) | self.step)
                self.state, metrics = self.step_fn(self.state, *args)
            step = self.state.step
            if step % self.logger.log_interval == 0 and self.is_main:
                self.logger.log(step, {**metrics,
                                       **self.timer.snapshot_and_reset()})
            if self.ckpt is not None and step % self.save_per_step == 0:
                self.ckpt.save(step, self.state)
        return self.state

    def cv(self, batches: Iterable[dict], loss_fn: Callable,
           max_batches: int = 50) -> dict:
        """Mean of loss_fn(state, batch)'s metrics over up to
        `max_batches` batches, logged as cv/<name>. Every rank evaluates
        whole cv batches (cv is not split over dp)."""
        totals, n = {}, 0
        for i, batch in enumerate(batches):
            if i >= max_batches:
                break
            batch = self.put_batch(batch)
            if batch is None:
                continue
            for k, v in loss_fn(self.state,
                                *self._args(batch, i, split=False)).items():
                totals[k] = totals.get(k, 0.0) + float(v)
            n += 1
        out = {f"cv/{k}": v / max(n, 1) for k, v in totals.items()}
        if self.is_main:
            self.logger.log(self.step, out, force=True)
        return out
