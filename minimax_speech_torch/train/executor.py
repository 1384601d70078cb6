"""Training executor: the epoch loop with periodic save, and cv.

Port of minimax_speech_tpu/train/executor.py for one process. The step
counter is the host's (TrainState.step), so no step waits on the device;
metrics are read (which synchronizes) only on logging steps.

A step that takes random draws (the flow step) gets them from a
torch.Generator on the device seeded with (DRAW_SEED << 32) | global
step, the two words of the key JAX's executor builds from (seed, step): a
resumed run draws what the uninterrupted run would have drawn. cv batch
i draws from seed i, as JAX's PRNGKey(i).
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
        raises without a GPU). make_draws(batch, generator): the draws
        step_fn(state, batch, draws) and cv's loss_fn(state, batch,
        draws) take as their last argument; None for steps without
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

    def _args(self, batch: dict, seed: int) -> tuple:
        """(batch,) or (batch, its draws from a generator seeded `seed`)."""
        if self.make_draws is None:
            return (batch,)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return batch, self.make_draws(batch, gen)

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
            if step % self.logger.log_interval == 0:
                self.logger.log(step, {**metrics,
                                       **self.timer.snapshot_and_reset()})
            if self.ckpt is not None and step % self.save_per_step == 0:
                self.ckpt.save(step, self.state)
        return self.state

    def cv(self, batches: Iterable[dict], loss_fn: Callable,
           max_batches: int = 50) -> dict:
        """Mean of loss_fn(state, batch)'s metrics over up to
        `max_batches` batches, logged as cv/<name>."""
        totals, n = {}, 0
        for i, batch in enumerate(batches):
            if i >= max_batches:
                break
            batch = self.put_batch(batch)
            if batch is None:
                continue
            for k, v in loss_fn(self.state, *self._args(batch, i)).items():
                totals[k] = totals.get(k, 0.0) + float(v)
            n += 1
        out = {f"cv/{k}": v / max(n, 1) for k, v in totals.items()}
        self.logger.log(self.step, out, force=True)
        return out
