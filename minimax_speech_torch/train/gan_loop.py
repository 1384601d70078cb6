"""The training loop shared by the codec and vocoder GAN CLIs
(cli/train_dac.py, cli/train_hift.py).

Port of the loop of minimax_speech_tpu/cli/train_dac.py and
train_hift.py: two CheckpointManagers, <model_dir>/ckpt_g and ckpt_d,
restored before the data is built (the data is seeded by the restored
step); per iteration the discriminator's step, then the generator's, on
one batch and one set of draws from a generator seeded by the iteration
index; the metrics logged every log_interval iterations, both states
saved every save_iters, and once at the end.

One departure, on purpose: a checkpoint is labelled with the number of
iterations done (its TrainState's step), so a resume continues at the
next iteration. The JAX CLIs label a periodic save with the index of the
iteration just done, one short of its count, and their final save of a
resumed run with start + min(num_iters, i + 1), past num_iters.
"""
from __future__ import annotations

from pathlib import Path
from typing import Callable, Iterable

import torch

from minimax_speech_torch.data.pipeline import prefetch
from minimax_speech_torch.train.checkpoint import CheckpointManager
from minimax_speech_torch.utils.logging import MetricsLogger


class GanRun:
    """The two states of a GAN run and their checkpoints, restored from
    model_dir when it holds any (`start`: the iterations done)."""

    def __init__(self, model_dir: str, g_state, d_state):
        self.ckpt_g = CheckpointManager(str(Path(model_dir) / "ckpt_g"))
        self.ckpt_d = CheckpointManager(str(Path(model_dir) / "ckpt_d"))
        self.g_state, self.start = self.ckpt_g.restore(g_state)
        self.d_state, _ = self.ckpt_d.restore(d_state)
        self.model_dir = model_dir

    def save(self, step: int):
        self.ckpt_g.save(step, self.g_state)
        self.ckpt_d.save(step, self.d_state)

    def train(self, batches: Iterable[dict], gen_step, disc_step,
              draws: Callable, device, name: str, num_iters: int,
              log_interval: int = 10, save_iters: int = 1000,
              prefetch_depth: int = 2,
              after_step: Callable | None = None) -> int:
        """Run iterations from `start` to num_iters over `batches` (dicts
        of numpy arrays or tensors); draws(batch, generator) gives the
        iteration's draws; after_step(step, batch), if given, runs after
        each iteration. Returns the iterations done."""
        logger = MetricsLogger(self.model_dir, name=name,
                               log_interval=log_interval)
        step = self.start
        if step < num_iters:
            for batch in prefetch(batches, prefetch_depth):
                batch = {k: torch.as_tensor(v).to(device)
                         for k, v in batch.items()}
                gen = torch.Generator(device=device).manual_seed(step)
                dr = draws(batch, gen)
                self.d_state, dm = disc_step(self.d_state, batch, dr)
                self.g_state, gm = gen_step(self.g_state, batch, dr)
                if step % log_interval == 0:
                    logger.log(step, {**gm, **dm}, force=True)
                if after_step is not None:
                    after_step(step, batch)
                step += 1
                if step % save_iters == 0 or step >= num_iters:
                    self.save(step)
                if step >= num_iters:
                    break
        return step
