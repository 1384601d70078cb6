"""Step-indexed checkpoints of a TrainState, in the port's own format.

Port of minimax_speech_tpu/train/checkpoint.py without orbax: a snapshot
is `<directory>/<step>/state.pt`, written by torch.save (module state
dict, optimizer state, step) into a temporary directory that is renamed
into place, so a kill mid-write leaves no partial snapshot under a step
name. The newest `max_to_keep` snapshots stay.

A failed periodic save logs and returns: a missed snapshot costs one
snapshot, not the training job. `restore` walks back from the newest
snapshot past any that does not load.
"""
from __future__ import annotations

import logging
import os
import pickle
import shutil
from pathlib import Path

import torch

from minimax_speech_torch.train.schedule import OptState

STATE_FILE = "state.pt"


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def all_steps(self) -> list[int]:
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.is_dir() and p.name.isdigit())

    def save(self, step: int, state) -> bool:
        """Snapshot `state` (a train.steps.TrainState) at `step`. Returns
        whether a snapshot was written; an existing step is kept."""
        final = self.directory / str(step)
        if final.exists():
            logging.info("checkpoint of step %d exists; kept", step)
            return False
        tmp = self.directory / f".tmp-{step}-{os.getpid()}"
        payload = {"module": state.module.state_dict(),
                   "opt_state": state.opt_state.state_dict(),
                   "step": int(step)}
        try:
            tmp.mkdir(parents=True, exist_ok=True)
            torch.save(payload, tmp / STATE_FILE)
            os.replace(tmp, final)
        except (OSError, RuntimeError, pickle.PicklingError) as e:
            logging.warning("checkpoint save at step %d failed (%s: %s); "
                            "continuing, the next periodic save retries",
                            step, type(e).__name__, e)
            shutil.rmtree(tmp, ignore_errors=True)
            return False
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self.directory / str(old), ignore_errors=True)
        return True

    def restore(self, state):
        """(state, restored step) from the newest snapshot that loads;
        (state, 0) when there is none. The module and optimizer state are
        updated in place."""
        device = next(state.module.parameters()).device
        for s in self.all_steps()[::-1]:
            try:
                payload = torch.load(self.directory / str(s) / STATE_FILE,
                                     map_location=device, weights_only=True)
                state.module.load_state_dict(payload["module"])
                opt = OptState.from_state_dict(payload["opt_state"])
            except Exception as e:  # noqa: BLE001 - a corrupt file raises
                # whatever the unpickler meets; the next snapshot may load
                logging.warning("restore of step %d failed (%s: %s); trying "
                                "the previous snapshot", s, type(e).__name__,
                                e, exc_info=True)
                continue
            state.opt_state = opt
            state.step = int(payload["step"])
            return state, state.step
        return state, 0
