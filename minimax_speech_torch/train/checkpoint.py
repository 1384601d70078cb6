"""Step-indexed checkpoints of a TrainState, in the port's own format.

Port of minimax_speech_tpu/train/checkpoint.py without orbax: a snapshot
is `<directory>/<step>/state.pt`, written by torch.save (module state
dict, optimizer state, step) into a temporary directory that is renamed
into place, so a kill mid-write leaves no partial snapshot under a step
name. The newest `max_to_keep` snapshots stay.

A failed periodic save logs and returns: a missed snapshot costs one
snapshot, not the training job. `restore` walks back from the newest
snapshot past any that does not load.

Under a dp x tp mesh every rank calls `save`: the parameters are gathered
over tp and the optimizer's moments over dp and tp, rank 0 writes the
whole tensors in the one-process format, and a barrier follows. `restore`
loads whole tensors on the CPU and cuts each rank's slices, so a snapshot
written at any world size restores at any other.
"""
from __future__ import annotations

import logging
import os
import pickle
import shutil
from pathlib import Path

import torch

from minimax_speech_torch.parallel.collectives import (full_tensors,
                                                       local_tensor)
from minimax_speech_torch.train.schedule import OptState
from minimax_speech_torch.utils import distributed

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
        whether a snapshot was written; an existing step is kept. Under a
        mesh every rank must call it; rank 0 writes."""
        if state.mesh is None:
            return self._write(step, {
                "module": state.module.state_dict(),
                "opt_state": state.opt_state.state_dict(),
                "step": int(step)})
        # rank 0's view of the directory decides for every rank
        box = [(self.directory / str(step)).exists()]
        distributed.broadcast_object(box)
        if box[0]:
            logging.info("checkpoint of step %d exists; kept", step)
            return False
        payload = _gathered(state, step)
        wrote = self._write(step, payload) if state.mesh.is_main else False
        distributed.sync_hosts()
        return wrote

    def _write(self, step: int, payload: dict) -> bool:
        final = self.directory / str(step)
        if final.exists():
            logging.info("checkpoint of step %d exists; kept", step)
            return False
        tmp = self.directory / f".tmp-{step}-{os.getpid()}"
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
                payload = torch.load(
                    self.directory / str(s) / STATE_FILE,
                    map_location=device if state.mesh is None else "cpu",
                    weights_only=True)
                if state.mesh is not None:
                    payload = _local(state, payload, device)
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


def _gathered(state, step: int) -> dict:
    """The one-process payload of a sharded state: whole tensors, on the
    CPU of rank 0 (every rank runs the collectives)."""
    mesh, main = state.mesh, state.mesh.is_main
    names = [n for n, _ in state.module.named_parameters()]

    def whole(tensors, zero=False):
        if not tensors:
            return []
        out = full_tensors([t.detach() for t in tensors], state.layouts,
                           mesh, zero=zero)
        return [t.cpu() for t in out] if main else [None] * len(out)

    module = state.module.state_dict()
    module.update(zip(names, whole(state.params())))
    opt = state.opt_state.state_dict()
    for key in ("mu", "nu", "acc"):
        opt[key] = whole(opt[key], zero=True)
    return {"module": module, "opt_state": opt, "step": int(step)}


def _local(state, payload: dict, device) -> dict:
    """A one-process payload cut to this rank's slices, on `device`."""
    mesh = state.mesh
    names = [n for n, _ in state.module.named_parameters()]
    module = dict(payload["module"])
    for n, lay in zip(names, state.layouts):
        module[n] = local_tensor(module[n], lay, mesh)
    opt = dict(payload["opt_state"])
    for key in ("mu", "nu", "acc"):
        opt[key] = [local_tensor(t, lay, mesh, zero=True).to(device).clone()
                    for t, lay in zip(opt[key], state.layouts)]
    return {**payload, "module": module, "opt_state": opt}
