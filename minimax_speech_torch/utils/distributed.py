"""Multi-process helpers: one process per GPU over torch.distributed.

Port of minimax_speech_tpu/utils/distributed.py. The JAX package runs
one process per host over jax.distributed; the port runs one process per
GPU (rank r on cuda:(r % device_count)), each given its coordinator
address, world size and rank (cli/launch.py passes them):

  initialize            the default process group (NCCL on cuda, gloo
                        on the CPU; a caller may name gloo on cuda)
  sync_hosts            a barrier over every rank
  broadcast_object      rank 0's picklable values on every rank
  agree_steps           the smallest of the ranks' counts (all-reduce MIN)
  uneven_join_batches   rounds of `round_size` batches, every rank
                        yielding the shortest rank's count, so that no
                        rank enters a collective the others have left
  tp_shared_batches     the batches of a tensor-parallel group's first
                        rank, broadcast to its peers: the peers of one
                        data-parallel rank run the same batch

Nothing here picks a backend or a device on its own beyond those
defaults; a failed collective raises.
"""
from __future__ import annotations

import datetime
from typing import Iterable, Iterator, Optional

import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(minutes=10)


def initialize(coordinator: str, num_processes: int, process_id: int,
               backend: Optional[str] = None, device=None) -> torch.device:
    """Join the world of `num_processes` ranks at `coordinator`
    (host:port) as rank `process_id`. device: "cuda" (default) or "cpu";
    on cuda the rank takes cuda:(rank % device_count). backend defaults to
    nccl on cuda and gloo on the CPU. Returns the rank's device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=TIMEOUT, **kw)
    return dev


def shutdown():
    if dist.is_initialized():
        dist.destroy_process_group()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def collective_device() -> torch.device:
    """The device the default group's collectives take tensors on: the
    rank's GPU under nccl, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def broadcast_object(box: list, src: int = 0):
    """Rank `src`'s items of `box` on every rank, in place."""
    if world_size() > 1:
        dist.broadcast_object_list(box, src=src,
                                   device=collective_device())


def sync_hosts():
    """A barrier over every rank (around checkpoint writes)."""
    if world_size() > 1:
        dist.barrier()


def agree_steps(local_steps: int) -> int:
    """min(local_steps) over every rank."""
    if world_size() == 1:
        return local_steps
    t = torch.tensor([local_steps], dtype=torch.int64,
                     device=collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return int(t.item())


def uneven_join_batches(batches: Iterable, round_size: int = 8) -> Iterator:
    """Yield only the batches every rank can match step for step: each
    rank buffers up to `round_size` batches, the ranks agree on the
    smallest buffer, each yields that many, and the epoch ends for every
    rank once a buffer comes up short (the longer ranks drop at most
    round_size - 1 batches). One rank passes its batches through."""
    if world_size() == 1:
        yield from batches
        return
    it = iter(batches)
    while True:
        buf = []
        for _ in range(round_size):
            nxt = next(it, None)
            if nxt is None:
                break
            buf.append(nxt)
        agreed = agree_steps(len(buf))
        yield from buf[:agreed]
        if agreed < round_size:
            return


def tp_shared_batches(batches: Optional[Iterable], mesh) -> Iterator:
    """The batches of the first rank of this rank's tensor-parallel group,
    on every rank of the group: that rank iterates `batches` and
    broadcasts each (then an end mark); its peers pass None and receive.
    Without tensor parallelism `batches` passes through."""
    group = None if mesh is None else mesh.tp_group
    if group is None or mesh.tp == 1:
        yield from batches
        return
    src = dist.get_global_rank(group, 0)
    box = [None]
    it = iter(batches) if mesh.tp_rank == 0 else None
    while True:
        if it is not None:
            box[0] = next(it, None)
        dist.broadcast_object_list(box, src=src, group=group,
                                   device=collective_device())
        if box[0] is None:
            return
        yield box[0]
