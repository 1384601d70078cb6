"""The collectives the training step runs outside the model, on
collectives that both NCCL and gloo take for CUDA tensors (all-reduce,
all-gather, broadcast), so that two ranks sharing one card over gloo run
the code NCCL runs:

  all_reduce_buckets   the sum over a group of many tensors, flattened
                       into buckets of at most BUCKET elements
  zero_slice           this dp rank's slice of a leaf (its ZeRO-2 share)
  gather_zero          every leaf split over dp rebuilt on every dp rank
                       from the ranks' updated slices
  full_tensors         leaves gathered whole (over dp for a moment's
                       ZeRO-2 split, then over tp), in flattened buckets
  local_tensor         a whole leaf cut to this rank's slice

A group of None (outside torch.distributed) leaves each tensor as it is.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

BUCKET = 1 << 26  # elements per flattened bucket (256 MB in float32)


def all_gather_cat(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' tensors of `group` concatenated along `dim`, in rank
    order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _buckets(tensors):
    """Runs of consecutive tensors of one dtype and device with at most
    BUCKET elements (a larger tensor alone)."""
    run, n = [], 0
    for t in tensors:
        if run and (n + t.numel() > BUCKET or t.dtype != run[0].dtype
                    or t.device != run[0].device):
            yield run
            run, n = [], 0
        run.append(t)
        n += t.numel()
    if run:
        yield run


def all_reduce_buckets(tensors: list, group) -> None:
    """Sum each tensor over `group`, in place."""
    if group is None or dist.get_world_size(group) == 1:
        return
    for run in _buckets(tensors):
        flat = torch.cat([t.reshape(-1) for t in run])
        dist.all_reduce(flat, group=group)
        off = 0
        for t in run:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


def zero_slice(t: torch.Tensor, layout, mesh, rank=None) -> torch.Tensor:
    """dp rank `rank`'s (default: this rank's) slice of the tp-local
    tensor `t` along layout.zero_dim, a view; `t` itself without one."""
    if mesh is None or layout is None or layout.zero_dim is None:
        return t
    z = layout.zero_dim
    n = t.shape[z] // mesh.dp
    return t.narrow(z, (mesh.dp_rank if rank is None else rank) * n, n)


def gather_zero(params: list, layouts: list, mesh) -> None:
    """Rebuild, on every dp rank, each parameter with a ZeRO-2 split from
    the dp ranks' slices (in place)."""
    if mesh is None or mesh.dp_group is None:
        return
    split = [(p, lay) for p, lay in zip(params, layouts)
             if lay.zero_dim is not None]
    for run in _buckets([zero_slice(p, lay, mesh) for p, lay in split]):
        owners = split[:len(run)]
        split = split[len(run):]
        flat = torch.cat([s.reshape(-1) for s in run])
        parts = [torch.empty_like(flat) for _ in range(mesh.dp)]
        dist.all_gather(parts, flat, group=mesh.dp_group)
        for r, part in enumerate(parts):
            if r == mesh.dp_rank:
                continue
            off = 0
            for p, lay in owners:
                s = zero_slice(p, lay, mesh, r)
                s.copy_(part[off:off + s.numel()].view(s.shape))
                off += s.numel()


def _gather_dim(tensors: list, dims: list, group) -> list:
    """Each tensor concatenated along its dim over `group`'s ranks (None:
    left as it is), the split ones gathered in flattened buckets."""
    out = list(tensors)
    todo = [i for i, d in enumerate(dims) if d is not None]
    n = dist.get_world_size(group) if todo else 1
    for run in _buckets([tensors[i].contiguous() for i in todo]):
        idx, todo = todo[:len(run)], todo[len(run):]
        flat = torch.cat([t.reshape(-1) for t in run])
        parts = [torch.empty_like(flat) for _ in range(n)]
        dist.all_gather(parts, flat, group=group)
        off = 0
        for i, t in zip(idx, run):
            out[i] = torch.cat([p[off:off + t.numel()].view_as(t)
                                for p in parts], dim=dims[i])
            off += t.numel()
    return out


def full_tensors(tensors: list, layouts: list, mesh,
                 zero: bool = False) -> list:
    """The whole leaves of this rank's slices `tensors` (ZeRO-2 slices of
    the tp-local tensors with zero=True), aligned with `layouts`; every
    rank must call it. A leaf that needs no gather is returned as it is."""
    if mesh is None:
        return list(tensors)
    out = list(tensors)
    if zero:
        out = _gather_dim(out, [lay.zero_dim for lay in layouts],
                          mesh.dp_group)
    return _gather_dim(out, [lay.tp_dim for lay in layouts], mesh.tp_group)


def local_tensor(full: torch.Tensor, layout, mesh,
                 zero: bool = False) -> torch.Tensor:
    """This rank's slice of the whole leaf `full`: its tp slice, and with
    zero=True its ZeRO-2 slice of that."""
    if mesh is None or layout is None:
        return full
    t = full
    if layout.tp_dim is not None:
        n = t.shape[layout.tp_dim] // mesh.tp
        t = t.narrow(layout.tp_dim, mesh.tp_rank * n, n)
    return zero_slice(t, layout, mesh) if zero else t
