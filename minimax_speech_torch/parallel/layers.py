"""Tensor-parallel layers on plain local tensors (Megatron-style), and
`shard_module`, which puts a full module on its rank's slices.

Each collective inside the model is a torch.autograd.Function, so the
backward issues the matching collective and torch.utils.checkpoint's
recompute repeats the forward's:

  copy_to_tp      identity forward; the gradient summed over tp (the
                  input of a column-parallel layer, replicated, feeds
                  each rank's slice)
  reduce_from_tp  the sum over tp forward; identity backward (the
                  output of a row-parallel layer or a vocab-parallel
                  lookup)
  gather_from_tp  the slices of the last dim concatenated over tp;
                  backward keeps this rank's slice (the logits)

A bias the rules leave replicated is added once: after the all-reduce of
a row-parallel layer; a column-parallel layer adds its slice of it, and
that bias's gradient is summed over tp by the step (LeafLayout.partial).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from minimax_speech_torch.parallel.collectives import all_gather_cat
from minimax_speech_torch.parallel.mesh import (GATHERED, Mesh,
                                                attention_heads,
                                                param_layouts)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.n = group, x.shape[-1]
        return all_gather_cat(x, group, -1)

    @staticmethod
    def backward(ctx, g):
        r = dist.get_rank(ctx.group)
        return g[..., r * ctx.n:(r + 1) * ctx.n].contiguous(), None


def copy_to_tp(x, group):
    return _CopyToTP.apply(x, group)


def reduce_from_tp(x, group):
    return _ReduceFromTP.apply(x, group)


def gather_from_tp(x, group):
    return _GatherFromTP.apply(x, group)


class ColumnParallelLinear(nn.Linear):
    """Rows [lo, hi) of a Linear's weight (its output features). The bias
    is this rank's slice, or, replicated (`bias_slice`), sliced here.
    gather: the output concatenated over tp, else this rank's slice."""

    def setup(self, group, bias_slice, gather: bool):
        self.group, self.bias_slice, self.gather = group, bias_slice, gather
        return self

    def forward(self, x):
        b = self.bias
        if b is not None and self.bias_slice is not None:
            b = b[self.bias_slice]
        y = F.linear(copy_to_tp(x, self.group), self.weight, b)
        return gather_from_tp(y, self.group) if self.gather else y


class RowParallelLinear(nn.Linear):
    """Columns [lo, hi) of a Linear's weight (its input features), on
    this rank's slice of the input; the products summed over tp, then the
    whole (replicated) bias added once."""

    def setup(self, group):
        self.group = group
        return self

    def forward(self, x):
        y = reduce_from_tp(F.linear(x, self.weight), self.group)
        return y if self.bias is None else y + self.bias


class VocabParallelEmbedding(nn.Embedding):
    """Rows [lo, lo + n) of an embedding table: ids outside them look up
    zeros, and the lookups are summed over tp."""

    def setup(self, group, lo: int):
        self.group, self.lo = group, lo
        return self

    def forward(self, ids):
        local = ids - self.lo
        inside = (local >= 0) & (local < self.num_embeddings)
        e = F.embedding(torch.where(inside, local, torch.zeros_like(local)),
                        self.weight)
        e = torch.where(inside[..., None], e, torch.zeros_like(e))
        return reduce_from_tp(e, self.group)


def _slice(t: torch.Tensor, dim: int, rank: int, n: int) -> torch.Tensor:
    size = t.shape[dim] // n
    return t.narrow(dim, rank * size, size)


def _sharded(cls, old: nn.Module, weight, bias):
    """A module of class `cls` holding `weight` and `bias` (copies) on
    old's device, in place of old's parameters."""
    new = cls.__new__(cls)
    nn.Module.__init__(new)
    for k, v in vars(old).items():
        if not k.startswith("_"):
            setattr(new, k, v)
    new.weight = nn.Parameter(weight.detach().clone(),
                              requires_grad=old.weight.requires_grad)
    if isinstance(old, nn.Linear):
        new.register_parameter(
            "bias", None if bias is None else nn.Parameter(
                bias.detach().clone(), requires_grad=old.bias.requires_grad))
    return new


def shard_module(module: nn.Module, mesh: Mesh, kind: str) -> list:
    """Put `module` (full weights, in place) on this rank's tensor-parallel
    slices under the `kind` rules, swapping each split Linear or Embedding
    for its parallel twin. Returns the LeafLayout of every parameter, in
    named_flax_params order. With tp = 1 the module is left as it is."""
    layouts = param_layouts(module, mesh, kind)
    if mesh.tp == 1:
        return layouts
    by_path = {lay.path: lay for lay in layouts}
    g, r, n = mesh.tp_group, mesh.tp_rank, mesh.tp
    swaps, skipped_heads = [], set()
    for name, mod in module.named_modules():
        prefix = name.replace(".", "/")
        if isinstance(mod, nn.Linear):
            w = by_path[f"{prefix}/kernel"].tp_dim
            bl = by_path.get(f"{prefix}/bias")
            if w == 0:    # output features: column-parallel
                gather = name.split(".")[-1] in GATHERED
                bias_split = bl is not None and bl.tp_dim == 0
                bias = None if mod.bias is None else (
                    _slice(mod.bias, 0, r, n) if bias_split else mod.bias)
                new = _sharded(ColumnParallelLinear, mod,
                               _slice(mod.weight, 0, r, n), bias)
                size = mod.out_features // n
                new.out_features = size
                new.setup(g, None if bias_split or bias is None
                          else slice(r * size, (r + 1) * size), gather)
                swaps.append((name, new))
            elif w == 1:  # input features: row-parallel
                new = _sharded(RowParallelLinear, mod,
                               _slice(mod.weight, 1, r, n), mod.bias)
                new.in_features = mod.in_features // n
                swaps.append((name, new.setup(g)))
        elif isinstance(mod, nn.Embedding):
            if by_path[f"{prefix}/embedding"].tp_dim == 0:
                size = mod.num_embeddings // n
                new = _sharded(VocabParallelEmbedding, mod,
                               _slice(mod.weight, 0, r, n), None)
                new.num_embeddings = size
                swaps.append((name, new.setup(g, r * size)))
        heads = attention_heads(mod)
        if heads and any(h % n for h in heads[0]):
            skipped_heads.add(type(mod).__name__)
    for name, new in swaps:
        parent, _, child = name.rpartition(".")
        setattr(module.get_submodule(parent) if parent else module, child,
                new)
    for cls in sorted(skipped_heads):
        if mesh.is_main:
            print(f"[tp] {cls}: tp = {n} does not divide its heads; its "
                  f"q/k/v/o projections stay replicated (the MLP is "
                  f"split)")
    return _mark_partial(layouts, module)


def _mark_partial(layouts, module) -> list:
    """layouts with `partial` set on the replicated biases of
    column-parallel layers."""
    partial = {f"{name.replace('.', '/')}/bias"
               for name, mod in module.named_modules()
               if isinstance(mod, ColumnParallelLinear)
               and mod.bias is not None and mod.bias_slice is not None}
    return [dataclasses.replace(lay, partial=lay.path in partial)
            for lay in layouts]
