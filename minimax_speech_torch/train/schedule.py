"""Learning-rate schedules and the optimizer: AdamW with global-norm clip.

Port of minimax_speech_tpu/train/schedule.py. Each schedule is a plain
Python function of the update count (0 for the first update), with the
formulas of the optax schedules the JAX package builds. `make_optimizer`
returns an `Optimizer` that applies, in optax's order and arithmetic:

  accumulation  with accum_steps = k > 1, gradients are averaged over k
                micro-steps (a running mean, as optax.MultiSteps keeps)
                and the update happens on every k-th call; the schedule
                counts updates, not micro-steps;
  clip          optax.clip_by_global_norm: g stays below the limit, else
                g / ||g|| * limit (torch's clip_grad_norm_ divides by
                ||g|| + 1e-6, which differs);
  AdamW         b1 0.9, b2 0.999, eps 1e-8 outside the square root, bias
                correction by the update count, then weight decay
                `weight_decay * p` added to the update, then -lr(count).

Under a dp x tp mesh (parallel/mesh.py) the state is ZeRO-2's: each dp
rank keeps mu, nu and the accumulation buffer for its slice of each leaf
only (LeafLayout.zero_dim), updates that slice of the parameter from the
gradient (whole on every dp rank: the step all-reduces it) and
all-gathers the parameter over dp. The clip's norm is the global batch's
over the whole model: tp-split leaves summed over tp, replicated ones
counted once, dp slices summed over dp.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from minimax_speech_torch.parallel.collectives import gather_zero, zero_slice

Schedule = Callable[[int], float]
B1, B2, EPS = 0.9, 0.999, 1e-8  # AdamW's moment decays and epsilon


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax.linear_schedule: init -> end over `steps`, then end."""
    if steps <= 0:
        return lambda step: init

    def fn(step):
        frac = 1.0 - min(max(step, 0), steps) / steps
        return (init - end) * frac + end
    return fn


def _join(first: Schedule, after: Schedule, boundary: int) -> Schedule:
    """optax.join_schedules: `after` sees steps counted from `boundary`."""
    return lambda step: first(step) if step < boundary \
        else after(step - boundary)


def warmup_constant(lr: float, warmup_steps: int) -> Schedule:
    """Linear lr*1e-3 -> lr over the warmup, then constant."""
    return _join(_linear(lr * 1e-3, lr, warmup_steps), lambda step: lr,
                 warmup_steps)


def warmup_lr(lr: float, warmup_steps: int) -> Schedule:
    """Noam-style: lr * warmup^0.5 * min(step^-0.5, step * warmup^-1.5)."""
    def fn(step):
        s = max(float(step), 1.0)
        return lr * warmup_steps ** 0.5 * min(s ** -0.5,
                                              s * warmup_steps ** -1.5)
    return fn


def cosine_annealing(lr: float, warmup_steps: int, total_steps: int,
                     min_lr: float = 0.0) -> Schedule:
    """optax.warmup_cosine_decay_schedule(0, lr, warmup, total, min_lr)."""
    decay_steps = total_steps - warmup_steps
    if decay_steps <= 0:
        raise ValueError(f"cosine decay needs total_steps > warmup_steps, "
                         f"got {total_steps} and {warmup_steps}")
    alpha = 0.0 if lr == 0.0 else min_lr / lr

    def decay(step):
        c = min(float(step), float(decay_steps))
        cos = 0.5 * (1 + math.cos(math.pi * c / decay_steps))
        return lr * ((1 - alpha) * cos + alpha)
    return _join(_linear(0.0, lr, warmup_steps), decay, warmup_steps)


def constant(lr: float) -> Schedule:
    return lambda step: lr


def _with_warmup(lr: float, warmup_steps: int, after: Schedule) -> Schedule:
    """Linear 0 -> lr, then `after`, which counts from the end of warmup."""
    if warmup_steps <= 0:
        return after
    return _join(_linear(0.0, lr, warmup_steps), after, warmup_steps)


def square_annealing(lr: float, warmup_steps: int, max_steps: int,
                     min_lr: float = 0.0) -> Schedule:
    def fn(step):
        frac = min(max((max_steps - step) / max_steps, 0.0), 1.0)
        return max(lr * frac ** 2, min_lr)
    return _with_warmup(lr, warmup_steps, fn)


def squareroot_annealing(lr: float, warmup_steps: int, max_steps: int,
                         min_lr: float = 0.0) -> Schedule:
    def fn(step):
        frac = min(max((max_steps - step) / max_steps, 0.0), 1.0)
        return max(lr * math.sqrt(frac), min_lr)
    return _with_warmup(lr, warmup_steps, fn)


def squareroot_constant(lr_scale: float, constant_steps: int,
                        min_lr: float = 0.0) -> Schedule:
    """lr_scale / sqrt(constant_steps) held through constant_steps, then
    lr_scale / sqrt(step)."""
    def fn(step):
        s = max(float(step), 1.0)
        lr = lr_scale / (constant_steps ** 0.5 if step <= constant_steps
                         else math.sqrt(s))
        return max(lr, min_lr)
    return fn


def noam_annealing(lr: float, warmup_steps: int, d_model: int = 512,
                   min_lr: float = 0.0) -> Schedule:
    norm = d_model ** -0.5

    def fn(step):
        s = max(float(step), 1.0)
        out = lr * norm * min(s ** -0.5, s * warmup_steps ** -1.5)
        return max(out, min_lr) if s > warmup_steps else out
    return fn


def noam_hold_annealing(lr: float, warmup_steps: int, hold_steps: int,
                        decay_rate: float = 0.5,
                        min_lr: float = 0.0) -> Schedule:
    hold_total = warmup_steps + hold_steps

    def fn(step):
        s = float(step)
        if s <= warmup_steps:
            return lr * s / max(warmup_steps, 1)
        if s <= hold_total:
            return lr
        t_warm = max(1.0, warmup_steps ** decay_rate)
        t_hold = max(1.0, (s - hold_steps) ** decay_rate)
        return max(lr * t_warm / t_hold, min_lr)
    return fn


def polynomial_decay(lr: float, warmup_steps: int, decay_steps: int,
                     power: float = 1.0, min_lr: float = 0.0,
                     cycle: bool = False) -> Schedule:
    def fn(step):
        s = float(step)
        if cycle:
            ds = decay_steps * max(math.ceil(s / decay_steps), 1.0)
        else:
            ds = float(decay_steps)
            s = min(s, ds)
        return (lr - min_lr) * (1.0 - s / ds) ** power + min_lr
    return _with_warmup(lr, warmup_steps, fn)


@dataclass
class OptState:
    """count: updates applied; mu, nu: Adam's moments; acc: the running
    mean of the micro-steps' gradients (accum_steps > 1)."""
    count: int
    mu: list
    nu: list
    mini_step: int = 0
    acc: list = field(default_factory=list)

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu,
                "mini_step": self.mini_step, "acc": self.acc}

    @classmethod
    def from_state_dict(cls, d: dict) -> "OptState":
        return cls(int(d["count"]), list(d["mu"]), list(d["nu"]),
                   int(d["mini_step"]), list(d["acc"]))


def global_norm(tensors, layouts=None, mesh=None,
                zero_sliced: bool = False) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum of every element squared. Under
    a mesh, of the whole leaves that `tensors` (aligned with `layouts`)
    are this rank's slices of: tp slices, and with zero_sliced ZeRO-2
    slices of those."""
    if mesh is None:
        return torch.sqrt(sum(torch.sum(t * t) for t in tensors))
    return global_norms(tensors, [range(len(tensors))], layouts, mesh,
                        zero_sliced)[0]


def global_norms(tensors, subsets, layouts, mesh,
                 zero_sliced: bool = False) -> torch.Tensor:
    """The global norm of each subset (indices into `tensors`) of the
    whole leaves, as global_norm takes them, in two small all-reduces."""
    sq = torch.stack([torch.sum(t * t) for t in tensors])
    # row: 2 * (split over tp) + (a ZeRO-2 slice)
    rows = [2 * (lay.tp_dim is not None)
            + (zero_sliced and lay.zero_dim is not None) for lay in layouts]
    pick = np.zeros((4, len(subsets), len(tensors)), np.float32)
    for j, idx in enumerate(subsets):
        for i in idx:
            pick[rows[i], j, i] = 1.0
    parts = torch.from_numpy(pick).to(sq) @ sq             # (4, subsets)
    dp_part = parts[1::2].contiguous()  # the ZeRO-2 slices: summed over dp
    if mesh.dp_group is not None:
        dist.all_reduce(dp_part, group=mesh.dp_group)
    tp_part = (parts[2] + dp_part[1]).contiguous()   # tp slices: over tp
    if mesh.tp_group is not None:
        dist.all_reduce(tp_part, group=mesh.tp_group)
    return torch.sqrt(parts[0] + dp_part[0] + tp_part)


@dataclass(frozen=True)
class Optimizer:
    schedule: Schedule
    grad_clip: float = 1.0
    weight_decay: float = 0.0
    accum_steps: int = 1

    def init(self, params, layouts=None, mesh=None) -> OptState:
        """Zero moments (and accumulation buffer): under a mesh, for this
        dp rank's ZeRO-2 slice of each leaf."""
        shards = [zero_slice(p, lay, mesh) for p, lay in
                  zip(params, layouts or [None] * len(params))]
        zeros = lambda: [torch.zeros_like(s) for s in shards]  # noqa: E731
        return OptState(0, zeros(), zeros(), 0,
                        zeros() if self.accum_steps > 1 else [])

    @torch.no_grad()
    def apply(self, params: list, grads: list, state: OptState,
              layouts=None, mesh=None) -> bool:
        """Update `params` in place from `grads` (fp32, aligned with
        params). Returns whether an update was applied (False on the
        micro-steps of accumulation). Under a mesh the gradients are the
        global batch's, whole over dp; this rank updates its ZeRO-2 slice
        of each leaf, then the slices are all-gathered over dp."""
        if mesh is not None:
            grads = [zero_slice(g, lay, mesh)
                     for g, lay in zip(grads, layouts)]
        if self.accum_steps > 1:
            n = state.mini_step
            for a, g in zip(state.acc, grads):
                a.add_((g - a) / (n + 1))
            if n < self.accum_steps - 1:
                state.mini_step = n + 1
                return False
            grads = [a.clone() for a in state.acc]
            for a in state.acc:
                a.zero_()
            state.mini_step = 0
        norm = global_norm(grads, layouts, mesh, zero_sliced=True)
        keep = norm < self.grad_clip  # selected on the device: no sync
        grads = [torch.where(keep, g, (g / norm) * self.grad_clip)
                 for g in grads]
        count = state.count + 1
        c1 = 1.0 - B1 ** count
        c2 = 1.0 - B2 ** count
        lr = float(self.schedule(state.count))
        shards = params if mesh is None else [
            zero_slice(p, lay, mesh) for p, lay in zip(params, layouts)]
        for p, g, mu, nu in zip(shards, grads, state.mu, state.nu):
            mu.copy_((1 - B1) * g + B1 * mu)
            nu.copy_((1 - B2) * (g * g) + B2 * nu)
            u = (mu / c1) / (torch.sqrt(nu / c2) + EPS)
            if self.weight_decay:
                u = u + self.weight_decay * p
            p.add_(u * -lr)
        gather_zero(params, layouts, mesh)
        state.count = count
        return True


_SCHEDULES = ("constantlr", "warmuplr", "cosine", "square", "squareroot",
              "noam", "noamhold", "polynomial")


def make_schedule(lr: float, warmup_steps: int, scheduler: str,
                  total_steps: int) -> Schedule:
    if scheduler == "constantlr":
        return warmup_constant(lr, warmup_steps)
    if scheduler == "warmuplr":
        return warmup_lr(lr, warmup_steps)
    if scheduler == "cosine":
        return cosine_annealing(lr, warmup_steps, total_steps)
    if scheduler == "square":
        return square_annealing(lr, warmup_steps, total_steps)
    if scheduler == "squareroot":
        return squareroot_annealing(lr, warmup_steps, total_steps)
    if scheduler == "noam":
        return noam_annealing(lr, warmup_steps)
    if scheduler == "noamhold":
        return noam_hold_annealing(lr, warmup_steps,
                                   hold_steps=total_steps // 10)
    if scheduler == "polynomial":
        return polynomial_decay(lr, warmup_steps, total_steps)
    raise ValueError(f"scheduler {scheduler!r} not in {_SCHEDULES}")


def make_optimizer(lr: float = 5e-5, warmup_steps: int = 500,
                   scheduler: str = "constantlr", weight_decay: float = 0.0,
                   grad_clip: float = 1.0, total_steps: int = 1_000_000,
                   accum_steps: int = 1) -> Optimizer:
    """AdamW + clip (+ accumulation over accum_steps micro-steps)."""
    return Optimizer(make_schedule(lr, warmup_steps, scheduler, total_steps),
                     grad_clip=grad_clip, weight_decay=weight_decay,
                     accum_steps=accum_steps)
