"""Flat .npz checkpoints in the JAX package's format, and the weight bridge.

The format is the one of ``minimax_speech_tpu/utils/params_io.py``: one
array per flax parameter, keyed by its path joined with ``||``. A file
written by either package loads in the other.

Torch submodules carry the flax module names (``layers_0``,
``self_attn``, ``q_proj``...), so a torch parameter's flax path is its
module path plus a leaf name fixed by the module type:

  Linear     weight (out, in)     <- Dense kernel (in, out), transposed
  Conv1d     weight (out, in/g, k) <- Conv kernel (k, in/g, out)
  LayerNorm, GroupNorm  weight    <- scale
  Embedding  weight               <- embedding
  anything else: same name, same layout (RMSNorm weight, rel-pos
  biases, Snake alpha (1, 1, C), weight-norm g/v kept in flax layout).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

SEP = "||"


def save_params(path: str, module: nn.Module):
    """Write `module`'s weights as flax-layout `{"params": ...}` .npz."""
    np.savez(path, **{SEP.join(("params",) + p): a
                      for p, a in _to_flax(module).items()})


def load_params(path: str) -> dict:
    """.npz -> nested dict of numpy arrays (the flax variables tree)."""
    data = np.load(path, allow_pickle=False)
    tree: dict = {}
    for key in data.files:
        node = tree
        parts = key.split(SEP)
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = data[key]
    return tree


def _leaf(mod: nn.Module, pname: str):
    """(flax leaf name, torch-from-flax, flax-from-torch) for a param."""
    ident = (pname, lambda a: a, lambda a: a)
    if isinstance(mod, nn.Linear) and pname == "weight":
        return "kernel", lambda a: a.T, lambda a: a.T
    if isinstance(mod, nn.Conv1d) and pname == "weight":
        return ("kernel", lambda a: a.transpose(2, 1, 0),
                lambda a: a.transpose(2, 1, 0))
    if isinstance(mod, (nn.LayerNorm, nn.GroupNorm)) and pname == "weight":
        return "scale", lambda a: a, lambda a: a
    if isinstance(mod, nn.Embedding) and pname == "weight":
        return "embedding", lambda a: a, lambda a: a
    return ident


def _params_with_paths(module: nn.Module):
    for mname, mod in module.named_modules():
        prefix = tuple(mname.split(".")) if mname else ()
        for pname, p in mod.named_parameters(recurse=False):
            leaf, to_torch, to_flax = _leaf(mod, pname)
            yield prefix + (leaf,), p, to_torch, to_flax


def _flatten(tree: dict, prefix=()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _to_flax(module: nn.Module) -> dict:
    return {path: np.ascontiguousarray(
        to_flax(p.detach().float().cpu().numpy()))
        for path, p, _, to_flax in _params_with_paths(module)}


def to_flax_params(module: nn.Module) -> dict:
    """Torch module -> nested flax `{"params": ...}` tree of numpy arrays."""
    tree: dict = {}
    for path, a in _to_flax(module).items():
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = a
    return {"params": tree}


@torch.no_grad()
def load_flax_params(module: nn.Module, tree: dict) -> nn.Module:
    """Copy a flax variables tree (numpy or array-like leaves, with or
    without the top-level "params" collection) into `module`, in place.

    Raises if a torch parameter finds no leaf, if a shape disagrees, or
    if any leaf of the tree is left unused."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    flat = _flatten(tree)
    used = set()
    for path, p, to_torch, _ in _params_with_paths(module):
        if path not in flat:
            raise KeyError(f"flax tree has no leaf {'/'.join(path)}")
        arr = np.asarray(to_torch(np.asarray(flat[path], np.float32)))
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{'/'.join(path)}: flax {arr.shape} vs "
                             f"torch {tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.ascontiguousarray(arr)).to(p.dtype))
        used.add(path)
    unused = sorted("/".join(k) for k in set(flat) - used)
    if unused:
        raise KeyError(f"flax leaves left unused: {unused[:8]}"
                       + (" ..." if len(unused) > 8 else ""))
    return module


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights at the scales flax's defaults give (Dense/Conv
    lecun-normal kernels and zero biases, Embed N(0, 1/features), norms
    at one and zero). Modules with parameters of their own define
    `init_weights(generator)`. Deterministic for a given generator."""
    for mod in module.modules():
        if isinstance(mod, (nn.Linear, nn.Conv1d)):
            w = mod.weight
            fan_in = math.prod(w.shape[1:])
            w.normal_(0.0, fan_in ** -0.5, generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            mod.weight.normal_(0.0, mod.weight.shape[1] ** -0.5,
                               generator=generator)
        elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif hasattr(mod, "init_weights"):
            mod.init_weights(generator)
    return module
