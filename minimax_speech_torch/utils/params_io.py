"""Flat .npz checkpoints in the JAX package's format, and the weight bridge.

The format is the one of ``minimax_speech_tpu/utils/params_io.py``: one
array per flax parameter, keyed by its path joined with ``||``. A file
written by either package loads in the other.

Torch submodules carry the flax module names (``layers_0``,
``self_attn``, ``q_proj``...), so a torch parameter's flax path is its
module path plus a leaf name fixed by the module type:

  Linear     weight (out, in)     <- Dense kernel (in, out), transposed
  Conv1d     weight (out, in/g, k) <- Conv kernel (k, in/g, out)
  ConvTranspose1d weight (in, out, k) <- kernel (k, out, in), the JAX
                      package's transposed-conv layout (ops/safe_conv)
  Conv2d     weight (out, in, kh, kw) <- Conv kernel (kh, kw, in, out)
  LayerNorm, GroupNorm  weight    <- scale
  Embedding  weight               <- embedding
  QuantDense kernel_q (out, in) int8 <- kernel_q (in, out) int8, transposed
  a module's `flax_perm` {name: perm}: same name, torch = flax
                      transposed by perm (the discriminators' WNConv2d v)
  anything else: same name, same layout (RMSNorm weight, rel-pos
  biases, Snake alpha (1, 1, C), weight-norm g/v kept in flax layout,
  QuantDense scale and bias).

Floating leaves travel as float32; integer leaves (QuantDense's int8
kernels) keep their dtype both ways.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

SEP = "||"


def save_params(path: str, module: nn.Module, tensors=None):
    """Write `module`'s weights as flax-layout `{"params": ...}` .npz;
    `tensors`, in named_flax_params order, stand in for its parameters
    (the whole tensors of a tensor-parallel module's slices)."""
    np.savez(path, **{SEP.join(("params",) + p): a
                      for p, a in _to_flax(module, tensors).items()})


def save_tree(path: str, tree: dict):
    """Write a nested variables tree ({"params": ...}, numpy or array-like
    leaves, as the converters of utils/convert.py return) as .npz, keyed
    as the JAX package's save_params keys it."""
    np.savez(path, **{SEP.join(p): np.asarray(a)
                      for p, a in _flatten(tree).items()})


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
    if isinstance(mod, (nn.Conv1d, nn.ConvTranspose1d)) \
            and pname == "weight":
        return ("kernel", lambda a: a.transpose(2, 1, 0),
                lambda a: a.transpose(2, 1, 0))
    if isinstance(mod, nn.Conv2d) and pname == "weight":
        return ("kernel", lambda a: a.transpose(3, 2, 0, 1),
                lambda a: a.transpose(2, 3, 1, 0))
    if isinstance(mod, (nn.LayerNorm, nn.GroupNorm)) and pname == "weight":
        return "scale", lambda a: a, lambda a: a
    if isinstance(mod, nn.Embedding) and pname == "weight":
        return "embedding", lambda a: a, lambda a: a
    if pname == "kernel_q":
        return "kernel_q", lambda a: a.T, lambda a: a.T
    perm = getattr(mod, "flax_perm", {}).get(pname)
    if perm is not None:
        inv = tuple(int(i) for i in np.argsort(perm))
        return (pname, lambda a: a.transpose(perm),
                lambda a: a.transpose(inv))
    return ident


def flax_leaf_name(mod: nn.Module, pname: str) -> str:
    """The flax name of `mod`'s parameter `pname`."""
    return _leaf(mod, pname)[0]


def _params_with_paths(module: nn.Module):
    for mname, mod in module.named_modules():
        prefix = tuple(mname.split(".")) if mname else ()
        for pname, p in mod.named_parameters(recurse=False):
            leaf, to_torch, to_flax = _leaf(mod, pname)
            yield prefix + (leaf,), p, to_torch, to_flax


def named_flax_params(module: nn.Module):
    """(flax path joined by '/', parameter) for every parameter, in
    module order: the names the JAX package's grad pytree carries."""
    return [("/".join(path), p)
            for path, p, _, _ in _params_with_paths(module)]


def _flatten(tree: dict, prefix=()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _numpy(p: torch.Tensor) -> np.ndarray:
    p = p.detach().cpu()
    return (p.float() if p.is_floating_point() else p).numpy()


def _to_flax(module: nn.Module, tensors=None) -> dict:
    leaves = list(_params_with_paths(module))
    tensors = [p for _, p, _, _ in leaves] if tensors is None else tensors
    return {path: np.ascontiguousarray(to_flax(_numpy(t)))
            for (path, _, _, to_flax), t in zip(leaves, tensors)}


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
        arr = np.asarray(flat[path])
        if p.is_floating_point():
            arr = arr.astype(np.float32)
        elif arr.dtype != np.dtype(str(p.dtype).removeprefix("torch.")):
            raise ValueError(f"{'/'.join(path)}: flax {arr.dtype} vs torch "
                             f"{p.dtype}")
        arr = np.asarray(to_torch(arr))
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
    at one and zero). A module that defines `init_weights(generator)`
    initialises its own parameters (a zero-initialised Linear, or
    parameters of its own). Deterministic for a given generator."""
    for mod in module.modules():
        if hasattr(mod, "init_weights"):
            mod.init_weights(generator)
        elif isinstance(mod, (nn.Linear, nn.Conv1d, nn.Conv2d,
                              nn.ConvTranspose1d)):
            w = mod.weight
            fan_in = math.prod(w.shape[1:])
            w.normal_(0.0, fan_in ** -0.5, generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            mod.weight.normal_(0.0, mod.weight.shape[1] ** -0.5,
                               generator=generator)
        elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)) \
                and mod.weight is not None:  # affine-free norms have none
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    return module
