"""Random weights from the seed, made on the device in a few large draws.

The benchmark makes every weight itself and hands the same tensors to
the program and to the plain reference, so neither reads what the other
made. A state dict is drawn from the module's parameter names and
shapes (metadata only): one normal draw for every float leaf, one
integer draw for every int8 kernel, then each leaf is a scaled slice of
them at the scale flax's defaults give (Dense and Conv kernels
lecun-normal, Embed N(0, 1/features), norms at one, biases at zero,
weight-normed convs with g = |v|).

The W8A8 projections' int8 kernels are uniform in [-127, 127] with
per-output-channel scales that give the product the variance of a
lecun-normal kernel. Unit scales (as the port's own random init uses)
make every projection's output ~1e3 times its input, every attention a
hard argmax over scores of ~1e6 and the residual stream ~1e10: no
trained checkpoint looks like that, and its rounding then decides whole
attention rows.
"""
from __future__ import annotations

import math

import torch
from torch import nn

INT8_STD = math.sqrt((255 ** 2 - 1) / 12.0)  # uniform on [-127, 127]


def _kind(mod: nn.Module, pname: str, p: torch.Tensor) -> str:
    """How a leaf is drawn: normal, int8, one, zero, wn_v, wn_g."""
    t = type(mod).__name__
    if pname == "kernel_q":
        return "int8"
    if t == "QuantDense" and pname == "scale":
        return "qscale"
    if t in ("WNConv", "WNConvTranspose"):
        return {"v": "wn_v", "g": "wn_g", "bias": "wn_bias"}[pname]
    if pname == "bias":
        return "zero"
    if t in ("LayerNorm", "GroupNorm", "RMSNorm", "Snake1d"):
        return "one"
    return "normal"


def _std(mod: nn.Module, pname: str, p: torch.Tensor) -> float:
    if isinstance(mod, nn.Embedding):
        return p.shape[1] ** -0.5
    if pname in ("pos_bias_u", "pos_bias_v"):  # xavier's variance
        return math.sqrt(2.0 / sum(p.shape))
    return math.prod(p.shape[1:]) ** -0.5  # (out, in, ...) lecun normal


def make_state(module: nn.Module, seed: int, device,
               float_dtype: torch.dtype = torch.float32) -> dict:
    """A state dict for `module` (its parameter names and shapes), drawn
    from `seed` on `device`; float leaves in `float_dtype` (the type the
    module is served in), int8 kernels as int8."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    leaves = []
    for mname, mod in module.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            leaves.append((name, mod, pname, p, _kind(mod, pname, p)))
    n_float = sum(p.numel() for _, _, _, p, k in leaves
                  if k in ("normal", "wn_v"))
    n_int = sum(p.numel() for _, _, _, p, k in leaves if k == "int8")
    flat = torch.randn(n_float, generator=gen, device=device)
    flat_int = torch.randint(-127, 128, (n_int,), generator=gen,
                             device=device, dtype=torch.int16)
    out, off, off_i, v_of = {}, 0, 0, {}
    for name, mod, pname, p, kind in leaves:
        n = p.numel()
        if kind == "normal":
            t = flat[off:off + n].view(p.shape) * _std(mod, pname, p)
            off += n
        elif kind == "wn_v":
            t = flat[off:off + n].view(p.shape) * math.sqrt(
                mod.init_var / mod.fan_in)
            off += n
            v_of[id(mod)] = t
        elif kind == "int8":
            t = flat_int[off_i:off_i + n].view(p.shape).to(torch.int8)
            off_i += n
        elif kind == "qscale":  # the kernel's product at lecun variance
            fan_in = mod.kernel_q.shape[1]
            t = torch.full(p.shape, fan_in ** -0.5 / INT8_STD, device=device)
        elif kind == "one":
            t = torch.ones(p.shape, device=device)
        elif kind == "wn_bias" and getattr(mod, "bias_init", None) is not None:
            t = torch.as_tensor(mod.bias_init, dtype=torch.float32,
                                device=device).reshape(p.shape)
        else:
            t = torch.zeros(p.shape, device=device)
        out[name] = t if kind == "int8" else t.to(float_dtype)
    for name, mod, pname, p, kind in leaves:  # g = |v| per output
        if kind == "wn_g":
            v = v_of[id(mod)].float()
            out[name] = torch.sqrt(v.square().sum(dim=(0, 1)) + 1e-12) \
                .to(float_dtype)
    return out
