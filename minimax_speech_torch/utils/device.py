"""Device choice for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is wanted and absent — the port never
    drops to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    return dev


def module_device(module: torch.nn.Module) -> torch.device:
    return next(module.parameters()).device


def module_dtype(module: torch.nn.Module) -> torch.dtype:
    return next(module.parameters()).dtype


def check_on(module: torch.nn.Module, device: torch.device, what: str):
    have = module_device(module)
    if have.type != device.type or (device.index is not None
                                    and have.index != device.index):
        raise ValueError(f"{what} lives on {have}, the call asks for {device}")
