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


def graph_ms(fn, calls: int = 20, replays: int = 5) -> float:
    """Device time in ms of one fn() call on the current CUDA device:
    `calls` calls captured in one CUDA graph, replayed `replays` times
    between CUDA events, so the host's time between launches (the
    kernels' Python wrappers take about as long as the kernels) drops
    out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as required
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)
