"""Warm the serving paths before taking traffic.

Port of minimax_speech_tpu/infer/warmup.py. The JAX package compiles its
serving programs here; PyTorch has no compile cache to fill, but the
first calls on a fresh process pay other one-time costs: the K1 kernel's
build (or the load of its cached library), the CUDA context, cuBLAS's
handles and workspaces, and the caching allocator's first pools at each
batch shape. warm_serving() makes the calls `cli.serve` will make — a
one-shot synthesis, the batched synthesizer at every power-of-two batch
up to max_batch or a continuous batcher, and a streaming synthesis —
with a synthetic speaker that it always removes again.
"""
from __future__ import annotations

import time

import numpy as np
import torch


def _dummy_speaker(tts, seconds: float = 1.0, name: str = "__warm__"):
    rng = np.random.default_rng(0)
    wav = (0.1 * rng.standard_normal(int(16000 * seconds))).astype(
        np.float32)
    tts.add_zero_shot_spk("warmup prompt text.", wav, name)
    return name


def warm_serving(tts, scheduler: str = "window", max_batch: int = 8,
                 slots: int = 4, streaming: bool = True,
                 text: str = "warm up the serving programs.",
                 verbose: bool = True) -> dict:
    """Run the serving paths once. Returns their host seconds: one_shot_s,
    batch{b}_s for each batch size (window) or continuous_s, and
    streaming_s."""
    spk = _dummy_speaker(tts)
    try:
        return _warm(tts, scheduler, max_batch, slots, streaming, text,
                     verbose, spk)
    finally:
        # never leave the dummy speaker registered
        tts.spk2info.pop(spk, None)


def _warm(tts, scheduler, max_batch, slots, streaming, text, verbose, spk):
    from minimax_speech_torch.infer.serving import (BatchSynthesizer,
                                                    request_from_info)
    dev = tts.pipeline.device
    info = tts.spk2info[spk]
    timings = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        timings[name] = time.perf_counter() - t0

    timed("one_shot_s", lambda: list(tts.inference_zero_shot(
        text, "", None, zero_shot_spk_id=spk, stream=False, seed=0)))
    if scheduler == "continuous":
        from minimax_speech_torch.infer.continuous import ContinuousBatcher

        def continuous():
            cb = ContinuousBatcher(
                tts.pipeline, slots=slots,
                generator=torch.Generator(device=dev).manual_seed(0))
            cb.submit(request_from_info(tts, text, info))
            ticks = 0
            while cb.busy() and ticks <= 200:
                cb.tick()
                ticks += 1

        timed("continuous_s", continuous)
    else:
        synth = BatchSynthesizer(tts.pipeline)
        # every power-of-two batch up to max_batch: arrival counts pad up
        # to these shapes
        b = 1
        while True:
            timed(f"batch{b}_s", lambda: synth.synthesize_batch(
                [request_from_info(tts, text, info) for _ in range(b)],
                generator=torch.Generator(device=dev).manual_seed(0)))
            if b >= max_batch:
                break
            b *= 2
    if streaming:
        timed("streaming_s", lambda: list(tts.inference_zero_shot(
            text, "", None, zero_shot_spk_id=spk, stream=True, seed=0)))
    if verbose:
        print(f"[warmup] {sum(timings.values()):.1f}s total: " + ", ".join(
            f"{k}={v:.1f}s" for k, v in timings.items()))
    return timings
