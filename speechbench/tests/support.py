"""Rehearse a cell on the CPU at the tiny test geometry: the harness's
look for a chip skipped, the rest of a run driven as on the card."""
from __future__ import annotations

import json
import types
from pathlib import Path

import torch

from speechbench import run as harness
from speechbench import traffic

HERE = Path(__file__).resolve().parent
TINY = json.loads((HERE / "tiny.json").read_text())

# the mixes at a size a CPU test holds
SMALL = {
    "stream-open": dict(slots=4, rate_per_s=3.0, lead_s=1.0,
                        drain_max_s=30.0, text_tokens=[1, 2],
                        prompt_speech_tokens=[6, 10],
                        prompt_text_tokens=[2, 4], greedy_every=2,
                        check_requests=2, token_hop=5, lookahead=3,
                        overlap_frames=2, prompt_buckets=[32, 64]),
    "train-dynamic": dict(pool=64, text_tokens=[2, 8], text_median=4,
                          speech_tokens=[5, 20], speech_median=10,
                          reference_mel_frames=[8, 20], shuffle=32, sort=16,
                          block_tokens=256),
}


def context(workload: str, seed: int = 3, seconds: float = 2.0,
            config: dict | None = None, mix: dict | None = None):
    manifest, cell, real = cell_of(workload)
    base = traffic.load(cell["traffic"])
    mix = {**base, **SMALL.get(cell["traffic"], {}), **(mix or {})}
    cfg = json.loads(json.dumps(config or TINY))
    cfg["model"]["output_type"] = real["model"]["output_type"]
    args = types.SimpleNamespace(workload=workload, seed=seed,
                                 seconds=seconds, trace=0)
    return harness.Context(args, manifest, cell, cfg, mix,
                           torch.device("cpu"))


def cell_of(workload: str):
    """(the manifest, the cell, its configuration file's content)."""
    manifest = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    cell = harness.find(manifest["workloads"], workload, "workload")
    path = harness.BENCH / "configs" / f"{cell['config']}.json"
    return manifest, cell, json.loads(path.read_text())
