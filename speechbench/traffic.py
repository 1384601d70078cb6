"""The one traffic generator: it reads a mix's parameters from
speechbench/traffic/<name>.json and makes the cell's inputs from the
seed.

Every seed gets the same multiset of sizes and of inter-arrival gaps:
sizes are stratified over their range, gaps are the quantiles of the
exponential distribution at the mix's rate (a Poisson process's gaps,
stratified). A served mix puts both in the order of its own
`schedule_seed`, the same for every seed: one Poisson schedule, bursts
included. The token ids, prompts and speaker vectors are drawn from the
seed. So two seeds do the same work at the same times, and a run-to-run
spread measures the system, not the draw.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"


def load(name: str, directory: Path = TRAFFIC_DIR) -> dict:
    return json.loads((Path(directory) / f"{name}.json").read_text())


def rng_of(seed: int, stream: int = 0) -> np.random.Generator:
    """A numpy generator for `seed` (any non-negative integer) and a
    sub-stream."""
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def stratified_ints(rng, lo: int, hi: int, n: int) -> np.ndarray:
    """n integers covering [lo, hi] evenly, in the seed's order."""
    i = np.arange(n)
    v = lo + np.floor((i + 0.5) * (hi - lo + 1) / n).astype(np.int64)
    return rng.permutation(v)


def stratified_lognormal(rng, lo: int, hi: int, median: float, sigma: float,
                         n: int) -> np.ndarray:
    """n integers at the quantiles of a lognormal (median, sigma) clipped
    to [lo, hi], in the seed's order."""
    from statistics import NormalDist
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    v = np.clip(np.round(median * np.exp(sigma * z)), lo, hi)
    return rng.permutation(v.astype(np.int64))


def schedule_rng(mix: dict, stream: int) -> np.random.Generator:
    """The generator of a served mix's order: its own `schedule_seed`."""
    return rng_of(mix["schedule_seed"], 1000 + stream)


def poisson_gaps(rng, rate: float, n: int) -> np.ndarray:
    """n gaps at the exponential quantiles of `rate`, in `rng`'s
    order."""
    i = np.arange(n)
    return rng.permutation(-np.log1p(-(i + 0.5) / n) / rate)


@dataclass
class SpeechRequest:
    """One synthesis request, as the serving classes take it, plus
    whether its decode is greedy (the requests the output check reads)."""
    text_tokens: np.ndarray
    prompt_text_tokens: np.ndarray
    prompt_speech_tokens: np.ndarray
    prompt_feat: np.ndarray          # (2 * prompt tokens, 80)
    lm_spk: np.ndarray               # (llm_input_size,)
    flow_emb: np.ndarray             # (spk_dim,), unit norm
    greedy: bool = False


def speech_requests(mix: dict, n: int, seed: int, *, text_vocab: int,
                    speech_vocab: int, lm_width: int, feat_dim: int = 80,
                    spk_dim: int = 192, token_latent_ratio: int = 2,
                    stream: int = 1) -> list[SpeechRequest]:
    """n requests: text, prompt speech and prompt text lengths from the
    mix's ranges (stratified), every `greedy_every`-th request greedy."""
    order = schedule_rng(mix, stream)
    t_len = stratified_ints(order, *mix["text_tokens"], n)
    p_len = stratified_ints(order, *mix["prompt_speech_tokens"], n)
    pt_len = stratified_ints(order, *mix["prompt_text_tokens"], n)
    rng = rng_of(seed, stream)
    greedy_every = mix.get("greedy_every", 0)
    out = []
    for i in range(n):
        femb = rng.standard_normal(spk_dim)
        out.append(SpeechRequest(
            text_tokens=rng.integers(1, text_vocab, t_len[i]).astype(np.int32),
            prompt_text_tokens=rng.integers(1, text_vocab, pt_len[i])
            .astype(np.int32),
            prompt_speech_tokens=rng.integers(0, speech_vocab, p_len[i])
            .astype(np.int32),
            prompt_feat=rng.standard_normal(
                (token_latent_ratio * p_len[i], feat_dim)).astype(np.float32),
            lm_spk=(rng.standard_normal(lm_width) / math.sqrt(lm_width))
            .astype(np.float32),
            flow_emb=(femb / np.linalg.norm(femb)).astype(np.float32),
            greedy=bool(greedy_every) and i % greedy_every == 0))
    return out


def arrivals(mix: dict, horizon_s: float) -> np.ndarray:
    """Due times (s from the loop's start) of an open loop of Poisson
    arrivals at the mix's rate that covers `horizon_s`: the mix's own
    schedule, whatever the seed."""
    rate = mix["rate_per_s"]
    n = int(math.ceil(rate * horizon_s * 1.1)) + 8
    return np.cumsum(poisson_gaps(schedule_rng(mix, 2), rate, n))


def train_utterances(mix: dict, seed: int, n: int, *, text_vocab: int,
                     speech_vocab: int, mel_dim: int = 80,
                     token_latent_ratio: int = 2) -> list[dict]:
    """n synthetic training samples as the data pipeline hands them to
    its batching stages: text_token, speech_token, a speech_latent whose
    length (2 frames a token) sets the frame budget, and one reference
    mel."""
    rng = rng_of(seed, 3)
    s_len = stratified_lognormal(rng, *mix["speech_tokens"],
                                 mix["speech_median"], mix["speech_sigma"], n)
    t_len = stratified_lognormal(rng, *mix["text_tokens"],
                                 mix["text_median"], mix["text_sigma"], n)
    r_len = stratified_ints(rng, *mix["reference_mel_frames"], n)
    out = []
    for i in range(n):
        out.append({
            "text_token": rng.integers(1, text_vocab, t_len[i]).tolist(),
            "speech_token": rng.integers(0, speech_vocab, s_len[i]).tolist(),
            "speech_latent": np.zeros((token_latent_ratio * s_len[i], 0),
                                      np.float32),
            "reference_mels": [rng.standard_normal((r_len[i], mel_dim))
                               .astype(np.float32)],
        })
    return out
