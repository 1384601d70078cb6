"""The system under test: minimax_speech_torch's pipeline built from a
configuration file, holding the benchmark's weights.

Only this module and the drivers import the program. The weights are the
benchmark's (speechbench/weights.py), drawn with the program's modules
as the list of names and shapes; the same state dicts go to the plain
reference afterwards."""
from __future__ import annotations

import copy

import torch

from speechbench import weights

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def tts_data(model: dict, serving: dict | None = None) -> dict:
    """The configuration's model block as the program's TTSConfig takes
    it, with the serving settings applied."""
    data = copy.deepcopy(model)
    if serving is not None:
        q = data["lm"]["qwen"]
        q["quantized"] = bool(serving["lm_quantized"])
        q["act_quant"] = bool(serving["lm_act_quant"])
        data["bf16_flow"] = bool(serving["bf16_flow"])
    return data


def serving_pipeline(model: dict, serving: dict, seed: int, device):
    """(TTSPipeline, state dicts {lm, flow, codec}) for a serving cell:
    the LM in the serving dtype (bfloat16 around W8A8 projections), the
    flow and the vocoder in float32 (or the flow in bfloat16 under
    bf16_flow, as the program casts it)."""
    from minimax_speech_torch.config import build_tts_config
    from minimax_speech_torch.infer.pipeline import TTSPipeline

    cfg = build_tts_config(tts_data(model, serving))
    pipe = TTSPipeline(cfg, device=device)
    lm_dtype = DTYPES[serving["lm_dtype"]]
    pipe.lm.to(lm_dtype)
    codec = pipe.models()["codec"]
    base = int(seed) * 4
    states = {"lm": weights.make_state(pipe.lm, base, device, lm_dtype),
              "flow": weights.make_state(pipe.flow, base + 1, device),
              "codec": weights.make_state(codec, base + 2, device)}
    pipe.lm.load_state_dict(states["lm"])
    pipe.flow.load_state_dict(states["flow"])
    codec.load_state_dict(states["codec"])
    pipe.cast_flow()
    for m in (pipe.lm, pipe.flow, codec):
        m.requires_grad_(False)
    return pipe, states


def request(r):
    """The program's Request for one of the generator's requests."""
    from minimax_speech_torch.infer.serving import Request
    return Request(text_tokens=r.text_tokens,
                   prompt_text_tokens=r.prompt_text_tokens,
                   prompt_speech_tokens=r.prompt_speech_tokens,
                   prompt_feat=r.prompt_feat, lm_spk=r.lm_spk,
                   flow_emb=r.flow_emb)


def sync(device):
    """Wait for the device's queued work (nothing to wait for on the CPU,
    where the tests rehearse a run)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def free(device):
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
