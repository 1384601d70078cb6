"""The comparison that decides `correct`: what the timed path produced,
against the plain reference (speechbench/reference) run on the same
inputs and weights once the window has closed.

Each number compared has its limit in speechbench/limits/<cell>.json;
`PERF.md` gives the readings each limit was set from. `lower=True`
builds the control: the reference one precision step below what the
configuration states, put in the program's place.
"""
from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import torch

from speechbench.reference import llm as ref_llm
from speechbench.reference import models as ref_models

LIMITS_DIR = Path(__file__).resolve().parent / "limits"


def load_limits(workload: str, directory: Path = LIMITS_DIR) -> dict:
    return json.loads((Path(directory) / f"{workload}.json").read_text())


NOT_READ = 1e30  # a number the check could not read (none, or not finite)


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every limited number read and within its limit, {name: {value,
    limit}}). A number missing or not finite reads NOT_READ and fails."""
    out, ok = {}, True
    for name, limit in limits.items():
        v = float(numbers.get(name, math.nan))
        if not math.isfinite(v):
            v = NOT_READ
        ok &= v <= limit
        out[name] = {"value": v, "limit": limit}
    return bool(ok), out


def rel_err(a, b) -> float:
    """|a - b| / |b| over all elements (float64)."""
    a = torch.as_tensor(a).double()
    b = torch.as_tensor(b).double()
    den = torch.linalg.vector_norm(b)
    return float(torch.linalg.vector_norm(a - b) / torch.clamp(den, 1e-30))


class LMReference:
    """The plain LM (and its control) over whole plans."""

    def __init__(self, model: dict, state: dict, serving: dict, device,
                 lower: bool = False):
        cfg = ref_models.build_lm_config(
            model, quantized=serving["lm_quantized"],
            act_quant=serving["lm_act_quant"], lower=lower)
        self.cfg = cfg
        self.model = ref_models.load(
            ref_models.on(device, lambda: ref_llm.SpeechLM(cfg)), state,
            device)
        self.device = device
        self.min_ratio = model["min_token_text_ratio"]

    @torch.no_grad()
    def served_logits(self, r, served: np.ndarray) -> torch.Tensor:
        """(T, V) logits, float32, that predict each served token, every
        id above eos and eos while fewer than min_len tokens are out set
        to -inf (the draw's masks)."""
        src, tok, n = ref_llm.build_inference_plan(
            np.concatenate([r.prompt_text_tokens, r.text_tokens]),
            r.prompt_speech_tokens, use_spk=self.cfg.use_speaker_encoder)
        n = int(n[0])
        t = len(served)
        src = np.concatenate([src[0], np.full(t, ref_llm.SRC_SPEECH)])
        tok = np.concatenate([tok[0], np.asarray(served, np.int64)])
        dev = self.device
        logits = self.model.plan_logits(
            torch.as_tensor(src[None], device=dev).long(),
            torch.as_tensor(tok[None], device=dev).long(),
            torch.tensor([n + t], device=dev),
            torch.as_tensor(r.lm_spk[None], device=dev).float())[0]
        pred = logits[n - 1: n - 1 + t].float()
        eos = self.cfg.eos_token
        ids = torch.arange(pred.shape[1], device=dev)
        min_len = int(len(r.text_tokens) * self.min_ratio)
        pred = pred.masked_fill(ids[None] > eos, float("-inf"))
        early = torch.arange(t, device=dev)[:, None] < min_len
        return pred.masked_fill(early & (ids[None] == eos), float("-inf"))


def served_gap(ref: torch.Tensor, served) -> float:
    """The widest gap by which a served token's reference logit lies
    below the reference's best at its position."""
    s = torch.as_tensor(np.asarray(served, np.int64), device=ref.device)
    best = ref.max(dim=-1).values
    got = ref.gather(1, s[:, None])[:, 0]
    return float((best - got).max())


def control_gap(ref: torch.Tensor, ctrl: torch.Tensor) -> float:
    """The same gap for the token the control puts first."""
    return served_gap(ref, ctrl.argmax(dim=-1).cpu().numpy())


def flow_reference(model: dict, state: dict, device,
                   dtype=torch.float32):
    from speechbench.reference import flow as ref_flow
    fcfg = ref_models.build_flow_config(model)
    return ref_models.load(ref_models.on(
        device, lambda: ref_flow.FlowModel(fcfg)), state, device, dtype)


def vocoder_reference(model: dict, state: dict, device, dtype=torch.float32):
    return ref_models.load(ref_models.on(
        device, lambda: ref_models.vocoder(model)), state, device, dtype)


@torch.no_grad()
def flow_latents(flow_model, tokens: np.ndarray, prompt_feat: np.ndarray,
                 flow_emb: np.ndarray, streaming: bool,
                 device) -> torch.Tensor:
    """The plain flow's output (2 * len(tokens), 80), float32, for one
    request's [prompt | generated] tokens."""
    from speechbench.reference import flow as ref_flow
    noise = fixed_noise(flow_model.cfg.output_size, device)
    n = len(tokens)
    out = ref_flow.flow_inference_batched(
        flow_model, torch.as_tensor(np.asarray(tokens, np.int64)[None]),
        torch.tensor([n]), torch.as_tensor(prompt_feat[None]),
        torch.tensor([prompt_feat.shape[0]]),
        torch.as_tensor(flow_emb[None]), noise, streaming=streaming,
        device=device)
    return out[0].float()


_NOISE = {}


def fixed_noise(n_feats: int, device) -> torch.Tensor:
    """The flow's fixed start-noise table (1, 15000, n_feats)."""
    key = (n_feats, str(device))
    if key not in _NOISE:
        from speechbench.reference import cfm
        _NOISE[key] = torch.as_tensor(cfm.make_fixed_noise(
            15000, n_feats)[None], device=device)
    return _NOISE[key]


def _round(x, dtype):
    if torch.is_tensor(x) and x.is_floating_point():
        return x.to(dtype).to(x.dtype)
    return x


def lower_precision(module: torch.nn.Module, dtype=torch.bfloat16):
    """`module` computing one step below float32, as bfloat16 matrix
    units do: every parameter rounded to `dtype`, and the inputs and
    outputs of every dense layer and convolution rounded to it (the
    products accumulate in float32). The control of a float32 stage."""
    with torch.no_grad():
        for p in module.parameters():
            if p.is_floating_point():
                p.data = _round(p.data, dtype)
    dense = (torch.nn.Linear, torch.nn.Conv1d, torch.nn.Conv2d,
             torch.nn.ConvTranspose1d)
    for m in module.modules():
        if isinstance(m, dense) or type(m).__name__ in ("WNConv",
                                                        "WNConvTranspose"):
            m.register_forward_pre_hook(
                lambda mod, args: tuple(_round(a, dtype) for a in args))
            m.register_forward_hook(
                lambda mod, args, out: _round(out, dtype))
    return module
