"""The plain models of a configuration file's `model` block, float32 on
one device, loaded from the benchmark's state dicts."""
from __future__ import annotations

import dataclasses

import torch

from speechbench.reference import (cfm, dac_vae, decoder_unet, flow, llm,
                                   qwen2, speaker_encoder, upsample_encoder)

_SUB = {
    ("LMConfig", "qwen"): qwen2.Qwen2Config,
    ("LMConfig", "speaker"): speaker_encoder.SpeakerEncoderConfig,
    ("FlowConfig", "encoder"): upsample_encoder.UpsampleEncoderConfig,
    ("FlowConfig", "unet"): decoder_unet.DecoderUNetConfig,
    ("FlowConfig", "cfm"): cfm.CFMConfig,
    ("FlowConfig", "speaker"): speaker_encoder.SpeakerEncoderConfig,
}


def build(dc_type, data: dict):
    """A dataclass from a dict: missing keys take their defaults, lists
    become tuples, unknown keys raise."""
    names = {f.name for f in dataclasses.fields(dc_type)}
    kw = {}
    for k, v in data.items():
        if k not in names:
            raise KeyError(f"unknown key {k} for {dc_type.__name__}")
        sub = _SUB.get((dc_type.__name__, k))
        if sub is not None:
            kw[k] = build(sub, v)
        elif isinstance(v, list):
            kw[k] = tuple(tuple(x) if isinstance(x, list) else x for x in v)
        else:
            kw[k] = v
    return dc_type(**kw)


def build_lm_config(model: dict, quantized: bool = False,
                    act_quant: bool = True,
                    lower: bool = False) -> llm.LMConfig:
    data = dict(model["lm"])
    data["qwen"] = dict(data["qwen"], quantized=quantized,
                        act_quant=act_quant, lower=lower)
    return build(llm.LMConfig, data)


def build_flow_config(model: dict) -> flow.FlowConfig:
    return build(flow.FlowConfig, model["flow"])


def vocoder(model: dict):
    """The DAC-VAE of a latent-mode configuration (the plain HiFT, for a
    mel-mode cell, is not part of the reference yet)."""
    if model["output_type"] != "latent":
        raise NotImplementedError("the reference has no HiFT vocoder")
    return dac_vae.DACVAE(build(dac_vae.DACVAEConfig, model["dac"]))


def load(module: torch.nn.Module, state: dict, device,
         dtype=torch.float32) -> torch.nn.Module:
    """`module` on `device` with `state` loaded, float leaves in dtype,
    in eval mode, without gradients."""
    module.load_state_dict(state)
    module.to(device)
    for p in module.parameters():
        p.requires_grad_(False)
        if p.is_floating_point():
            p.data = p.data.to(dtype)
    return module.eval()


def on(device, make):
    """make() with its parameters allocated on `device`."""
    with torch.device(device):
        return make()
