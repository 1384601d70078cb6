"""YAML + dotted overrides -> the port's dataclass config tree.

Port of minimax_speech_tpu/config.py for the TTS model section: a YAML
names the module tree (sections map 1:1 to dataclasses), `__base__`
merges a parent file, overrides are 'a.b.c=value'. PyYAML is imported
only when a file or an override is parsed; the dataclass defaults
already equal configs/default.yaml.
"""
from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Any

from minimax_speech_torch.infer.pipeline import TTSConfig
from minimax_speech_torch.models import dac_vae, hifigan
from minimax_speech_torch.models import llm as llm_mod
from minimax_speech_torch.models import qwen2
from minimax_speech_torch.models import s3tokenizer as s3
from minimax_speech_torch.models.cfm import CFMConfig
from minimax_speech_torch.models.decoder_unet import DecoderUNetConfig
from minimax_speech_torch.models.flow import FlowConfig
from minimax_speech_torch.models.speaker_encoder import SpeakerEncoderConfig
from minimax_speech_torch.models.upsample_encoder import UpsampleEncoderConfig


def load_yaml(path: str | Path) -> dict:
    import yaml

    path = Path(path)
    with open(path) as f:
        data = yaml.safe_load(f) or {}
    base = data.pop("__base__", None)
    if base:
        data = _merge(load_yaml(path.parent / base), data)
    return data


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = v
    return out


def apply_overrides(data: dict, overrides: list[str]) -> dict:
    """'a.b.c=value' strings; values parsed as YAML scalars."""
    if not overrides:
        return data
    import yaml

    for ov in overrides:
        key, _, raw = ov.partition("=")
        val = yaml.safe_load(raw)
        if isinstance(val, str) and re.fullmatch(
                r"[+-]?(\d+(\.\d*)?|\.\d+)[eE][+-]?\d+", val):
            val = float(val)  # YAML 1.1 reads "2e-3" as a string
        node = data
        parts = key.strip().split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return data


_SUBCONFIGS = {
    ("TTSConfig", "lm"): llm_mod.LMConfig,
    ("TTSConfig", "flow"): FlowConfig,
    ("TTSConfig", "dac"): dac_vae.DACVAEConfig,
    ("TTSConfig", "hift"): hifigan.HiFTConfig,
    ("TTSConfig", "s3"): s3.S3TokenizerConfig,
    ("LMConfig", "qwen"): qwen2.Qwen2Config,
    ("LMConfig", "speaker"): SpeakerEncoderConfig,
    ("FlowConfig", "encoder"): UpsampleEncoderConfig,
    ("FlowConfig", "unet"): DecoderUNetConfig,
    ("FlowConfig", "cfm"): CFMConfig,
    ("FlowConfig", "speaker"): SpeakerEncoderConfig,
}


def _build(dc_type, data: dict | None):
    """Build a dataclass from a dict: missing keys take their defaults,
    unknown keys raise, lists become tuples."""
    if data is None:
        return dc_type()
    fields = {f.name for f in dataclasses.fields(dc_type)}
    kwargs: dict[str, Any] = {}
    for k, v in data.items():
        if k not in fields:
            raise KeyError(f"unknown config key {k} for {dc_type.__name__}")
        sub = _SUBCONFIGS.get((dc_type.__name__, k))
        if sub is not None and isinstance(v, dict):
            kwargs[k] = _build(sub, v)
        elif isinstance(v, list):
            kwargs[k] = tuple(tuple(x) if isinstance(x, list) else x
                              for x in v)
        else:
            kwargs[k] = v
    return dc_type(**kwargs)


def build_tts_config(data: dict) -> TTSConfig:
    names = {f.name for f in dataclasses.fields(TTSConfig)}
    return _build(TTSConfig, {k: v for k, v in data.items() if k in names})


def load_tts_config(path: str | Path, overrides: list[str] = ()) -> TTSConfig:
    data = apply_overrides(load_yaml(path), list(overrides))
    return build_tts_config(data.get("model", data))
