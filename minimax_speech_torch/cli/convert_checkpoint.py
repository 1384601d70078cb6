"""Convert upstream torch checkpoints to .npz parameter files.

Port of minimax_speech_tpu/cli/convert_checkpoint.py:

  python -m minimax_speech_torch.cli.convert_checkpoint \
      --kind llm --src llm.pt --out llm.npz [--config configs/default.yaml]

kinds: llm (Qwen2LM), flow (CausalMaskedDiffWithXvec), hift
(HiFTGenerator, the mel mode's codec.npz), dac (the DACVAE generator, the
latent mode's codec.npz), s3 (S3TokenizerV2), qwen (a bare HF
Qwen2ForCausalLM state dict), campplus (CAM++, a torch state dict or a
campplus.onnx), matcha (a Matcha-TTS acoustic checkpoint: the text
encoder's subtree), matcha_hifigan (a HiFi-GAN generator_v1 state dict).
The .npz is the format both packages load (flax paths joined by '||'), so
cli/synthesize.py --ckpt_dir, cli/matcha.py --ckpt / --vocoder_ckpt and
the JAX package read the same files.
"""
from __future__ import annotations

import argparse

KINDS = ("llm", "flow", "hift", "dac", "s3", "qwen", "campplus", "matcha",
         "matcha_hifigan")


def load_torch_state(path: str) -> dict:
    """{name: numpy array} of a torch checkpoint (its "state_dict" entry
    where it has one), on the CPU."""
    import torch
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: v.detach().cpu().numpy() for k, v in obj.items()
            if hasattr(v, "numpy")}


def convert(kind: str, state: dict, cfg) -> dict:
    """The flax variables {"params": ...} of `kind` from its state dict."""
    from minimax_speech_torch.models import dac_vae, qwen2
    from minimax_speech_torch.models import s3tokenizer as s3
    from minimax_speech_torch.utils import convert as conv

    if kind == "llm":
        return conv.speech_lm_params(state, cfg.lm)
    if kind == "flow":
        return conv.flow_params(state, cfg.flow)
    if kind == "hift":
        return conv.hift_params(state, cfg.hift)
    if kind == "dac":
        if any(k.startswith("generator.") for k in state):
            state = {k[len("generator."):]: v for k, v in state.items()
                     if k.startswith("generator.")}
        return dac_vae.params_from_torch_state(state, cfg.dac)
    if kind == "s3":
        return s3.params_from_torch_state(state)
    if kind == "campplus":
        return conv.campplus_params(state)
    if kind == "matcha":
        return {"params": conv.matcha_text_encoder_params(state)}
    if kind == "matcha_hifigan":
        from minimax_speech_torch.models.matcha_hifigan import \
            matcha_hifigan_params
        return matcha_hifigan_params(state)
    params, embed, _ = qwen2.params_from_hf_state(state, cfg.lm.qwen)
    return {"params": {"llm": params["params"],
                       "text_embedding": {"embedding": embed}}}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--kind", required=True, choices=KINDS)
    p.add_argument("--src", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--config", default="configs/default.yaml")
    p.add_argument("--override", action="append", default=[])
    args = p.parse_args(argv)

    import numpy as np

    from minimax_speech_torch import config as cfg_lib
    from minimax_speech_torch.utils.params_io import save_tree

    cfg = cfg_lib.load_tts_config(args.config, args.override)
    if args.kind == "campplus" and args.src.endswith(".onnx"):
        from minimax_speech_torch.utils.onnx_reader import \
            read_onnx_initializers
        state = read_onnx_initializers(args.src)
    else:
        state = load_torch_state(args.src)
    variables = convert(args.kind, state, cfg)
    save_tree(args.out, variables)
    n = sum(np.asarray(a).size for a in np.load(args.out).values())
    print(f"wrote {args.out}: {n / 1e6:.1f}M params")
    return variables


if __name__ == "__main__":
    main()
