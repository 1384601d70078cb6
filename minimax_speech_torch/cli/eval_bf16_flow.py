"""Quality A/B of TTSConfig.bf16_flow on trained weights.

Port of scripts/eval_bf16_flow.py. The flow stage (the upsampling
conformer and the 10-step CFM UNet) can run in bfloat16
(infer/pipeline.py `bf16_flow`); this measures what that costs in
reconstruction quality on a model that has learned: the weights and
ground truth of a workdir that cli/overfit_pipeline.py wrote (its
model/{llm,flow,codec,s3}.npz and config.yaml, corpus/utt0's FSQ tokens
and DAC latents).

For float32 and bfloat16 flow inference on the same weights, from the
same start noises (the pipeline's fixed table, then host noise from
CPU generators seeded 100 + i):
  flow_nmse          one draw's NMSE against the ground-truth latents
  flow_nmse_mean{N}  the N-draw posterior mean's NMSE (the reference's
                     "recon < 0.1" bar speaks to the conditional mean)
  latent_rel_err     bf16 against fp32, relative L2 of the first draw

    python -m minimax_speech_torch.cli.eval_bf16_flow --workdir W \\
        [--draws 4] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import wave
from pathlib import Path

import numpy as np


def start_noises(shape, n: int, device) -> list:
    """n - 1 start noises after the pipeline's table: draw i host noise
    from a CPU generator seeded 100 + i, on `device` (the JAX script's
    PRNGKey(100 + i))."""
    import torch

    return [torch.randn(shape, generator=torch.Generator().manual_seed(
        100 + i)).to(device) for i in range(1, n)]


def evaluate(workdir, draws: int = 4, device="cuda", noises=None) -> dict:
    """The A/B on `device`. noises: the draws - 1 start noises after the
    pipeline's table (else start_noises)."""
    import torch

    from minimax_speech_torch import config as cfg_lib
    from minimax_speech_torch.cli.overfit_pipeline import ground_truth
    from minimax_speech_torch.infer.pipeline import TTSPipeline, next_bucket
    from minimax_speech_torch.models.flow import flow_inference
    from minimax_speech_torch.utils.device import resolve_device
    from minimax_speech_torch.utils.params_io import load_params

    resolve_device(device)  # no CUDA and none asked for: raise first
    d = Path(workdir) / "model"
    corpus = Path(workdir) / "corpus"
    base_cfg = cfg_lib.load_tts_config(d / "config.yaml")
    gt_tok, gt_lat, k = ground_truth(str(corpus / "utt0.wav"))
    n = len(gt_tok)
    tgt = gt_lat[2 * k:]
    with wave.open(str(corpus / "utt0.wav"), "rb") as w:
        raw = w.readframes(w.getnframes())
    wav = (np.frombuffer(raw, np.int16) / 32767.0).astype(np.float32)
    weights = [load_params(d / f"{name}.npz")
               for name in ("llm", "flow", "codec", "s3")]

    out = {}
    for mode in ("fp32", "bf16"):
        cfg = dataclasses.replace(base_cfg, bf16_flow=(mode == "bf16"))
        pipe = TTSPipeline.from_flax(cfg, *weights, device=device)
        _, flow_emb = pipe.speaker_embedding(pipe.extract_prompt_mel(wav))
        if noises is None:
            noises = start_noises(tuple(pipe.noise.shape), draws,
                                  pipe.device)
        tok_buf = np.zeros((1, next_bucket(n)), np.int64)
        tok_buf[0, :n] = gt_tok
        feats = []
        for noise in [pipe.noise, *noises[: draws - 1]]:
            # models/flow.py casts the float inputs to the flow's dtype
            feat = flow_inference(pipe.flow, tok_buf, [n],
                                  gt_lat[: 2 * k][None], flow_emb,
                                  torch.as_tensor(noise), device=pipe.device)
            feats.append(feat.float().cpu().numpy()[0, : 2 * (n - k)])
        var = float(np.var(tgt) + 1e-12)
        out[mode] = {
            "flow_nmse": float(np.mean((feats[0] - tgt) ** 2)) / var,
            f"flow_nmse_mean{draws}":
                float(np.mean((np.mean(feats, 0) - tgt) ** 2)) / var,
        }
        if mode == "fp32":
            ref_draw = feats[0]
        else:
            out["latent_rel_err"] = float(
                np.linalg.norm(feats[0] - ref_draw)
                / (np.linalg.norm(ref_draw) + 1e-12))
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workdir", required=True,
                   help="overfit_pipeline workdir (model/ + corpus/)")
    p.add_argument("--draws", type=int, default=4)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    args = p.parse_args(argv)
    out = evaluate(args.workdir, args.draws, args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
