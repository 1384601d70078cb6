"""Warm every pipeline stage at the serving buckets, on the card.

Port of minimax_speech_tpu/cli/export.py. Its job is the JAX one: make
the first request cost what a steady-state request costs. The JAX
package compiles each stage ahead of time into XLA's executable cache;
PyTorch has no such cache to fill, and the first call in a process pays
other one-time costs instead: the nvcc build of the attention kernel K1
(csrc/flash_attention.cu) or the load of its library, the CUDA context,
cuBLAS's handles and workspaces, cuDNN's choice of algorithm for each
convolution shape and the caching allocator's first pools at each
bucket. So export

  1. builds the libraries of the kernels the stages launch into
     build/kernels/ (kernels/build.py), the directory every later
     process loads them from, and prints each path and whether it was
     built now or found there;
  2. loads the weights (--ckpt_dir with {llm,flow,codec,s3}.npz, or
     --random_init);
  3. runs every stage once per bucket, as the JAX loop does: the S3
     tokenizer on a zero mel of b frames, the flow on b tokens with a
     16-frame prompt, the codec on 2b frames, the LM's prefill at a
     b-long prompt and its decode loop; with --serving the serving
     paths (infer/warmup.warm_serving, window then continuous); with
     --matcha the standalone Matcha-TTS acoustic model and its HiFi-GAN
     per bucket.

The JAX CLI's --cache_dir is not taken: the only artifacts that persist
are the kernel libraries, and build/kernels/ is fixed in
kernels/build.py and read by every entry point. Runs on --device
(default cuda; raises without a GPU, --device cpu runs every stage on
the CPU and builds no kernel). main() returns a record of each stage's
seconds at each bucket and of the kernel libraries.

  python -m minimax_speech_torch.cli.export --config configs/default.yaml \
      [--random_init | --ckpt_dir DIR] [--buckets 64,128,256] \
      [--serving] [--matcha] [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np

# the CUDA sources whose kernels the exported stages launch: K1, in the
# flow's and Matcha's UNet attention
KERNELS = ("flash_attention",)


def build_kernels(names=KERNELS) -> dict:
    """Build each named kernel library that build/kernels/ lacks. Returns
    {name: {"path", "built" (now, not found), "seconds"}}."""
    from minimax_speech_torch.kernels import build

    out = {}
    for name in names:
        lib = build.library_path(name)
        found = lib.exists()
        secs = build.build([name])
        out[name] = {"path": str(lib), "built": not found, "seconds": secs}
        print(f"kernel {name}: {lib} ({'found' if found else 'built'} in "
              f"{secs:.1f}s)")
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="configs/default.yaml")
    p.add_argument("--override", action="append", default=[])
    p.add_argument("--ckpt_dir", default=None)
    p.add_argument("--random_init", action="store_true")
    p.add_argument("--buckets", default="64,128,256")
    p.add_argument("--gen_tokens", type=int, default=None,
                   help="decode max_steps to warm (default: config)")
    p.add_argument("--serving", action="store_true",
                   help="also warm the serving paths (one-shot, batched, "
                        "continuous, streaming) that `cli.serve` runs")
    p.add_argument("--matcha", action="store_true",
                   help="also warm the standalone Matcha text->mel->wav "
                        "stages per bucket, as cli.matcha runs them")
    p.add_argument("--matcha_ckpt", default=None)
    p.add_argument("--matcha_vocoder_ckpt", default=None)
    p.add_argument("--tokenizer_path", default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    import torch

    from minimax_speech_torch import config as cfg_lib
    from minimax_speech_torch.infer.pipeline import TTSPipeline
    from minimax_speech_torch.models import flow as flow_mod
    from minimax_speech_torch.models import llm as llm_mod
    from minimax_speech_torch.utils.device import resolve_device
    from minimax_speech_torch.utils.params_io import load_params

    dev = resolve_device(args.device)
    record = {"device": str(dev), "kernels": {}, "buckets": {},
              "serving": {}, "matcha": {}}
    if dev.type == "cuda":
        record["kernels"] = build_kernels()

    cfg = cfg_lib.load_tts_config(args.config, args.override)
    if args.ckpt_dir:
        d = Path(args.ckpt_dir)
        pipe = TTSPipeline.from_flax(
            cfg, *(load_params(str(d / f"{n}.npz"))
                   for n in ("llm", "flow", "codec", "s3")), device=dev)
    elif args.random_init:
        pipe = TTSPipeline.from_random(cfg, device=dev)
    else:
        raise SystemExit("need --ckpt_dir or --random_init")

    buckets = [int(b) for b in args.buckets.split(",")]
    t0 = time.perf_counter()

    def timed(fn) -> float:
        t = time.perf_counter()
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter() - t

    with torch.no_grad():
        for b in buckets:
            mel = torch.zeros((1, b, cfg.s3.n_mels), device=dev)
            lens = torch.tensor([b], device=dev)
            tokens = torch.zeros((1, b), dtype=torch.long, device=dev)
            prompt_feat = torch.zeros((1, 16, cfg.flow.output_size),
                                      device=dev)
            emb = torch.zeros((1, cfg.flow.spk_embed_dim), device=dev)
            src = torch.zeros((1, b), dtype=torch.long, device=dev)
            src[0, 0] = llm_mod.SRC_SPECIAL
            one = torch.tensor([1], device=dev)
            stages = {
                "s3_s": lambda: pipe.s3(mel, lens),
                "flow_s": lambda: flow_mod.flow_inference(
                    pipe.flow, tokens, lens, prompt_feat, emb, pipe.noise,
                    device=dev),
                "decode_s": lambda: pipe.decode(torch.zeros(
                    (1, 2 * b, cfg.flow.output_size), device=dev)),
                "llm_s": lambda: llm_mod.generate(
                    pipe.lm, src, torch.zeros_like(src),
                    torch.tensor([4], device=dev),
                    torch.zeros((1, cfg.lm.llm_input_size), device=dev),
                    one, one + 1,
                    max_steps=args.gen_tokens or cfg.max_speech_tokens,
                    generator=torch.Generator(device=dev).manual_seed(0),
                    device=dev)}
            record["buckets"][b] = {k: timed(fn) for k, fn in stages.items()}
            print(f"bucket {b}: all stages warmed "
                  f"({time.perf_counter() - t0:.1f}s cumulative)")

    if args.serving:
        from minimax_speech_torch.infer import warmup
        from minimax_speech_torch.infer.api import TTS
        tts = TTS(pipeline=pipe, tokenizer_path=args.tokenizer_path)
        record["serving"]["window"] = warmup.warm_serving(
            tts, scheduler="window")
        record["serving"]["continuous"] = warmup.warm_serving(
            tts, scheduler="continuous", streaming=False)

    if args.matcha:
        record["matcha"] = warm_matcha(args, buckets, dev, timed, t0)
    record["total_s"] = time.perf_counter() - t0
    where = ", ".join(k["path"] for k in record["kernels"].values())
    print(f"export done; kernel libraries: {where or 'none (cpu)'}")
    return record


def warm_matcha(args, buckets, dev, timed, t0) -> dict:
    """The Matcha acoustic model and its HiFi-GAN at MatchaConfig() width,
    from --matcha_ckpt / --matcha_vocoder_ckpt or random weights (seeds 0
    and 1), once per bucket of b text ids. Returns {b: seconds of each}."""
    import torch

    from minimax_speech_torch.models import matcha as matcha_mod
    from minimax_speech_torch.models.matcha_hifigan import (
        MatchaHiFiGAN, MatchaHiFiGANConfig)
    from minimax_speech_torch.utils import params_io

    mcfg = matcha_mod.MatchaConfig()
    model = matcha_mod.MatchaTTS(mcfg)
    vocoder = MatchaHiFiGAN(MatchaHiFiGANConfig(in_channels=mcfg.n_feats))
    for module, ckpt, seed in ((model, args.matcha_ckpt, 0),
                               (vocoder, args.matcha_vocoder_ckpt, 1)):
        if ckpt:
            params_io.load_flax_params(module, params_io.load_params(ckpt))
        else:
            params_io.init_params(module, torch.Generator().manual_seed(seed))
        module.to(dev).eval()
    out = {}
    with torch.no_grad():
        for b in buckets:
            mel = []
            out[b] = {
                "synthesise_s": timed(lambda: mel.append(
                    matcha_mod.matcha_synthesise(
                        model, torch.zeros((1, b), dtype=torch.long),
                        torch.tensor([b]),
                        generator=torch.Generator(device=dev).manual_seed(0),
                        device=dev)[0])),
                "vocoder_s": timed(lambda: vocoder(mel[0]))}
            print(f"matcha bucket {b}: warmed "
                  f"({time.perf_counter() - t0:.1f}s cumulative)")
    return out


if __name__ == "__main__":
    main()
