"""Smoke run of the PyTorch/CUDA port (minimax_speech_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device and nvcc (CUDA_HOME, /usr/local/cuda or PATH);
exits non-zero, printing no result, without them. Phases, each printing
a line; any failure ends the run with a non-zero exit:

  1. device: name, power limit (nvidia-smi), versions; TF32 off for
     matmuls and cuDNN convs, so float32 comparisons are float32;
  2. build: every CUDA source of the port, one nvcc each, in parallel;
  3. K1 (csrc/flash_attention.cu) against its plain PyTorch version on
     the card, in every mask mode, fp32 and bf16, at the UNet's main-path
     shape and at a ragged T; times of kernel, plain version and
     torch's scaled_dot_product_attention (a yardstick the port never
     calls) at the main-path shape;
  4. the main path at the full width of configs/default.yaml with
     random weights (seed 0): zero-shot synthesis through TTSPipeline's
     entry points, as bench.py drives the JAX package (3 s prompt, 12
     text tokens, 125 generated tokens, LM in bf16, flow and codec in
     fp32), with K1's launches counted per utterance;
  5. the same synthesis at reduced depth on the card and on the CPU with
     the same weights and noise: identical token ids, PCM within a
     stated tolerance.

The line before the last holds the kernels' record (JSON); the last line
is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

GEN_TOKENS = 125          # 5 s of audio at 25 Hz
TEXT_LEN = 12
PROMPT_TEXT_LEN = 4
PROMPT_SECONDS = 3.0
TIMED_RUNS = 3
# K1's comparison tolerances, |err| <= atol + rtol * |plain|: fp32 is the
# same arithmetic in another summation order; bf16 outputs are both an
# fp32 result rounded to bf16, so they may differ by one bf16 ulp
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 2.0 ** -7)}
MODES = {"full": {}, "causal": {"causal": True}, "chunk50": {"chunk": 50},
         "chunk50_left2": {"chunk": 50, "left_chunks": 2}}
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and FLOP/s by type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# the PCM of the reduced-depth run may differ between the card and the CPU
# by float32 sums in other orders through LM, flow and codec
PCM_TOL_LSB = 16


def log(msg: str):
    print(msg, flush=True)


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 50) -> float:
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def prompts():
    """bench.py's inputs: 220 Hz prompt at 16 and 24 kHz, random text."""
    t16 = np.arange(int(16000 * PROMPT_SECONDS)) / 16000
    t24 = np.arange(int(24000 * PROMPT_SECONDS)) / 24000
    rng = np.random.default_rng(1986)
    text = rng.integers(0, 150000, TEXT_LEN)
    ptext = rng.integers(0, 150000, PROMPT_TEXT_LEN)
    return ((0.5 * np.sin(2 * np.pi * 220 * t16)).astype(np.float32),
            (0.5 * np.sin(2 * np.pi * 220 * t24)).astype(np.float32),
            text, ptext)


def fixed_length(cfg, n_tokens: int):
    """min_len == max_len == n_tokens for TEXT_LEN text tokens."""
    return dataclasses.replace(
        cfg, max_speech_tokens=n_tokens,
        min_token_text_ratio=n_tokens / TEXT_LEN,
        max_token_text_ratio=n_tokens / TEXT_LEN)


def attn_calls_per_step(cfg) -> int:
    u = cfg.flow.unet
    stages = 2 * len(u.channels) + u.num_mid_blocks
    return stages * u.n_blocks


def k1_checks(main_shape, kv_main):
    """Phase 3: K1 against its plain version; returns the record of K1
    (timings at the main-path shape)."""
    import torch
    import torch.nn.functional as F

    from minimax_speech_torch.kernels import flash_attention as fa

    b, h, t, d = main_shape
    cases = [(main_shape, kv_main), ((b, h, 77, d), (77, 40))]
    gen = torch.Generator(device="cuda").manual_seed(0)
    main_err = None
    for shape, kv in cases:
        lens = torch.tensor(kv, device="cuda", dtype=torch.int32)
        base = [torch.randn(shape, generator=gen, device="cuda")
                for _ in range(3)]
        for dname, dtype in (("float32", torch.float32),
                             ("bfloat16", torch.bfloat16)):
            q, k, v = (x.to(dtype) for x in base)
            atol, rtol = TOL[dname]
            for mname, kw in MODES.items():
                out = fa.flash_attention(q, k, v, kv_len=lens, **kw)
                ref = fa.reference_attention(q, k, v, lens, **kw)
                torch.cuda.synchronize()
                err = excess = 0.0
                for i, n in enumerate(kv):
                    o, r = out[i, :, :n].float(), ref[i, :, :n].float()
                    if not torch.isfinite(o).all():
                        raise AssertionError(f"K1 non-finite {shape} {mname}")
                    diff = (o - r).abs()
                    err = max(err, float(diff.max()))
                    excess = max(excess, float(
                        (diff - atol - rtol * r.abs()).max()))
                ok = excess <= 0
                log(f"[k1] T={shape[2]} kv={list(kv)} {dname:8s} "
                    f"{mname:13s} max_abs_err={err:.3e} "
                    f"tol={atol:g}+{rtol:g}*|ref| {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"K1 disagrees: {shape} {dname} "
                                         f"{mname} err {err}")
                if shape == main_shape and dname == "float32" \
                        and mname == "full":
                    main_err = err

    # timings at the main-path shape and dtype (fp32, full mask)
    q, k, v = (torch.randn(main_shape, generator=gen, device="cuda")
               for _ in range(3))
    lens = torch.tensor(kv_main, device="cuda", dtype=torch.int32)
    mask = fa.visible_mask(t, lens, batch=b, device="cuda")
    before = fa.launches
    kernel_ms = cuda_ms(lambda: fa.flash_attention(q, k, v, kv_len=lens))
    fa.launches = before  # timing launches are not main-path launches
    plain_ms = cuda_ms(lambda: fa.reference_attention(q, k, v, lens))
    sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask))
    n_bytes = 4 * q.numel() * q.element_size() + lens.numel() * 4
    flops = 4 * h * t * d * sum(kv_main)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS["float32"] * 1e3
    log(f"[k1] main-path shape {tuple(main_shape)} kv={list(kv_main)} fp32: "
        f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"sdpa {sdpa_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.4f} ms "
        f"({n_bytes} B -> {bytes_ms:.4f} ms; {flops} FLOP at fp32 peak -> "
        f"{ops_ms:.4f} ms)")
    return {"name": "flash_attention", "route": "cuda",
            "source": "minimax_speech_torch/csrc/flash_attention.cu",
            "replaces": "minimax_speech_tpu/kernels/flash_attention.py:114",
            "max_abs_err": main_err, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": sdpa_ms}


def main_path(pipe, inputs, runs: int, card: str, generator_device: str):
    """Phase 4 body: prompt processing, a warm-up synthesis, then `runs`
    counted and timed ones. Returns (K1 launches per utterance, the
    (B, T) and key lengths K1 saw)."""
    import torch

    from minimax_speech_torch.kernels import flash_attention as fa

    a16, a24, text, ptext = inputs
    cfg = pipe.cfg
    prompt_tokens = pipe.extract_prompt_tokens(a16)
    prompt_latent = pipe.extract_prompt_latent(a24)
    prompt_mel = pipe.extract_prompt_mel(a24)
    lm_spk, flow_emb = pipe.speaker_embedding(prompt_mel)
    lm_spk = lm_spk.to(next(pipe.lm.parameters()).dtype)
    log(f"[main] prompt tokens {prompt_tokens.shape}, latent "
        f"{prompt_latent.shape}, mel {prompt_mel.shape}, lm_spk "
        f"{tuple(lm_spk.shape)} {lm_spk.dtype}, flow_emb "
        f"{tuple(flow_emb.shape)}")

    seen = {}
    first_block = pipe.flow.estimator.down[0][1][0]
    hook = first_block.register_forward_pre_hook(
        lambda mod, args: seen.update(bt=tuple(args[0].shape[:2]),
                                      kv=args[1].tolist()))

    def run(seed):
        gen = torch.Generator(device=generator_device).manual_seed(seed)
        return pipe.synthesize_fused(text, ptext, prompt_tokens,
                                     prompt_latent, lm_spk, flow_emb,
                                     generator=gen, return_timings=True)

    run(1)  # warm-up
    results, per_utt = [], []
    for i in range(runs):
        fa.launches = 0
        wav, tim = run(2 + i)
        per_utt.append(fa.launches)
        pcm = np.round(wav * 32767)
        n_expect = GEN_TOKENS * cfg.token_latent_ratio * 480
        if tim["tokens"] != GEN_TOKENS or len(wav) != n_expect \
                or not np.isfinite(wav).all() or np.abs(pcm).max() > 32767:
            raise AssertionError(f"main path output: tokens {tim['tokens']}, "
                                 f"samples {len(wav)}")
        results.append(tim)
    hook.remove()
    tot = statistics.median(r["total_s"] for r in results)
    lm = statistics.median(r["lm_s"] for r in results)
    aud = results[0]["audio_s"]
    log(f"[main] {card} | tokens {GEN_TOKENS} samples "
        f"{GEN_TOKENS * cfg.token_latent_ratio * 480} finite int16 | "
        f"median total_s {tot:.4f} (LM decode {lm:.4f}, flow + codec + "
        f"copy {tot - lm:.4f}) audio_s {aud:.2f} rtf {tot / aud:.5f} "
        f"(runs {[round(r['total_s'], 4) for r in results]}) | "
        f"K1 launches per utterance {per_utt}, K1 saw (B, T) {seen['bt']} "
        f"kv_len {seen['kv']}")
    return per_utt, seen


def cross_check(full_cfg, inputs, device="cuda"):
    """Phase 5: reduced depth, same weights and noise on `device` and on
    the CPU."""
    import torch

    from minimax_speech_torch.infer.pipeline import TTSPipeline, decode_plan
    from minimax_speech_torch.models import llm as llm_mod

    cfg = dataclasses.replace(
        full_cfg,
        lm=dataclasses.replace(full_cfg.lm, qwen=dataclasses.replace(
            full_cfg.lm.qwen, n_layers=2)),
        flow=dataclasses.replace(
            full_cfg.flow,
            unet=dataclasses.replace(full_cfg.flow.unet, num_mid_blocks=1),
            encoder=dataclasses.replace(full_cfg.flow.encoder, num_blocks=1,
                                        num_up_blocks=1)))
    a16, a24, text, ptext = inputs
    cpu = TTSPipeline.from_random(cfg, seed=5, device="cpu")
    gpu = TTSPipeline(cfg, device=device)
    for name, m in gpu.models().items():
        m.load_state_dict(cpu.models()[name].state_dict())
    prompt_tokens = cpu.extract_prompt_tokens(a16)
    prompt_latent = cpu.extract_prompt_latent(a24)
    lm_spk, flow_emb = cpu.speaker_embedding(cpu.extract_prompt_mel(a24))
    g_top, g_fb = llm_mod.decode_noise(
        cfg.lm, cfg.max_speech_tokens, 1, torch.Generator().manual_seed(9))

    def tokens(pipe, dev):
        src, tok, plen, min_len, max_len = decode_plan(cfg, text, ptext,
                                                       prompt_tokens)
        out, cnt = llm_mod.generate(
            pipe.lm, src, tok, plen, lm_spk.to(dev), min_len, max_len,
            max_steps=cfg.max_speech_tokens,
            gumbel_top=g_top, gumbel_fallback=g_fb, device=dev)
        return out.cpu().numpy()[0, : int(cnt[0])]

    def pcm(pipe, dev):
        wav = pipe.synthesize_fused(text, ptext, prompt_tokens, prompt_latent,
                                    lm_spk.to(dev), flow_emb.to(dev),
                                    gumbel_top=g_top, gumbel_fallback=g_fb)
        return np.round(wav * 32767).astype(np.int32)

    ids_gpu, ids_cpu = tokens(gpu, device), tokens(cpu, "cpu")
    pcm_gpu, pcm_cpu = pcm(gpu, device), pcm(cpu, "cpu")
    same_ids = ids_gpu.shape == ids_cpu.shape and (ids_gpu == ids_cpu).all()
    diff = int(np.abs(pcm_gpu - pcm_cpu).max()) if \
        pcm_gpu.shape == pcm_cpu.shape else None
    corr = float(np.corrcoef(pcm_gpu, pcm_cpu)[0, 1]) if diff is not None \
        else float("nan")
    log(f"[cross] reduced depth (2 LM layers, 1 mid UNet block, 1+1 encoder "
        f"blocks), TF32 off: token ids identical {bool(same_ids)} "
        f"({len(ids_gpu)} vs {len(ids_cpu)} tokens); PCM max |diff| {diff} "
        f"LSB (tol {PCM_TOL_LSB}), corr {corr:.6f}, peak "
        f"{int(np.abs(pcm_cpu).max())}")
    if not same_ids:
        raise AssertionError("token ids differ between the card and the CPU")
    if diff is None or diff > PCM_TOL_LSB:
        raise AssertionError(f"PCM differs by {diff} LSB")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from minimax_speech_torch.infer.pipeline import TTSConfig, TTSPipeline
    from minimax_speech_torch.kernels import build
    from minimax_speech_torch.kernels import flash_attention as fa

    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    card = card_info()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {name} | nvidia-smi: {card} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} python {sys.version.split()[0]} | "
        f"TF32 matmul {torch.backends.cuda.matmul.allow_tf32} cudnn "
        f"{torch.backends.cudnn.allow_tf32}")

    sources = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    secs = build.build(sources)
    log(f"[build] {sources} by nvcc {' '.join(build.NVCC_FLAGS)} in "
        f"{secs:.1f} s")
    for src, text in build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {src}: {line.strip()}")

    cfg = fixed_length(TTSConfig(), GEN_TOKENS)
    inputs = prompts()
    b, h = 2, cfg.flow.unet.num_heads  # CFG batch of 2
    n_prompt = 75  # 3 s at 25 Hz
    t = 2 * (128 + GEN_TOKENS)  # [prompt bucket | max steps] tokens, 2x
    kv = 2 * (n_prompt + GEN_TOKENS)
    record = k1_checks((b, h, t, cfg.flow.unet.attention_head_dim), (kv, kv))

    pipe = TTSPipeline.from_random(cfg, seed=0, device="cuda")
    pipe.lm.to(torch.bfloat16)
    per_utt, seen = main_path(pipe, inputs, TIMED_RUNS, card, "cuda")
    expect = attn_calls_per_step(cfg) * cfg.flow.n_timesteps
    if any(n != expect for n in per_utt) or seen["bt"] != (b, t) \
            or seen["kv"] != [kv, kv]:
        raise AssertionError(f"K1 on the main path: launches {per_utt} "
                             f"(expected {expect}), shape {seen}")
    del pipe
    torch.cuda.empty_cache()

    cross_check(cfg, inputs)

    record["launches"] = per_utt[-1]
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
