"""Time design variants of the attention kernels K1 and K2 on one GPU.

    python -m minimax_speech_torch.kernels.variants [variant ...]
    python -m minimax_speech_torch.kernels.variants committed parent=DIR \
        committed parent=DIR
    python -m minimax_speech_torch.kernels.variants --flow-grads [variant ...]

Each variant is a copy of csrc/ under build/variants/<name>/ with one
change to the committed sources, built by kernels/build.py and timed at
the main paths' shapes: K1 at the flow UNet's (2, 8, 506, 64) fp32 with
kv_len [400, 400]; K2's forward kernel and its backward (dK/dV, dQ and the
Delta op) at the LM's (8, 14, 512, 64) fp32, causal, with the lengths
of chip_smoke.py's training batch. Times are CUDA-graph replays (device
time without the host's gaps between launches); each line also gives the
largest |error| against the plain version and ptxas's registers. The
variants:

  committed     the sources as they are
  cvt_rna       TF32 rounding by cvt.rna.tf32.f32 instead of the integer
                form of the same rounding
  unrolled_kk   mma_rows' loop over the 8 k-steps fully unrolled
  tf32x1        one TF32 product per fp32 product (a_hi b_hi): not fp32
                accurate, for timing the two extra products only
  no_hmma       the mma.sync replaced by an empty asm statement with the
                same operands: every load, split and softmax is kept, the
                tensor-core work is gone (wrong results, timing only)
  fixed_b       every B fragment of a k-step read from one address: the
                products are kept, most B loads and splits are gone
                (wrong results, timing only)
  tf32x4        the fourth TF32 product of a split pair (a_lo b_lo) added
  rn_acc        each 3xTF32 product summed into a zeroed fragment, then
                added to the accumulator by fp32 adds (round to nearest),
                so the tensor cores never carry a long sum
  chained       K2's forward O summed by the tensor cores over every key
                tile, as K1 and the backward sum (the committed form
                before K2's forward took mma_acc<true>)
  rn_fwd        rn_acc on K2's forward O only: each of its products summed
                in a zeroed fragment and added by fp32 adds
  LABEL=DIR     the sources of another csrc/ directory as they are, e.g.
                a parent commit's unpacked by git archive, timed in turns
                with `committed` to hold a change to the same shapes

--flow-grads measures K2's accuracy where the flow's training reaches
it (run from the repo root; needs chip_smoke.py): the first-step
gradients of chip_smoke.py's phase-22 flow (1 mid UNet stage, 1 + 1
encoder blocks, full widths, its batch) on the card with each variant,
for each of FLOW_SEEDS (weights and draws), against a float64 run on
the CPU: the worst leaf among the UNet's to_q and to_k weights (their
gradient comes only through K2's dq and dk) and among the other leaves,
each as max |diff| over the leaf's largest, beside the CPU's float32.
Besides the variants above it takes one of kernels/splash.py's
backward:

  plain_delta   Delta = rowsum(dO * O) from the plain version's float32
                output instead of the forward kernel's
"""
from __future__ import annotations

import re
import shutil
import sys
from pathlib import Path

import numpy as np
import torch

from minimax_speech_torch.kernels import build
from minimax_speech_torch.kernels import flash_attention as fa
from minimax_speech_torch.kernels import splash
from minimax_speech_torch.utils.device import graph_ms

HEADER = "attention_mma.cuh"
VARIANTS = {
    "committed": [],
    "cvt_rna": [(
        "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
        '  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));'
        "\n  return r;")],
    "unrolled_kk": [("#pragma unroll 1\n  for (int kk = 0;",
                     "#pragma unroll\n  for (int kk = 0;")],
    "tf32x1": [("mma3<kSplit, kSplit>(", "mma3<false, false>("),
               ("mma3<true, Tl::kFloat>(", "mma3<false, false>(")],
    "no_hmma": [('asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "\n'
                 '      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, '
                 '{%0, %1, %2, %3};\\n"',
                 'asm volatile(""')],
    "tf32x4": [("  if (kSplitB) mma(d, ah, bl);\n",
                "  if (kSplitB) mma(d, ah, bl);\n"
                "  if (kSplitA && kSplitB) mma(d, al, bl);\n")],
    "rn_acc": [("  if (kSplitA) mma(d, al, bh);\n"
                "  if (kSplitB) mma(d, ah, bl);\n"
                "  mma(d, ah, bh);\n}",
                "  float p[4] = {0.f, 0.f, 0.f, 0.f};\n"
                "  if (kSplitA) mma(p, al, bh);\n"
                "  if (kSplitB) mma(p, ah, bl);\n"
                "  mma(p, ah, bh);\n"
                "#pragma unroll\n"
                "  for (int e = 0; e < 4; ++e) d[e] += p[e];\n}")],
    "chained": [("  float(&d)[N][4] = kTileSum ? part : acc;",
                 "  float(&d)[N][4] = acc;")],
    "rn_fwd": [("      mma3<true, Tl::kFloat>(d[n], ah, al, bh, bl);",
                "      if (kTileSum) {\n"
                "        float q[4] = {0.f, 0.f, 0.f, 0.f};\n"
                "        mma3<true, Tl::kFloat>(q, ah, al, bh, bl);\n"
                "#pragma unroll\n"
                "        for (int e = 0; e < 4; ++e) d[n][e] += q[e];\n"
                "      } else {\n"
                "        mma3<true, Tl::kFloat>(d[n], ah, al, bh, bl);\n"
                "      }")],
    "fixed_b": [("to_f(b[(8 * n + g) * S + c])", "to_f(b[g * S + c])"),
                ("to_f(b[(8 * n + g) * S + c + 4])", "to_f(b[g * S + c + 4])"),
                ("to_f(r0[8 * n])", "to_f(r0[0])"),
                ("to_f(r0[S + 8 * n])", "to_f(r0[S])")],
}
# the lengths of chip_smoke.py's LM training batch (its lm_batch)
LM_LENS = [472, 427, 400, 349, 357, 301, 308, 296]
# --flow-grads: the seeds of the weights and draws (phase 22 runs 5)
FLOW_SEEDS = (5, 6, 7, 8)


def _plain_delta(backward):
    """K2's backward taking Delta from the plain version's output."""
    def run(q, k, v, kv_len, chunk, left_chunks, out, lse, dout):
        plain = splash.reference_splash_attention(q, k, v, kv_len, chunk,
                                                  left_chunks, scale=1.0)
        return backward(q, k, v, kv_len, chunk, left_chunks, plain, lse,
                        dout)
    return run


# variants of kernels/splash.py's backward: a function of the committed
# _kernel_backward that replaces it
BACKWARDS = {"plain_delta": _plain_delta}


def warp_pairs(lens, seq: int, chunk: int = 1, left: int = -1):
    """(visible, computed) (q, k) pairs of one head over a batch with
    these lengths in K2's forward: a warp's 16 rows compute every 64-key
    tile that their keys' interval reaches, as attention_forward does
    (the mask of kernels/splash.py)."""
    def span(q, n):  # the keys row q sees: [lo, hi)
        lo, hi = 0, seq
        if chunk > 0:
            hi = min((q // chunk + 1) * chunk, seq)
            if left >= 0:
                lo = max(0, (q // chunk - left) * chunk)
        return (lo, min(hi, n)) if q < n else (max(lo, n), hi)

    visible = computed = 0
    for n in lens:
        n = min(n, seq)
        visible += sum(hi - lo for lo, hi in (span(q, n) for q in range(seq)))
        for q0 in range(0, seq, 64):
            first = span(q0, n)[0] // 64 * 64
            last = span(min(q0 + 64, seq) - 1, n)[1]
            for r0 in range(q0, min(q0 + 64, seq), 16):
                w_lo = span(r0, n)[0]
                w_hi = span(min(r0 + 16, seq) - 1, n)[1]
                computed += sum(16 * 64 for k0 in range(first, last, 64)
                                if k0 < w_hi and k0 + 64 > w_lo)
    return visible, computed


def make_sources(name: str, src_dir, out_dir):
    """A copy of `src_dir` with the variant's replacements made in the
    header; raises if a pattern is not found."""
    shutil.rmtree(out_dir, ignore_errors=True)
    shutil.copytree(src_dir, out_dir)
    header = out_dir / HEADER
    text = header.read_text()
    for old, new in VARIANTS[name]:
        if old not in text:
            raise ValueError(f"variant {name}: pattern not found: {old!r}")
        text = text.replace(old, new)
    header.write_text(text)
    return out_dir


def use(csrc) -> None:
    """Load the kernels from `csrc` from now on."""
    build.CSRC = csrc
    build._LIBS.clear()
    build.BUILD_LOG.clear()
    fa._fn.cache_clear()
    splash._lib.cache_clear()


def registers() -> str:
    out = []
    for text in build.BUILD_LOG.values():
        fn = ""
        for line in text.splitlines():
            entry = re.search(r"Compiling entry function '(\w+)'", line)
            if entry:
                fn = entry[1]
            used = re.search(r"Used (\d+) registers", line)
            if used and "bfloat16" not in fn:
                kernel = re.search(r"(attn_fwd|splash_fwd|splash_dkdv|"
                                   r"splash_dq)I", fn)
                dim = re.search(r"Li(\d+)EE", fn)
                out.append(f"{kernel[1] if kernel else fn}"
                           f"{f'<{dim[1]}>' if dim else ''} {used[1]}")
    return ", ".join(out)


def main(names) -> int:
    if not torch.cuda.is_available():
        print("variants: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(torch.cuda.get_device_name(0), flush=True)
    visible, computed = warp_pairs(LM_LENS, 512)
    print(f"K2 forward at the LM shape: {visible} visible and {computed} "
          f"computed (q, k) pairs per head ({computed / visible:.3f}x), "
          f"{3 * 2 * 2 * 64 * 14 * computed / 1e9:.2f} GFLOP of TF32 "
          f"products", flush=True)
    rng = np.random.default_rng(0)

    def randn(*shape):
        return torch.tensor(rng.standard_normal(shape).astype(np.float32),
                            device="cuda")

    q1, k1, v1 = (randn(2, 8, 506, 64) for _ in range(3))
    len1 = torch.tensor([400, 400], device="cuda", dtype=torch.int32)
    q2, k2, v2, do2 = (randn(8, 14, 512, 64) for _ in range(4))
    len2 = torch.tensor(LM_LENS, device="cuda", dtype=torch.int32)
    q2s = (q2 / 8.0).contiguous()
    ref1 = fa.reference_attention(q1, k1, v1, len1)[:, :, :400]
    x = [a.clone().requires_grad_() for a in (q2, k2, v2)]
    out = splash.reference_splash_attention(*x, len2, 1, -1)
    ref2 = [out.detach()] + list(torch.autograd.grad(out, x, do2))
    ref2[1] = ref2[1] / 0.125  # the kernels' dq is for the scaled q

    src = build.CSRC
    root = build.BUILD_DIR.parent / "variants"
    saved = (fa.launches, dict(splash.launches))
    for name in names:
        label, _, other = name.partition("=")
        if other:  # another tree's sources as they are
            shutil.rmtree(root / label, ignore_errors=True)
            use(Path(shutil.copytree(other, root / label)))
        else:
            use(make_sources(name, src, root / name))
        build.build(["flash_attention", "splash_attention"])
        o1 = fa.flash_attention(q1, k1, v1, kv_len=len1)
        o2, lse = splash._kernel_forward(q2s, k2, v2, len2, 1, -1)
        grads = splash._kernel_backward(q2s, k2, v2, len2, 1, -1, o2, lse,
                                        do2)
        torch.cuda.synchronize()
        errs = [float((o1[:, :, :400] - ref1).abs().max())] + [
            float((a - r).abs().max()) for a, r in zip((o2, *grads), ref2)]
        k1_ms = graph_ms(lambda: fa.flash_attention(q1, k1, v1, kv_len=len1))
        fwd_ms = graph_ms(lambda: splash._kernel_forward(q2s, k2, v2, len2,
                                                         1, -1))
        bwd_ms = graph_ms(lambda: splash._kernel_backward(
            q2s, k2, v2, len2, 1, -1, o2, lse, do2))
        print(f"[variant] {label:12s} K1 {k1_ms:.4f} ms | K2 fwd "
              f"{fwd_ms:.4f} ms, bwd {bwd_ms:.4f} ms | max |err| K1 "
              f"{errs[0]:.2e}, K2 out/dq/dk/dv "
              f"{'/'.join(f'{e:.2e}' for e in errs[1:])} | registers "
              f"{registers()}", flush=True)
    use(src)
    fa.launches = saved[0]
    splash.launches.update(saved[1])
    return 0


def flow_grads(names) -> int:
    if not torch.cuda.is_available():
        print("variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from minimax_speech_torch.infer.pipeline import TTSConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(torch.cuda.get_device_name(0), "|", cs.card_info(), flush=True)
    flow_cfg = TTSConfig().flow
    cfg, batch = cs.reduced_flow(flow_cfg), cs.flow_batch(flow_cfg)
    src = build.CSRC
    root = build.BUILD_DIR.parent / "variants"
    committed = splash._kernel_backward
    for seed in FLOW_SEEDS:
        truth, _ = cs.flow_first_grads(cfg, batch, "cpu", seed, double=True)
        symmetric, k2_leaves = cs.flow_leaves(list(truth))
        cpu, _ = cs.flow_first_grads(cfg, batch, "cpu", seed)

        def report(label, grads):
            err = cs.grad_errors(grads, truth, symmetric)
            k2 = max(err[n] for n in k2_leaves)
            rest = max(e for n, e in err.items() if n not in k2_leaves)
            vs_cpu = cs.grad_errors(grads, cpu, symmetric)
            worst = max(vs_cpu.values())
            print(f"[flow-grads] seed {seed} {label:12s} against float64: "
                  f"to_q/to_k {k2:.3e} ({max(k2_leaves, key=err.get)}), "
                  f"other leaves {rest:.3e} | against the CPU's float32: "
                  f"to_q/to_k {max(vs_cpu[n] for n in k2_leaves):.3e}, "
                  f"every leaf {worst:.3e}, phase 22's TRAIN_GRAD_RTOL "
                  f"{cs.TRAIN_GRAD_RTOL:g}: "
                  f"{'over' if worst > cs.TRAIN_GRAD_RTOL else 'within'}",
                  flush=True)

        report("CPU float32", cpu)
        for name in names:
            wrap = BACKWARDS.get(name)
            use(make_sources("committed" if wrap else name, src,
                             root / name))
            splash._kernel_backward = wrap(committed) if wrap else committed
            report(name, cs.flow_first_grads(cfg, batch, "cuda", seed)[0])
        splash._kernel_backward = committed
    use(src)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--flow-grads"]:
        sys.exit(flow_grads(sys.argv[2:] or
                            ["committed", *BACKWARDS, "tf32x4", "tf32x1"]))
    sys.exit(main(sys.argv[1:] or list(VARIANTS)))
