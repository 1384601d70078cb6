"""The yardstick: one H100's peaks, the operations and bytes of each
kernel's call from its shapes, and the model FLOPs of useful work.

Peaks (NVIDIA's data sheet, H100 SXM, dense, at 700 W): 989 TFLOP/s
bf16, 494.7 TFLOP/s TF32, 67 TFLOP/s float32 outside the tensor cores,
3.35 TB/s of HBM. The port's float32 attention kernels (K1, K2) compute
each product as three TF32 products (3xTF32), so their compute peak is
494.7 / 3 TFLOP/s. A roofline share is the least time the chip could
take (the larger of operations over the peak and bytes over the
bandwidth) over the time the kernel took; each input byte is counted
read once and each output byte written once, and the operations are the
algorithm's for the pairs the mask lets through, whatever implements
them. `mfu` shares are useful model FLOPs over the window times the
dense bf16 peak.
"""
from __future__ import annotations

import json
from pathlib import Path

PEAK_BF16 = 989e12
PEAK_TF32 = 494.7e12
PEAK_ATTN_FP32 = PEAK_TF32 / 3.0  # 3xTF32 products
HBM_BYTES_S = 3.35e12


def visible_pairs(kv_len: int, chunk: int = 0, causal: bool = False) -> int:
    """Key-query pairs a valid query row (q < kv_len) sees: all valid
    keys, or with `chunk` the keys before its chunk's end, or with
    `causal` the keys up to itself."""
    n = int(kv_len)
    if causal:
        return n * (n + 1) // 2
    if chunk <= 0:
        return n * n
    full, rest = divmod(n, chunk)
    # chunk j (queries j*c .. j*c+c-1) sees (j+1)*c keys, the last
    # partial chunk sees all n
    return chunk * chunk * full * (full + 1) // 2 + rest * n


def attention_work(kv_lens, heads: int, head_dim: int, elem_bytes: int,
                   chunk: int = 0, causal: bool = False,
                   backward: bool = False) -> tuple[float, float]:
    """(FLOPs, bytes) of one attention call over rows with key lengths
    kv_lens: forward 4 d per pair (q k^T, then p v); the backward's four
    products 8 d per pair. Bytes: q, k, v read and o written, and for
    the backward q, k, v, o, do read and dq, dk, dv written, over the
    valid rows."""
    pairs = sum(visible_pairs(n, chunk, causal) for n in kv_lens)
    rows = sum(int(n) for n in kv_lens)
    per_pair = 8 if backward else 4
    tensors = 8 if backward else 4
    return (float(per_pair * head_dim * heads * pairs),
            float(tensors * rows * heads * head_dim * elem_bytes))


def bound_s(flops: float, n_bytes: float, peak: float) -> float:
    return max(flops / peak, n_bytes / HBM_BYTES_S)


def lm_token_flops(qwen: dict, vocab: int, ctx: int) -> float:
    """FLOPs of one token through the Qwen2 body and the LM head, at
    context length ctx: 2 per weight of every projection and the head,
    4 d per attended position per head."""
    c, i, h, kvh, d = (qwen["hidden_size"], qwen["intermediate_size"],
                       qwen["n_heads"], qwen["n_kv_heads"], qwen["head_dim"])
    per_layer = c * h * d * 2 + 2 * c * kvh * d + 3 * c * i
    dense = qwen["n_layers"] * per_layer + c * vocab
    return 2.0 * dense + 4.0 * qwen["n_layers"] * h * d * ctx


def lm_nonembedding_params(qwen: dict, vocab: int) -> int:
    c, i, h, kvh, d = (qwen["hidden_size"], qwen["intermediate_size"],
                       qwen["n_heads"], qwen["n_kv_heads"], qwen["head_dim"])
    per_layer = (c * h * d + h * d + 2 * (c * kvh * d + kvh * d)
                 + h * d * c + 3 * c * i + 2 * c)
    return qwen["n_layers"] * per_layer + c + c * vocab + vocab


def _dense_flops(fn) -> float:
    """FLOPs of the matrix products and convolutions `fn` runs (batched
    products, i.e. attention, left out), counted on meta tensors."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        fn()
    counts = fc.get_flop_counts().get("Global", {})
    return float(sum(v for k, v in counts.items() if "bmm" not in str(k)))


def per_frame_flops(model_cfg: dict, cache: Path | None = None) -> dict:
    """Dense FLOPs per unit of the flow's encoder (per token), one UNet
    pass (per frame), and the vocoder (per frame of its input), from the
    plain reference on the meta device at two lengths (they are linear
    in the length). Cached in `cache` when given."""
    key = json.dumps(model_cfg, sort_keys=True)
    if cache is not None and cache.exists():
        saved = json.loads(cache.read_text())
        if saved.get("key") == key:
            return saved["flops"]
    import torch

    from speechbench.reference import flow, models
    out = {}
    with torch.device("meta"):
        fm = flow.FlowModel(models.build_flow_config(model_cfg))
        voc = models.vocoder(model_cfg)

        def at(t, what):
            if what == "encoder":
                tok = torch.zeros(1, t, dtype=torch.long)
                return _dense_flops(lambda: fm.encode_tokens(
                    tok, torch.full((1,), t)))
            if what == "unet":
                x = torch.zeros(1, t, 80)
                return _dense_flops(lambda: fm.estimate(
                    x, torch.ones(1, t), x, torch.zeros(1),
                    torch.zeros(1, 80), x))
            x = torch.zeros(1, t, 80)
            if model_cfg["output_type"] == "latent":
                return _dense_flops(lambda: voc.decode(x))
            return _dense_flops(lambda: voc.decode(
                x, torch.zeros(1, t * voc.cfg.total_upsample, 1)))

        for what in ("encoder", "unet", "vocoder"):
            a, b = at(64, what), at(128, what)
            out[what] = (b - a) / 64.0
    if cache is not None:
        cache.parent.mkdir(parents=True, exist_ok=True)
        cache.write_text(json.dumps({"key": key, "flops": out}))
    return out

