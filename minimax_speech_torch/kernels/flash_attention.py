"""K1: forward attention with pad, causal and chunk-causal masks.

The kernel (csrc/flash_attention.cu, CUDA C++ for sm_90a) replaces the
Pallas TPU kernel of minimax_speech_tpu/kernels/flash_attention.py; its
header says what bounds it and how it is built. This module holds the
wrapper, which launches the kernel for CUDA tensors, and
`reference_attention`, the plain PyTorch version of the same function,
which the wrapper uses only for CPU tensors.

mask modes (q sees k iff all apply):
  pad     k < kv_len[b]
  causal  k <= q
  chunk   k < (q // chunk + 1) * chunk, and with left_chunks >= 0 also
          k >= (q // chunk - left_chunks) * chunk
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from minimax_speech_torch.kernels import build

NEG_INF = -1e30
# the head dims the kernel is instantiated for (csrc/attention_mma.cuh)
HEAD_DIMS = (8, 16, 64)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset (a caller sets it to 0)
launches = 0


@functools.cache
def _fn():
    fn = build.load("flash_attention").mmst_flash_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_len: torch.Tensor | None = None, chunk: int = 0,
                    left_chunks: int = -1,
                    causal: bool = False) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v with the masks above. q, k, v: (B, H, T, D)
    of one dtype on one device; kv_len: (B,) ints or None (= T). Returns
    (B, H, T, D) in q's dtype. Query rows that see no key are undefined.

    CUDA tensors go to the kernel (float32 or bfloat16, contiguous, D in
    HEAD_DIMS) or raise; CPU tensors go to `reference_attention`. The
    kernel is forward-only: on CUDA, an input that requires grad under
    grad mode raises (kernels/splash.py, K2, is the differentiable
    route)."""
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share a (B, H, T, D) shape: "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k, v must share a dtype")
    b, h, t, d = q.shape
    if kv_len is not None and tuple(kv_len.shape) != (b,):
        raise ValueError(f"kv_len must be ({b},), got {tuple(kv_len.shape)}")
    if q.device.type == "cpu":
        return reference_attention(q, k, v, kv_len, chunk, left_chunks,
                                   causal)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "the K1 flash_attention kernel has no backward pass; under grad "
            "use kernels.splash.splash_chunk_attention (K2), which is "
            "differentiable")
    if d not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head_dim {HEAD_DIMS}, got {d}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"the kernel takes float32 or bfloat16, got {q.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    if t == 0 or b * h == 0:
        raise ValueError("empty attention")
    if kv_len is None:
        kv_len = torch.full((b,), t, dtype=torch.int32, device=q.device)
    kv_len = kv_len.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    rc = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
               out.data_ptr(), b, h, t, d, int(chunk), int(left_chunks),
               int(bool(causal)), _DTYPES[q.dtype],
               torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc}")
    global launches
    launches += 1
    return out


def visible_mask(t: int, kv_len: torch.Tensor | None, chunk: int = 0,
                 left_chunks: int = -1, causal: bool = False,
                 batch: int = 1, device=None) -> torch.Tensor:
    """(B, 1, T, T) bool: True where query q sees key k."""
    pos = torch.arange(t, device=device)
    k_pos, q_pos = pos[None, :], pos[:, None]
    mask = torch.ones((t, t), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if chunk > 0:
        mask = mask & (k_pos < (q_pos // chunk + 1) * chunk)
        if left_chunks >= 0:
            mask = mask & (k_pos >= torch.clamp(
                (q_pos // chunk - left_chunks) * chunk, min=0))
    mask = mask[None, None].expand(batch, 1, t, t)
    if kv_len is not None:
        mask = mask & (k_pos[None, None] < kv_len.to(device)[:, None, None,
                                                             None])
    return mask


def reference_attention(q, k, v, kv_len=None, chunk=0, left_chunks=-1,
                        causal=False) -> torch.Tensor:
    """The plain PyTorch version: dense scores in float32, the same masks,
    the result cast back to q's dtype."""
    b, h, t, d = q.shape
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(d)
    mask = visible_mask(t, kv_len, chunk, left_chunks, causal, b, q.device)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, v.float()).to(q.dtype)
