"""K2: differentiable chunk-causal attention with segment padding.

The kernels (csrc/splash_attention.cu, CUDA C++ for sm_90a: one forward,
two backward) replace the Pallas TPU splash kernel that
minimax_speech_tpu/kernels/splash.py configures; the source's header says
what bounds them and how they are laid out. This module holds:

  splash_chunk_attention / splash_causal_attention, the wrappers: they
      fold the 1/sqrt(d) scale into q in q's dtype (as JAX does), then
      take `_SplashFn` (the kernels) for CUDA tensors and
      `reference_splash_attention` for CPU tensors;
  reference_splash_attention, the plain PyTorch version: dense fp32
      scores, the mask below, softmax, cast back; autograd differentiates
      it;
  _SplashFn, the torch.autograd.Function around the kernels (CUDA
      tensors only). Saves q, k, v, O and the logsumexp.

Mask (row q of sample b sees key k iff all apply):
  chunk   k < (q // chunk + 1) * chunk, and with left_chunks >= 0 also
          k >= (q // chunk - left_chunks) * chunk; chunk <= 0 means none,
          chunk 1 with no left bound is plain causal
  segment (q < kv_len[b]) == (k < kv_len[b]): valid tokens are segment
          0, pads segment 1, and pads attend only to pads
so every row sees at least itself and no output row is undefined.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from minimax_speech_torch.kernels import build

NEG_INF = -1e30
# the head dims the kernels are instantiated for (csrc/attention_mma.cuh)
HEAD_DIMS = (8, 16, 64)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset (a caller sets them to 0): one per
# forward call, one per backward call (which runs the dK/dV and dQ kernels)
launches = {"forward": 0, "backward": 0}


@functools.cache
def _lib():
    lib = build.load("splash_attention")
    lib.mmst_splash_fwd.restype = ctypes.c_int
    lib.mmst_splash_fwd.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                                    + [ctypes.c_void_p])
    lib.mmst_splash_bwd.restype = ctypes.c_int
    lib.mmst_splash_bwd.argtypes = ([ctypes.c_void_p] * 10
                                    + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    return lib


def visible_mask(t: int, kv_len: torch.Tensor, chunk: int = 1,
                 left_chunks: int = -1) -> torch.Tensor:
    """(B, 1, T, T) bool: True where query q sees key k."""
    pos = torch.arange(t, device=kv_len.device)
    q_pos, k_pos = pos[:, None], pos[None, :]
    if chunk > 0:
        ok = k_pos < (q_pos // chunk + 1) * chunk
        if left_chunks >= 0:
            ok = ok & (k_pos >= (q_pos // chunk - left_chunks) * chunk)
    else:
        ok = torch.ones((t, t), dtype=torch.bool, device=kv_len.device)
    pad = pos[None, :] >= kv_len.to(torch.int64)[:, None]      # (B, T)
    same = pad[:, :, None] == pad[:, None, :]                   # (B, Tq, Tk)
    return (ok[None] & same)[:, None]


def _check_launch(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"splash attention {what} launch failed: CUDA "
                           f"error {rc}")


def _kernel_forward(q, k, v, kv_len, chunk, left_chunks):
    b, h, t, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    rc = _lib().mmst_splash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
        out.data_ptr(), lse.data_ptr(), b, h, t, d, chunk, left_chunks,
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _check_launch(rc, "forward")
    launches["forward"] += 1
    return out, lse


def _kernel_backward(q, k, v, kv_len, chunk, left_chunks, out, lse, dout):
    b, h, t, d = q.shape
    dout = dout.to(q.dtype).contiguous()
    delta = (dout.float() * out.float()).sum(-1).contiguous()
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    rc = _lib().mmst_splash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, h, t, d, chunk, left_chunks,
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _check_launch(rc, "backward")
    launches["backward"] += 1
    return dq, dk, dv


class _SplashFn(torch.autograd.Function):
    """Attention on scaled q through the kernels; CUDA tensors only."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len, chunk: int, left_chunks: int):
        if q.device.type != "cuda":
            raise ValueError(f"the splash kernels take CUDA tensors, got "
                             f"{q.device}")
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        kv_len = kv_len.to(device=q.device, dtype=torch.int32).contiguous()
        out, lse = _kernel_forward(q, k, v, kv_len, chunk, left_chunks)
        ctx.save_for_backward(q, k, v, kv_len, out, lse)
        ctx.mask = (chunk, left_chunks)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_len, out, lse = ctx.saved_tensors
        dq, dk, dv = _kernel_backward(q, k, v, kv_len, *ctx.mask, out, lse,
                                      dout)
        return dq, dk, dv, None, None, None


def _check(q, k, v, kv_len):
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share a (B, H, T, D) shape: "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k, v must share a dtype")
    b, h, t, d = q.shape
    if tuple(kv_len.shape) != (b,):
        raise ValueError(f"kv_len must be ({b},), got {tuple(kv_len.shape)}")
    if q.device.type == "cpu":
        return
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if d not in HEAD_DIMS:
        raise ValueError(f"the kernels take head_dim {HEAD_DIMS}, got {d}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"the kernel takes float32 or bfloat16, got {q.dtype}")
    if t == 0 or b * h == 0:
        raise ValueError("empty attention")


def splash_chunk_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           kv_len: torch.Tensor, chunk: int, left_chunks: int,
                           scale: float | None = None) -> torch.Tensor:
    """softmax(q k^T * scale) v under the chunk and segment masks above.
    q, k, v: (B, H, T, D) of one dtype on one device; kv_len: (B,) true
    lengths. Returns (B, H, T, D) in q's dtype. Differentiable.

    CUDA tensors go to the kernels (float32 or bfloat16, D in HEAD_DIMS)
    or raise; CPU tensors go to `reference_splash_attention`."""
    _check(q, k, v, kv_len)
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    if q.device.type == "cpu":
        return reference_splash_attention(q, k, v, kv_len, chunk, left_chunks,
                                          scale)
    q = (q * scale).to(q.dtype)
    return _SplashFn.apply(q, k, v, kv_len, int(chunk), int(left_chunks))


def splash_causal_attention(q, k, v, kv_len, scale: float | None = None):
    """Plain causal attention (k <= q) with segment padding: the LM
    training attention (models/qwen2.py)."""
    return splash_chunk_attention(q, k, v, kv_len, chunk=1, left_chunks=-1,
                                  scale=scale)


def reference_splash_attention(q, k, v, kv_len, chunk: int,
                               left_chunks: int,
                               scale: float | None = None) -> torch.Tensor:
    """The plain PyTorch version: scale folded into q in q's dtype, dense
    float32 scores (float64 for float64 inputs, a reference for the
    float32 paths), the mask, softmax, the result cast back to q's
    dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    acc = torch.promote_types(q.dtype, torch.float32)
    qs = (q * scale).to(q.dtype)
    s = torch.einsum("bhqd,bhkd->bhqk", qs.to(acc), k.to(acc))
    mask = visible_mask(q.shape[2], kv_len.to(q.device), chunk, left_chunks)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, v.to(acc)).to(q.dtype)


def rounded_delta_shift(q, k, v, out, dout, kv_len, chunk: int,
                        left_chunks: int, scale: float | None = None):
    """(dq, dk) in float32 that the kernels add to the plain version's
    autograd gradients by taking Delta = rowsum(dO * O) from `out`, their
    output in q's dtype, as JAX's splash backward does, where autograd
    uses the unrounded float32 output: dS moves by P * (D - D_out), so
    dq (for the unscaled q) by scale * dD * (P k) and dk by P^T (dD * q
    scaled). ~0 for float32 inputs; dv does not move."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    qs = (q * scale).to(q.dtype).float()
    s = torch.einsum("bhqd,bhkd->bhqk", qs, k.float())
    mask = visible_mask(q.shape[2], kv_len.to(q.device), chunk, left_chunks)
    p = torch.softmax(torch.where(mask, s, torch.full_like(s, NEG_INF)), -1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    dd = (dout.float() * (o - out.float())).sum(-1)
    dq = scale * dd[..., None] * torch.einsum("bhqk,bhkd->bhqd", p, k.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", p, dd[..., None] * qs)
    return dq, dk
