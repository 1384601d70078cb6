"""Why K1 and K2 split fp32 operands into two TF32 values (3xTF32).

The CUDA kernels (csrc/attention_mma.cuh) take every product on the
tensor cores with TF32 operands and fp32 accumulators. This file emulates
that arithmetic on the CPU: TF32 keeps 10 of fp32's 23 mantissa bits, and
cvt.rna.tf32.f32 rounds the low 13 bits to nearest, ties away from zero.
A product of two TF32 values is exact in fp32, so a float32 matmul of
TF32-valued operands is the tensor core's product up to the order of its
fp32 sums. Every product of K1's and K2's plain attention, forward and
autograd backward, runs through the emulation, and the result is held
against the plain fp32 version at the limits chip_smoke.py holds the
kernels to:

  * 3xTF32 (x = hi + lo, hi = tf32(x), lo = tf32(x - hi); a b = a_hi b_lo +
    a_lo b_hi + a_hi b_hi) meets them;
  * 1xTF32 (a_hi b_hi alone) fails them, so the limits tell the two apart;
  * a hi that is not rounded (the split taken against the rounded hi, but
    the raw fp32 register handed to the tensor core, which truncates it)
    does worse than the rounded one.
"""
import math

import numpy as np
import pytest
import torch

from minimax_speech_torch.kernels import flash_attention as fa
from minimax_speech_torch.kernels import splash
from tests import torch_cpu

torch_cpu.share_cores()

# chip_smoke.py's fp32 limits, |err| <= atol + rtol * |plain|
K1_TOL = (1e-5, 1e-5)
K2_OUT_TOL, K2_GRAD_TOL = (1e-5, 1e-5), (1e-5, 1e-4)
# shapes (B, H, T, D) with ragged lengths
CASES = [((2, 3, 77, 64), (77, 40)), ((2, 2, 128, 64), (128, 77))]


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 as cvt.rna does: round to nearest on the low 13 bits,
    ties away from zero (on the magnitude bits of a sign-magnitude
    float)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_truncate(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 as the tensor core reads a raw fp32 register."""
    bits = x.float().contiguous().view(torch.int32)
    return (bits & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor, mode: str):
    """The (hi, lo) pair a kernel hands to the tensor core for x."""
    hi = tf32_round(x)
    lo = tf32_round(x - hi)
    if mode == "3x_unrounded_hi":
        return tf32_truncate(x), lo
    return hi, lo


def product(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """a @ b (batched) as the tensor cores take it in `mode`."""
    if mode == "fp32":
        return a @ b
    if mode == "1x":
        return tf32_round(a) @ tf32_round(b)
    (ah, al), (bh, bl) = split(a, mode), split(b, mode)
    return ah @ bl + al @ bh + ah @ bh


class _Product(torch.autograd.Function):
    """a @ b whose backward products are emulated in the same mode."""

    @staticmethod
    def forward(ctx, a, b, mode):
        ctx.save_for_backward(a, b)
        ctx.mode = mode
        return product(a, b, mode)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return (product(g, b.transpose(-1, -2), ctx.mode),
                product(a.transpose(-1, -2), g, ctx.mode), None)


def mm(a, b, mode):
    return _Product.apply(a, b, mode)


def k1_attention(q, k, v, kv_len, mode, **kw):
    """fa.reference_attention with its two products in `mode`."""
    d = q.shape[-1]
    s = mm(q, k.transpose(-1, -2), mode) / math.sqrt(d)
    mask = fa.visible_mask(q.shape[2], kv_len, batch=q.shape[0], **kw)
    s = torch.where(mask, s, torch.full_like(s, fa.NEG_INF))
    return mm(torch.softmax(s, -1), v, mode)


def k2_attention(q, k, v, kv_len, mode, chunk=1, left_chunks=-1):
    """splash.reference_splash_attention with its products in `mode`
    (the scale folded into q first, as the wrapper does)."""
    qs = q * (1.0 / math.sqrt(q.shape[-1]))
    s = mm(qs, k.transpose(-1, -2), mode)
    mask = splash.visible_mask(q.shape[2], kv_len, chunk, left_chunks)
    s = torch.where(mask, s, torch.full_like(s, splash.NEG_INF))
    return mm(torch.softmax(s, -1), v, mode)


def _inputs(seed, shape, n=4):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal(shape).astype(np.float32))
            for _ in range(n)]


def need_atol(ours, ref, rtol, rows=None):
    """The least atol for |ours - ref| <= atol + rtol |ref|; with `rows`
    (kv_len), only the query rows < kv_len of each sample."""
    if rows is not None:
        return max(need_atol(ours[i, :, :n], ref[i, :, :n], rtol)
                   for i, n in enumerate(rows))
    return float(((ours - ref).abs() - rtol * ref.abs()).max())


def k1_needs(mode, shape, kv, **kw):
    q, k, v = _inputs(shape[2], shape, 3)
    lens = torch.tensor(kv)
    ref = k1_attention(q, k, v, lens, "fp32", **kw)
    torch.testing.assert_close(ref, fa.reference_attention(q, k, v, lens,
                                                           **kw))
    out = k1_attention(q, k, v, lens, mode, **kw)
    return need_atol(out, ref, K1_TOL[1], kv)


def k2_needs(mode, shape, kv, chunk=1, left=-1):
    """Least atol of (out, dq, dk, dv) against the plain fp32 version."""
    q, k, v, do = _inputs(shape[2] + 1, shape)
    lens = torch.tensor(kv)

    def run(m):
        x = [a.clone().requires_grad_() for a in (q, k, v)]
        out = k2_attention(*x, lens, m, chunk, left)
        return [out.detach()] + list(torch.autograd.grad(out, x, do))

    ref = run("fp32")
    torch.testing.assert_close(ref[0], splash.reference_splash_attention(
        q, k, v, lens, chunk, left))
    ours = run(mode)
    return [need_atol(a, r, tol[1]) for a, r, tol in
            zip(ours, ref, [K2_OUT_TOL] + [K2_GRAD_TOL] * 3)]


def test_tf32_rounding_matches_cvt_rna():
    """Round to nearest on the low 13 bits, ties away from zero; the
    result has 10 stored mantissa bits; truncation drops them."""
    one = 1.0 + 2.0 ** -10                       # exact in TF32
    x = torch.tensor([1.0 + 2.0 ** -11,         # tie: away from zero
                      -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -11 - 2.0 ** -23,  # below the tie
                      one, 3.0e-3, 0.0])
    assert tf32_round(x).tolist()[:4] == [one, -one, 1.0, one]
    assert tf32_truncate(x)[:3].tolist() == [1.0, -1.0, 1.0]
    bits = tf32_round(torch.randn(1000)).view(torch.int32)
    assert int((bits & 0x1FFF).abs().max()) == 0
    y = torch.randn(1000)
    hi, lo = split(y, "3x")
    # hi + lo carries x to ~2^-22 relative; hi alone to ~2^-11
    assert float(((hi + lo - y).abs() / y.abs()).max()) < 2.0 ** -20
    assert float(((hi - y).abs() / y.abs()).max()) > 2.0 ** -14


@pytest.mark.parametrize("mode", ["full", "causal", "chunk50_left2"])
@pytest.mark.parametrize("shape,kv", CASES)
def test_k1_three_tf32_meets_the_fp32_limit(mode, shape, kv):
    kw = {"full": {}, "causal": {"causal": True},
          "chunk50_left2": {"chunk": 50, "left_chunks": 2}}[mode]
    need3 = k1_needs("3x", shape, kv, **kw)
    need1 = k1_needs("1x", shape, kv, **kw)
    assert need3 <= K1_TOL[0], need3
    assert need1 > K1_TOL[0], need1


@pytest.mark.parametrize("chunk,left", [(1, -1), (50, 2)])
@pytest.mark.parametrize("shape,kv", CASES)
def test_k2_three_tf32_meets_the_fp32_limits(chunk, left, shape, kv):
    """Output and dq, dk, dv, with the backward's products emulated too."""
    need3 = k2_needs("3x", shape, kv, chunk, left)
    need1 = k2_needs("1x", shape, kv, chunk, left)
    assert need3[0] <= K2_OUT_TOL[0], need3
    assert max(need3[1:]) <= K2_GRAD_TOL[0], need3
    assert need1[0] > K2_OUT_TOL[0] and max(need1[1:]) > K2_GRAD_TOL[0], \
        need1


@pytest.mark.parametrize("shape,kv", CASES)
def test_unrounded_hi_does_worse(shape, kv):
    """Handing the tensor core the raw register for hi (it truncates)
    while lo was taken against the rounded hi leaves the difference out
    of both terms: the error grows well past the rounded split's."""
    rounded = k1_needs("3x", shape, kv, causal=True)
    unrounded = k1_needs("3x_unrounded_hi", shape, kv, causal=True)
    assert unrounded > 4 * max(rounded, 1e-8), (unrounded, rounded)
    grads = k2_needs("3x", shape, kv)
    grads_unrounded = k2_needs("3x_unrounded_hi", shape, kv)
    assert max(grads_unrounded) > 4 * max(max(grads), 1e-8), \
        (grads_unrounded, grads)
