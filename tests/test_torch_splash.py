"""K2 (kernels/splash.py of the port) against the JAX package's splash.

On the CPU the port's wrapper runs `reference_splash_attention`, its plain
version; it is held against JAX `splash_chunk_attention` run in interpret
mode (splash._INTERPRET, as tests/test_llm.py sets it), output and the
vjp for dq, dk and dv, in every mask mode with ragged kv_len. All rows are
compared, pad rows included: pads attend only to pads, by segment ids.
Tolerance: float32 attention of O(1) values with sums in other orders,
atol 2e-5 and rtol 2e-4.

The autograd.Function around the kernels takes CUDA tensors only and
raises for CPU ones. tests/test_torch_kernels_card.py, which imports no
JAX, holds the CUDA kernels against the plain version on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minimax_speech_torch.kernels import splash as t_sp
from minimax_speech_tpu.kernels import splash as j_sp
from tests import torch_cpu

torch_cpu.share_cores()

MODES = {"causal": (1, -1), "full": (0, -1), "chunk": (50, -1),
         "chunk_left": (50, 2)}
ATOL, RTOL = 2e-5, 2e-4


def _inputs(seed, b, h, t, d=64):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, t, d)).astype(np.float32)
            for _ in range(4)]


def _port(q, k, v, g, lens, chunk, left):
    q, k, v = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = t_sp.splash_chunk_attention(q, k, v, torch.as_tensor(lens), chunk,
                                      left)
    grads = torch.autograd.grad(out, (q, k, v), torch.as_tensor(g))
    return [out.detach().numpy()] + [x.numpy() for x in grads]


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("t,kv_len", [(128, (128, 77)), (256, (201, 64))])
def test_plain_matches_jax_splash(mode, t, kv_len):
    chunk, left = MODES[mode]
    q, k, v, g = _inputs(t, 2, 2, t)
    lens = np.array(kv_len, np.int32)
    j_sp._INTERPRET = True
    try:
        out, vjp = jax.vjp(
            lambda a, b, c: j_sp.splash_chunk_attention(
                a, b, c, jnp.asarray(lens), chunk, left),
            *map(jnp.asarray, (q, k, v)))
        ref = [out] + list(vjp(jnp.asarray(g)))
    finally:
        j_sp._INTERPRET = False
    ours = _port(q, k, v, g, lens, chunk, left)
    for name, a, r in zip(("out", "dq", "dk", "dv"), ours, ref):
        np.testing.assert_allclose(a, np.asarray(r), atol=ATOL, rtol=RTOL,
                                   err_msg=name)


def test_plain_is_causal_at_chunk_one():
    """splash_causal_attention is chunk 1 with no left bound, and a pad
    row at the start of a window sees only pads."""
    q, k, v, _ = (torch.as_tensor(a) for a in _inputs(0, 1, 2, 20))
    lens = torch.tensor([13])
    a = t_sp.splash_causal_attention(q, k, v, lens)
    b = t_sp.splash_chunk_attention(q, k, v, lens, 1, -1)
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    mask = t_sp.visible_mask(20, lens, 1, -1)[0, 0]
    assert mask[13].nonzero().flatten().tolist() == [13]
    assert mask[12].nonzero().flatten().tolist() == list(range(13))
    # row 13 is the first pad: it sees only itself, so its output is v[13]
    torch.testing.assert_close(a[0, :, 13], v[0, :, 13], atol=1e-6, rtol=0)


def test_function_rejects_cpu_tensors():
    """The autograd.Function launches the kernels only: given CPU tensors
    it raises and counts no launch."""
    q, k, v, _ = (torch.as_tensor(a) for a in _inputs(7, 2, 3, 77))
    before = dict(t_sp.launches)
    with pytest.raises(ValueError, match="CUDA"):
        t_sp._SplashFn.apply(q, k, v, torch.tensor([77, 40]), 1, -1)
    assert t_sp.launches == before


@pytest.mark.parametrize("mode", ["causal", "chunk_left"])
def test_rounded_delta_shift_explains_rounded_delta(mode):
    """FA2's backward with Delta = rowsum(dO * O) taken from the bf16
    output, written out in float32 (what the kernels compute), equals
    autograd of the plain version plus rounded_delta_shift."""
    chunk, left = MODES[mode]
    q, k, v, do = (torch.as_tensor(a).bfloat16()
                   for a in _inputs(3, 2, 2, 128))
    lens = torch.tensor([128, 77])
    x = [a.clone().requires_grad_() for a in (q, k, v)]
    out = t_sp.reference_splash_attention(*x, lens, chunk, left)
    dq_ref, dk_ref, _ = torch.autograd.grad(out, x, do)

    scale = 0.125
    qs = (q * scale).bfloat16().float()
    s = torch.einsum("bhqd,bhkd->bhqk", qs, k.float())
    mask = t_sp.visible_mask(128, lens, chunk, left)
    p = torch.softmax(torch.where(mask, s, torch.tensor(-1e30)), -1)
    delta = (do.float() * out.detach().float()).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float()) - delta)
    dq = scale * torch.einsum("bhqk,bhkd->bhqd", ds, k.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qs)

    dq_shift, dk_shift = t_sp.rounded_delta_shift(q, k, v, out.detach(), do,
                                                  lens, chunk, left)
    assert float(dq_shift.abs().max()) > 1e-4  # the shift is not nothing
    # against autograd's gradients, rounded to bf16: half a bf16 ulp
    torch.testing.assert_close(dq_ref.float() + dq_shift, dq, atol=1e-5,
                               rtol=2 ** -8)
    torch.testing.assert_close(dk_ref.float() + dk_shift, dk, atol=1e-5,
                               rtol=2 ** -8)


def test_wrapper_rejects_bad_inputs():
    q, k, v, _ = (torch.as_tensor(a) for a in _inputs(1, 1, 2, 20))
    with pytest.raises(ValueError, match="shape"):
        t_sp.splash_causal_attention(q, k[:, :, :10], v, torch.tensor([20]))
    with pytest.raises(ValueError, match="dtype"):
        t_sp.splash_causal_attention(q, k.double(), v, torch.tensor([20]))
    with pytest.raises(ValueError, match="kv_len"):
        t_sp.splash_causal_attention(q, k, v, torch.tensor([3, 4]))
