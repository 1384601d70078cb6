"""K1 (kernels/flash_attention.py of the port) against the JAX package.

On the CPU the port's wrapper runs its plain version; it is held against
the JAX Pallas kernel run in interpret mode (patched as
tests/test_flash_attention.py does) and against JAX reference_attention,
in every mask mode, with ragged kv_len and T not a multiple of 128.
Only query rows < kv_len are compared: padded rows are undefined.
Tolerance 2e-5 absolute: float32 softmax attention of O(1) values with
sums taken in different orders.

The CUDA kernel itself is compared with the plain version on the card
by the `cuda`-marked test, which skips where there is no GPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minimax_speech_torch.kernels import flash_attention as t_fa
from minimax_speech_tpu.kernels import flash_attention as j_fa

MODES = {"full": {}, "causal": dict(causal=True), "chunk": dict(chunk=50),
         "chunk_left": dict(chunk=50, left_chunks=2)}


def _pallas_interpret(q, k, v, **kw):
    from jax.experimental import pallas as pl
    orig = pl.pallas_call

    def patched(*a, **kws):
        kws.setdefault("interpret", True)
        return orig(*a, **kws)

    pl.pallas_call = patched
    try:
        return j_fa.flash_attention.__wrapped__(q, k, v, **kw)
    finally:
        pl.pallas_call = orig


def _qkv(rng, b, h, t, d):
    return [rng.standard_normal((b, h, t, d)).astype(np.float32)
            for _ in range(3)]


def _valid_rows_close(ours, ref, kv_len, atol=2e-5):
    for i, n in enumerate(kv_len):
        np.testing.assert_allclose(ours[i, :, :n], ref[i, :, :n], atol=atol,
                                   rtol=1e-4)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("t,kv_len", [(256, (256, 173)), (77, (77, 40))])
def test_plain_matches_jax(rng, mode, t, kv_len):
    kw = MODES[mode]
    q, k, v = _qkv(rng, 2, 2, t, 64)
    lens = np.array(kv_len, np.int32)
    ours = t_fa.flash_attention(*map(torch.as_tensor, (q, k, v)),
                                kv_len=torch.as_tensor(lens), **kw).numpy()
    ref = np.asarray(j_fa.reference_attention(
        *map(jnp.asarray, (q, k, v)), kv_len=jnp.asarray(lens), **kw))
    _valid_rows_close(ours, ref, kv_len)
    # the Pallas kernel, interpreted; 128-row blocks where T allows
    blk = 128 if t % 128 == 0 else t
    pallas = np.asarray(_pallas_interpret(
        *map(jnp.asarray, (q, k, v)), kv_len=jnp.asarray(lens),
        block_q=blk, block_k=blk, **kw))
    _valid_rows_close(ours, pallas, kv_len)


def test_plain_keeps_dtype_and_defaults(rng):
    q, k, v = (torch.as_tensor(a) for a in _qkv(rng, 1, 2, 20, 8))
    full = t_fa.flash_attention(q, k, v)
    same = t_fa.flash_attention(q, k, v, kv_len=torch.tensor([20]))
    torch.testing.assert_close(full, same, atol=0, rtol=0)
    out = t_fa.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16())
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), full, atol=2e-2, rtol=1e-2)


def test_wrapper_rejects_bad_inputs(rng):
    q, k, v = (torch.as_tensor(a) for a in _qkv(rng, 1, 2, 20, 8))
    with pytest.raises(ValueError, match="shape"):
        t_fa.flash_attention(q, k[:, :, :10], v)
    with pytest.raises(ValueError, match="dtype"):
        t_fa.flash_attention(q, k.double(), v)
    with pytest.raises(ValueError, match="kv_len"):
        t_fa.flash_attention(q, k, v, kv_len=torch.tensor([3, 4]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("t,kv_len", [(506, (400, 400)), (77, (77, 40))])
def test_kernel_matches_plain_on_card(dtype, mode, t, kv_len):
    """The CUDA kernel against the plain version on the card, valid rows.
    float32: 1e-5 (same math, other summation order; TF32 off). bf16:
    one bf16 ulp of the value (both round an fp32 result) plus 1e-5 for
    fp32 noise on elements near zero, chip_smoke.py's limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((2, 8, t, 64), generator=g, device="cuda")
               .to(dtype) for _ in range(3))
    lens = torch.tensor(kv_len, device="cuda")
    before = t_fa.launches
    out = t_fa.flash_attention(q, k, v, kv_len=lens, **MODES[mode])
    torch.cuda.synchronize()
    assert t_fa.launches == before + 1
    ref = t_fa.reference_attention(q, k, v, lens, **MODES[mode])
    atol, rtol = (1e-5, 1e-5) if dtype == torch.float32 else (1e-5, 2 ** -7)
    for i, n in enumerate(kv_len):
        torch.testing.assert_close(out[i, :, :n].float(),
                                   ref[i, :, :n].float(), atol=atol,
                                   rtol=rtol)


def test_plain_differentiates_on_cpu(rng):
    """CPU tensors that require grad go through the plain version, which
    autograd differentiates (the kernel, forward-only, refuses them)."""
    q, k, v = (torch.tensor(a, requires_grad=True)
               for a in _qkv(rng, 1, 2, 20, 8))
    out = t_fa.flash_attention(q, k, v, kv_len=torch.tensor([13]),
                               causal=True)
    grads = torch.autograd.grad(out[:, :, :13].square().sum(), (q, k, v))
    assert all(torch.isfinite(g).all() and g.abs().sum() > 0 for g in grads)


@pytest.mark.cuda
def test_kernel_refuses_grad_on_card():
    """On CUDA, an input that requires grad under grad mode raises and
    names K2; under no_grad the same call launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v = (torch.randn((1, 2, 70, 64), device="cuda") for _ in range(3))
    with pytest.raises(RuntimeError, match="K2"):
        t_fa.flash_attention(q.requires_grad_(), k, v)
    with torch.no_grad():
        assert t_fa.flash_attention(q, k, v).shape == q.shape
