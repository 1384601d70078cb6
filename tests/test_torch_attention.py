"""K1 (kernels/flash_attention.py of the port) against the JAX package.

On the CPU the port's wrapper runs its plain version; it is held against
the JAX Pallas kernel run in interpret mode (patched as
tests/test_flash_attention.py does) and against JAX reference_attention,
in every mask mode, with ragged kv_len and T not a multiple of 128.
Only query rows < kv_len are compared: padded rows are undefined.
Tolerance 2e-5 absolute: float32 softmax attention of O(1) values with
sums taken in different orders.

The CUDA kernel itself is held against the plain version on the card
by tests/test_torch_kernels_card.py, which imports no JAX.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minimax_speech_torch.kernels import flash_attention as t_fa
from minimax_speech_tpu.kernels import flash_attention as j_fa
from tests import torch_cpu

torch_cpu.share_cores()

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


def test_plain_differentiates_on_cpu(rng):
    """CPU tensors that require grad go through the plain version, which
    autograd differentiates (the kernel, forward-only, refuses them)."""
    q, k, v = (torch.tensor(a, requires_grad=True)
               for a in _qkv(rng, 1, 2, 20, 8))
    out = t_fa.flash_attention(q, k, v, kv_len=torch.tensor([13]),
                               causal=True)
    grads = torch.autograd.grad(out[:, :, :13].square().sum(), (q, k, v))
    assert all(torch.isfinite(g).all() and g.abs().sum() > 0 for g in grads)
