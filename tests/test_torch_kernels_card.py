"""The attention kernels K1 (csrc/flash_attention.cu) and K2
(csrc/splash_attention.cu) against their plain PyTorch versions on the
card. This file imports no JAX, so that

    python -m pytest -m cuda tests/test_torch_kernels_card.py \
        tests/test_torch_flow_card.py

runs on a machine that has the card and not the JAX package; without a
card every case skips. The plain versions are held against the JAX
package on the CPU by tests/test_torch_attention.py and
tests/test_torch_splash.py.
"""
import pytest
import torch

from minimax_speech_torch.kernels import flash_attention as t_fa
from minimax_speech_torch.kernels import splash as t_sp

K1_MODES = {"full": {}, "causal": dict(causal=True), "chunk": dict(chunk=50),
            "chunk_left": dict(chunk=50, left_chunks=2)}
K2_MODES = {"causal": (1, -1), "full": (0, -1), "chunk": (50, -1),
            "chunk_left": (50, 2)}


@pytest.mark.cuda
@pytest.mark.parametrize("d", t_fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", list(K1_MODES))
@pytest.mark.parametrize("t,kv_len", [(506, (400, 400)), (77, (77, 40))])
def test_k1_matches_plain_on_card(dtype, mode, t, kv_len, d):
    """The CUDA kernel against the plain version on the card, valid rows,
    at every head dim it is built for.
    float32: 1e-5 (same math, other summation order; TF32 off). bf16:
    one bf16 ulp of the value (both round an fp32 result) plus 1e-5 for
    fp32 noise on elements near zero, chip_smoke.py's limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((2, 8, t, d), generator=g, device="cuda")
               .to(dtype) for _ in range(3))
    lens = torch.tensor(kv_len, device="cuda")
    before = t_fa.launches
    out = t_fa.flash_attention(q, k, v, kv_len=lens, **K1_MODES[mode])
    torch.cuda.synchronize()
    assert t_fa.launches == before + 1
    ref = t_fa.reference_attention(q, k, v, lens, **K1_MODES[mode])
    atol, rtol = (1e-5, 1e-5) if dtype == torch.float32 else (1e-5, 2 ** -7)
    for i, n in enumerate(kv_len):
        torch.testing.assert_close(out[i, :, :n].float(),
                                   ref[i, :, :n].float(), atol=atol,
                                   rtol=rtol)


@pytest.mark.cuda
def test_k1_refuses_grad_on_card():
    """On CUDA, an input that requires grad under grad mode raises and
    names K2; under no_grad the same call launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v = (torch.randn((1, 2, 70, 64), device="cuda") for _ in range(3))
    with pytest.raises(RuntimeError, match="K2"):
        t_fa.flash_attention(q.requires_grad_(), k, v)
    with torch.no_grad():
        assert t_fa.flash_attention(q, k, v).shape == q.shape


@pytest.mark.cuda
@pytest.mark.parametrize("d", t_sp.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", list(K2_MODES))
@pytest.mark.parametrize("shape,kv_len", [((2, 14, 512), (512, 301)),
                                          ((2, 8, 77), (77, 40))])
def test_k2_matches_plain_on_card(dtype, mode, shape, kv_len, d):
    """The CUDA kernels against the plain version on the card at every
    head dim they are built for, all rows, the wrapper at its default
    scale s = 1/sqrt(d): forward and dq, dk, dv, |err| <= atol + rtol *
    |ref|. float32: the same math in other summation orders (TF32 off),
    1e-5 + 1e-5 on the output and 1e-5 + 1e-4 on the gradients. bf16:
    both sides round an fp32 result, so they may differ by one bf16 ulp
    (rtol 2^-7); dq and dk are compared after the known shift of the
    kernels' Delta, taken from the rounded output (rounded_delta_shift);
    atol 1e-5 and 1e-4 cover fp32 noise on elements near zero. dq is s
    times the gradient that reaches the scaled q, in float32, on both
    sides: autograd of the scaling rounds it once more, exactly where s
    is a power of two (d = 16, 64), by up to half an ulp on each side at
    d = 8. The kernels' autograd dq is that gradient times s in q's
    dtype, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    chunk, left = K2_MODES[mode]
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn((*shape, d), generator=g, device="cuda")
                   .to(dtype) for _ in range(4))
    lens = torch.tensor(kv_len, device="cuda")
    s = d ** -0.5

    before = dict(t_sp.launches)
    x = [a.clone().requires_grad_() for a in (q, k, v)]
    out = t_sp.splash_chunk_attention(*x, lens, chunk, left)
    caught = []
    # the node that scaled q: the gradient it receives is the kernels' dq
    out.grad_fn.next_functions[0][0].register_prehook(
        lambda grads: caught.append(grads[0]))
    dq, dk, dv = torch.autograd.grad(out, x, do)
    torch.cuda.synchronize()
    assert t_sp.launches["forward"] == before["forward"] + 1
    assert t_sp.launches["backward"] == before["backward"] + 1
    assert torch.equal(dq, (caught[0] * s).to(dtype))
    ours = [out.detach(), caught[0].float() * s, dk, dv]
    # the plain version from the same scaled q, at scale 1
    x = [(q * s).to(dtype)] + [k, v]
    x = [a.clone().requires_grad_() for a in x]
    ref = t_sp.reference_splash_attention(*x, lens, chunk, left, scale=1.0)
    ref = [ref.detach()] + list(torch.autograd.grad(ref, x, do))
    ref[1] = ref[1].float() * s
    dq_shift, dk_shift = t_sp.rounded_delta_shift(q, k, v, ours[0], do, lens,
                                                  chunk, left)
    f32 = dtype == torch.float32
    tols = [(1e-5, 1e-5) if f32 else (1e-5, 2 ** -7)] \
        + [(1e-5, 1e-4) if f32 else (1e-4, 2 ** -7)] * 3
    for a, r, shift, (atol, rtol) in zip(ours, ref, (0, dq_shift, dk_shift, 0),
                                         tols):
        torch.testing.assert_close(a.float() - shift, r.float(), atol=atol,
                                   rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [4, 32, 128])
def test_kernels_refuse_other_head_dims_on_card(d):
    """A head dim outside HEAD_DIMS raises on CUDA and names the set; it
    never drops to the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v = (torch.randn((1, 2, 70, d), device="cuda") for _ in range(3))
    lens = torch.tensor([70], device="cuda")
    before = (t_fa.launches, dict(t_sp.launches))
    with pytest.raises(ValueError, match=r"\(8, 16, 64\)"):
        with torch.no_grad():
            t_fa.flash_attention(q, k, v, kv_len=lens)
    with pytest.raises(ValueError, match=r"\(8, 16, 64\)"):
        t_sp.splash_causal_attention(q, k, v, lens)
    assert (t_fa.launches, dict(t_sp.launches)) == before


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["none", "dots"])
def test_k2_under_remat_on_card(policy):
    """A 2-layer Qwen2 training forward and backward on the card with
    per-layer remat against the same weights without it: output and every
    parameter's gradient within 1e-6 of their largest element (the
    recompute repeats the same float32 work; TF32 off), and K2's forward
    counter counts each layer's recompute (2 launches per layer, against
    1 without remat) while the backward launches once per layer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from minimax_speech_torch.models import qwen2 as t_qwen2

    torch.backends.cuda.matmul.allow_tf32 = False
    geo = dict(vocab_size=50, hidden_size=896, n_layers=2, n_heads=14,
               n_kv_heads=2, head_dim=64, intermediate_size=4864)
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((2, 300, 896), generator=g, device="cuda") * 0.3
    pos = torch.arange(300, device="cuda")[None].expand(2, 300)
    lens = torch.tensor([300, 171], device="cuda", dtype=torch.int32)
    runs = {}
    for mode in ("off", policy):
        torch.manual_seed(0)
        model = t_qwen2.Qwen2Model(t_qwen2.Qwen2Config(
            **geo, remat=mode != "off", remat_policy=policy)).cuda()
        t_sp.launches.update(forward=0, backward=0)
        out = model(x, pos, None, lengths=lens)
        grads = torch.autograd.grad(out.square().mean(),
                                    list(model.parameters()))
        torch.cuda.synchronize()
        runs[mode] = (out.detach(), grads, dict(t_sp.launches))
    (out, grads, n), (out_r, grads_r, n_r) = runs["off"], runs[policy]
    assert n == {"forward": 2, "backward": 2}
    assert n_r == {"forward": 4, "backward": 2}
    for a, b in zip((out, *grads), (out_r, *grads_r)):
        torch.testing.assert_close(b, a, rtol=0,
                                   atol=1e-6 * float(a.abs().max()))
