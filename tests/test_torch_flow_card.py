"""The flow UNet under grad on the card: K2, not K1, and the CPU's
gradients. This file imports no JAX, so that `python -m pytest -m cuda
tests/test_torch_flow_card.py` runs on a machine that has the card and
not the JAX package; without a card it skips.
"""
import dataclasses

import numpy as np
import pytest
import torch

from minimax_speech_torch.models import decoder_unet as t_unet
from minimax_speech_torch.utils import params_io as t_io


@pytest.mark.cuda
@pytest.mark.parametrize("streaming", [False, True])
def test_unet_under_grad_on_card(streaming):
    """The UNet (head dim 64, as K2 takes it) under grad on the card:
    K2 launches once forward and once backward per attention call, K1
    never; the loss over valid frames and every parameter's gradient
    within 1e-4 of the leaf's largest element of the CPU's (TF32 off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from minimax_speech_torch.kernels import flash_attention as fa
    from minimax_speech_torch.kernels import splash

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(t_unet.DecoderUNetConfig(), channels=(128,),
                              num_heads=2, n_blocks=1, num_mid_blocks=2)
    net = t_io.init_params(t_unet.CausalConditionalDecoder(cfg),
                           torch.Generator().manual_seed(0))
    rng = np.random.default_rng(9)
    t = 120
    x, mu, cond = (torch.as_tensor(rng.standard_normal((2, t, 80)),
                                   dtype=torch.float32) for _ in range(3))
    mask = (torch.arange(t)[None] < torch.tensor([[t], [77]])).float()
    args = (x, mask, mu, torch.tensor([0.2, 0.7]),
            torch.as_tensor(rng.standard_normal((2, 80)),
                            dtype=torch.float32), cond)
    out = {}
    for dev in ("cpu", "cuda"):
        net.to(dev)
        fa.launches = 0
        splash.launches.update(forward=0, backward=0)
        loss = (net(*(a.to(dev) for a in args), streaming=streaming)
                * mask.to(dev)[..., None]).square().sum()
        grads = torch.autograd.grad(loss, list(net.parameters()))
        out[dev] = (float(loss), [g.cpu() for g in grads])
    n = 2 * len(cfg.channels) + cfg.num_mid_blocks
    assert fa.launches == 0
    assert splash.launches == {"forward": n, "backward": n}
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    for g_dev, g_cpu in zip(out["cuda"][1], out["cpu"][1]):
        scale = float(g_cpu.abs().max())
        assert float((g_dev - g_cpu).abs().max()) <= 1e-4 * max(scale, 1e-30)
