"""Matcha and the legacy CosyVoice1 flow on the card: the kernels their
UNets launch and the CPU's numbers. This file imports no JAX, so that
`python -m pytest --noconftest -m cuda tests/test_torch_matcha_card.py`
runs on a machine that has the card and not the JAX package; without a
card it skips.

Reduced widths (head dim 64, as the kernels take it), TF32 off: the
synthesised mel within 1e-4 of its peak and the frame lengths exact,
card against CPU on the same z; losses within 1e-5 relative and each
held leaf's gradient within 1e-4 of its largest element, card against
CPU on the same draws. Held: every leaf of the legacy flow, its key
biases (0 but for rounding: softmax ignores a key bias) against the
model's largest; Matcha's decoder, whose attention runs through K2. The
Matcha text encoder's leaves sit behind ReLUs, where float32 rounding
flips a gate and the gradient jumps by up to ~1e-2 of a leaf's largest
(chip_smoke.py phase 43 prints it beside a nudge's move), so they are
not held.
"""
import dataclasses

import numpy as np
import pytest
import torch

from minimax_speech_torch.models import cfm
from minimax_speech_torch.models import legacy_flow as lf
from minimax_speech_torch.models import matcha as m
from minimax_speech_torch.models.decoder_unet import DecoderUNetConfig
from minimax_speech_torch.utils import params_io


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from minimax_speech_torch.kernels import flash_attention as fa
    from minimax_speech_torch.kernels import splash
    fa.launches = 0
    splash.launches.update(forward=0, backward=0)
    return fa, splash


def _matcha():
    cfg = m.MatchaConfig(hidden=64, n_layers=2, unet=DecoderUNetConfig(
        in_channels=160, out_channels=80, channels=(128,),
        attention_head_dim=64, n_blocks=1, num_mid_blocks=2, num_heads=2),
        n_timesteps=3)
    return params_io.init_params(m.MatchaTTS(cfg),
                                 torch.Generator().manual_seed(0))


def _grads_close(model, a, b, held=lambda n: True):
    """Each held leaf within 1e-4 of its largest element; a key bias
    within 1e-4 of the model's largest."""
    top = max(float(g.abs().max()) for g in b)
    for (n, _), g_dev, g_cpu in zip(model.named_parameters(), a, b):
        if not held(n):
            continue
        scale = top if n.endswith("_k.bias") else float(g_cpu.abs().max())
        assert float((g_dev.cpu() - g_cpu).abs().max()) \
            <= 1e-4 * max(scale, 1e-30), n


@pytest.mark.cuda
def test_matcha_synthesise_on_card():
    """K1 once per UNet block per Euler step (4 x 3), K2 never."""
    fa, splash = _card()
    model = _matcha()
    rng = np.random.default_rng(1)
    tokens = rng.integers(1, 178, (2, 20))
    lens = np.array([20, 13])
    z = rng.standard_normal((2, 200, 80)).astype(np.float32)
    out = {}
    for dev in ("cpu", "cuda"):
        model.to(dev)
        fa.launches = 0
        out[dev] = m.matcha_synthesise(model, tokens, lens, z=z,
                                       max_frames=200, device=dev)
    assert fa.launches == 4 * 3
    assert splash.launches == {"forward": 0, "backward": 0}
    (mel_c, len_c), (mel_g, len_g) = out["cpu"], out["cuda"]
    assert torch.equal(len_g.cpu(), len_c)
    for i, n in enumerate(len_c.tolist()):
        ref = mel_c[i, :n]
        assert float((mel_g[i, :n].cpu() - ref).abs().max()) \
            <= 1e-4 * float(ref.abs().max())


@pytest.mark.cuda
def test_matcha_losses_on_card():
    """The training losses under grad: K2 4 + 4, K1 never; card vs CPU,
    the decoder's leaves held."""
    fa, splash = _card()
    model = _matcha()
    rng = np.random.default_rng(2)
    batch = (torch.as_tensor(rng.integers(1, 178, (2, 16))),
             torch.tensor([16, 11]),
             torch.as_tensor(rng.standard_normal((2, 96, 80)),
                             dtype=torch.float32), torch.tensor([96, 70]))
    draws = cfm.make_draws(model.cfg.cfm, 2, 96, 80,
                           torch.Generator().manual_seed(3))
    out = {}
    for dev in ("cpu", "cuda"):
        model.to(dev)
        splash.launches.update(forward=0, backward=0)
        d = dataclasses.replace(draws, t=draws.t.to(dev),
                                cand=draws.cand.to(dev))
        losses = model(*(a.to(dev) for a in batch), d)
        grads = torch.autograd.grad(sum(losses), list(model.parameters()))
        out[dev] = ([float(x.detach()) for x in losses],
                    [g.cpu() for g in grads])
    assert splash.launches == {"forward": 4, "backward": 4}
    assert fa.launches == 0
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    _grads_close(model, out["cuda"][1], out["cpu"][1],
                 lambda n: n.startswith("decoder."))


def _legacy():
    cfg = lf.LegacyFlowConfig(
        encoder=lf.LegacyEncoderConfig(output_size=128, attention_heads=2,
                                       linear_units=256, num_blocks=1),
        unet=lf.LegacyUNetConfig(channels=(128, 128), n_blocks=1,
                                 num_mid_blocks=1, num_heads=2),
        n_timesteps=2)
    return params_io.init_params(lf.MaskedDiffWithXvec(cfg),
                                 torch.Generator().manual_seed(4))


@pytest.mark.cuda
def test_legacy_flow_on_card():
    """Inference: K1 once per block per step (5 x 2) on the CFG batch,
    the mel card vs CPU; the loss under grad: K2 5 + 5, the loss and
    every gradient card vs CPU."""
    fa, splash = _card()
    model = _legacy()
    rng = np.random.default_rng(5)
    inputs = (rng.integers(0, 4096, (1, 30)), [30],
              rng.integers(0, 4096, (1, 10)), [10],
              rng.standard_normal((1, 17, 80)).astype(np.float32),
              rng.standard_normal((1, 192)).astype(np.float32),
              rng.standard_normal((1, 200, 80)).astype(np.float32))
    batch = (torch.as_tensor(rng.integers(0, 4096, (2, 30))),
             torch.tensor([30, 21]),
             torch.as_tensor(rng.standard_normal((2, 51, 80)),
                             dtype=torch.float32), torch.tensor([51, 37]),
             torch.as_tensor(rng.standard_normal((2, 192)),
                             dtype=torch.float32))
    draws = lf.make_legacy_draws(model.cfg, 2, 51,
                                 torch.Generator().manual_seed(6))
    out = {}
    for dev in ("cpu", "cuda"):
        model.to(dev)
        fa.launches = 0
        splash.launches.update(forward=0, backward=0)
        mel = lf.legacy_flow_inference(model, *inputs, device=dev)
        d = dataclasses.replace(draws, use_cond=draws.use_cond.to(dev),
                                frac=draws.frac.to(dev),
                                cfm=dataclasses.replace(
                                    draws.cfm, **{
                                        f: getattr(draws.cfm, f).to(dev)
                                        for f in ("t", "cand", "keep",
                                                  "perm")}))
        loss = model(*(a.to(dev) for a in batch), d)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        out[dev] = (mel.cpu(), float(loss.detach()),
                    [g.cpu() for g in grads])
    assert fa.launches == 5 * 2
    assert splash.launches == {"forward": 5, "backward": 5}
    mel_c, mel_g = out["cpu"][0], out["cuda"][0]
    assert float((mel_g - mel_c).abs().max()) \
        <= 1e-4 * float(mel_c.abs().max())
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-5)
    _grads_close(model, out["cuda"][2], out["cpu"][2])
