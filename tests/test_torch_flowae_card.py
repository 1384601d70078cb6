"""flowae on the card against the CPU. This file imports no JAX, so that
`python -m pytest --noconftest -m cuda tests/test_torch_flowae_card.py`
runs on a machine that has the card and not the JAX package; without a
card it skips.

Reduced widths, TF32 off, the same weights and draws on both sides:
the DiTo step's loss within 1e-5 relative and each leaf's gradient
within 1e-4 of its largest element or 1e-5 of the model's largest,
whichever is larger (a leaf whose gradient is 0 but for rounding, as a
key bias under softmax, or a sum over every frame with cancellation, as
drop_z_emb's and the z projection's bias: 1.3e-4 and 1.55e-4 of their
own largest with the UNet renderer on the H100), its Euler decode with
CFG within 1e-4 of the peak; the image prior's class-conditional generation within 1e-4 of
the peak; the VQGAN generator step's losses and adaptive weight within
1e-4 relative, the VQ indices equal. flowae launches neither
attention kernel (K1, K2): its attention is plain torch at head dims
the kernels do not take.
"""
import numpy as np
import pytest
import torch

from minimax_speech_torch.flowae import dit, dito, fm, image, trainer, vqgan
from minimax_speech_torch.flowae.consistency_unet import \
    ConsistencyUNetConfig
from minimax_speech_torch.train import schedule, steps
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


def _no_kernels(fa, splash):
    assert fa.launches == 0 and sum(splash.launches.values()) == 0


def _init(module, seed):
    return params_io.init_params(module, torch.Generator().manual_seed(seed))


def _close(a, b, rtol):
    a, b = a.detach().cpu().float(), b.detach().cpu().float()
    assert a.shape == b.shape
    err = float((a - b).abs().max())
    assert err <= rtol * float(b.abs().max()), err


def _grads_close(model, a, b):
    top = max(float(g.abs().max()) for g in b)
    for (name, _), g_dev, g_cpu in zip(params_io.named_flax_params(model),
                                       a, b):
        err = float((g_dev.cpu() - g_cpu).abs().max())
        limit = max(1e-4 * float(g_cpu.abs().max()), 1e-5 * top)
        assert err <= limit, (name, err, limit)


@pytest.mark.cuda
@pytest.mark.parametrize("renderer", ["dit", "unet"])
def test_dito_step_and_decode_card_vs_cpu(renderer):
    fa, splash = _card()
    cfg = dito.DiToConfig(
        z_dim=8, enc_channels=16, enc_strides=(4, 4), renderer_type=renderer,
        renderer=dit.DiTConfig(hidden=64, depth=2, num_heads=2, patch=16,
                               cond_dim=8),
        unet=ConsistencyUNetConfig(dims=1, c0=32, c1=64, c2=64, pe_dim=32,
                                   t_dim=128))
    n = 2048
    audio = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, n, 1)).astype(np.float32) * 0.3)
    draws = dito.make_dito_draws(cfg, audio.shape,
                                 torch.Generator().manual_seed(1), 0.5)
    noise = torch.randn((2, n, 1), generator=torch.Generator().manual_seed(2))
    runs = {}
    for dev in ("cpu", "cuda"):
        model = _init(dito.DiToAudio(cfg, n), 3).to(dev)
        state = steps.make_train_state(model, schedule.make_optimizer(
            lr=1e-3, warmup_steps=0))
        rec, kl, _ = model.loss(audio.to(dev), draws.to(dev), 0.5)
        grads = steps.gradients(state, rec + 1e-2 * kl)
        with torch.no_grad():
            _, mu, _ = model.encode(audio.to(dev))
        out = dito.dito_decode(model, mu, n, noise, n_steps=3, guidance=2.0)
        runs[dev] = (rec, kl, grads, out)
    (rc, kc, gc, oc), (rd, kd, gd, od) = runs["cpu"], runs["cuda"]
    _close(rd, rc, 1e-5)
    _close(kd, kc, 1e-5)
    _grads_close(model, gd, gc)
    _close(od, oc, 1e-4)
    _no_kernels(fa, splash)


@pytest.mark.cuda
def test_image_prior_generation_card_vs_cpu():
    fa, splash = _card()
    cfg = image.DiToImageConfig(
        z_dim=4, enc_channels=16, unet=ConsistencyUNetConfig(
            dims=2, c0=32, c1=64, c2=64, pe_dim=32, t_dim=128))
    zcfg = image.ImageZDMConfig(n_classes=3, guidance=2.0, net=dit.DiTConfig(
        hidden=64, depth=2, num_heads=2, patch=1, in_channels=4,
        out_channels=4, cond_dim=64))
    gen = torch.Generator().manual_seed(4)
    noise = (torch.randn((2, 4, 4, 4), generator=gen),
             torch.randn((2, 32, 32, 3), generator=gen))
    outs = []
    for dev in ("cpu", "cuda"):
        ae = _init(image.DiToImage(cfg, (32, 32)), 5).to(dev)
        zdm = _init(image.ImageZDMNet(zcfg, (4, 4)), 6).to(dev)
        outs.append(image.image_zdm_generate(
            zdm, ae, 2, (4, 4), (32, 32), noise, n_steps=3, render_steps=3,
            class_labels=np.array([0, 2])))
    _close(outs[1], outs[0], 1e-4)
    _no_kernels(fa, splash)


@pytest.mark.cuda
def test_vqgan_step_card_vs_cpu():
    fa, splash = _card()
    cfg = vqgan.VQGANConfig(ch=16, ch_mult=(1, 2), z_channels=8, n_embed=64,
                            embed_dim=8)
    x = torch.from_numpy(np.clip(np.random.default_rng(7).standard_normal(
        (2, 32, 32, 3)) * 0.5, -1, 1).astype(np.float32))
    runs = []
    for dev in ("cpu", "cuda"):
        model = _init(vqgan.VQGAN(cfg), 8).to(dev)
        disc = _init(vqgan.NLayerDiscriminator(16, 2), 9).to(dev)
        lpips = _init(vqgan.LPIPS(vqgan.VGGFeatures((16, 32), (1, 1))),
                      10).to(dev)
        with torch.no_grad():
            idx = model(x.to(dev))[2]
        gen, _ = vqgan.make_vqgan_steps(model, disc, lpips, device=dev)
        _, m = gen(steps.make_train_state(model, schedule.make_optimizer(
            lr=1e-4, warmup_steps=0)), {"image": x.to(dev)})
        runs.append((idx.cpu(), {k: float(v) for k, v in m.items()}))
    assert torch.equal(runs[0][0], runs[1][0])
    for k, v in runs[0][1].items():
        assert abs(runs[1][1][k] - v) <= 1e-4 * abs(v), k
    _no_kernels(fa, splash)


@pytest.mark.cuda
def test_ema_and_fm_draws_on_the_card():
    """The host generator gives the card the CPU's draws; the EMA update
    in place on the card equals the CPU's."""
    _card()
    cfg = fm.FMConfig()
    a = fm.make_fm_draws(cfg, (2, 8, 4), torch.Generator().manual_seed(0))
    b = a.to("cuda")
    assert torch.equal(a.noise, b.noise.cpu())
    p = [torch.randn(5, generator=torch.Generator().manual_seed(1))]
    e = [torch.zeros(5)]
    ed = [t.cuda() for t in e]
    trainer.ema_update(e, p, 0.9)
    trainer.ema_update(ed, [t.cuda() for t in p], 0.9)
    assert torch.allclose(ed[0].cpu(), e[0], rtol=0, atol=1e-7)
