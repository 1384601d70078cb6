"""flowae's image track in the port against the JAX package, on the CPU:
the consistency UNet in 1-D and 2-D (and its resizes), DiToImage with
the UNet and the DiT renderer, the class-conditional ImageZDM prior, the
VQGAN with LPIPS, the PatchGAN and the adaptive GAN weight, the image
folder and tar-shard readers and the PNG grid writer.

Tiny geometries; random weights in the JAX initialiser's shapes loaded
by both packages; the random draws are JAX's, fed to the port. JAX's
step gradients are read through test_torch_codec_train.capture, a
TrainState whose update keeps them. Tolerances as in
test_torch_flowae.py; the VQ indices, the reader arrays, the shard order
and the grid's pixels exactly equal.
"""
import functools
import io
import tarfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minimax_speech_torch.data import image_folder as t_if
from minimax_speech_torch.data import webdataset as t_wds
from minimax_speech_torch.flowae import consistency_unet as t_cu
from minimax_speech_torch.flowae import dit as t_dit
from minimax_speech_torch.flowae import fm as t_fm
from minimax_speech_torch.flowae import image as t_img
from minimax_speech_torch.flowae import vqgan as t_vq
from minimax_speech_torch.flowae.trainer import ema_init
from minimax_speech_torch.train import schedule as t_sched
from minimax_speech_torch.train import steps as t_steps
from minimax_speech_torch.utils import params_io as t_io
from minimax_speech_tpu.data import image_folder as j_if
from minimax_speech_tpu.data import webdataset as j_wds
from minimax_speech_tpu.flowae import consistency_unet as j_cu
from minimax_speech_tpu.flowae import dit as j_dit
from minimax_speech_tpu.flowae import fm as j_fm
from minimax_speech_tpu.flowae import image as j_img
from minimax_speech_tpu.flowae import vqgan as j_vq
from tests.test_torch_codec_train import capture
from tests.test_torch_flowae import (SEED, T, assert_grads_close,
                                     jax_dito_draws, jax_fm_draws,
                                     mixed_drop_key, np_, port_grads,
                                     rel_close)
from tests.test_torch_legacy import _peak_close, random_variables
from tests import torch_cpu

torch_cpu.share_cores()

UNET = dict(c0=16, c1=32, c2=32, pe_dim=16, t_dim=32, groups=8)
HW = (16, 16)


# --- the consistency UNet ----------------------------------------------------

@pytest.mark.parametrize("n_in,n_out", [(4, 64), (5, 64), (16, 32), (7, 13)])
def test_resize_matches_jax_image_resize(rng, n_in, n_out):
    """resize: linear in 1-D and nearest in 2-D with half-pixel centres,
    as jax.image.resize (the 2x ups and the z_dec resizes of any
    length), within 1e-6."""
    x = rng.standard_normal((2, 3, n_in)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x).transpose(0, 2, 1),
                           (2, n_out, 3), "linear").transpose(0, 2, 1)
    np.testing.assert_allclose(np_(t_cu.resize(T(x), [n_out], 1)), ref,
                               atol=1e-6, rtol=0)
    x = rng.standard_normal((2, 3, n_in, n_in + 1)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x).transpose(0, 2, 3, 1),
                           (2, n_out, n_out + 2, 3), "nearest")
    np.testing.assert_array_equal(
        np_(t_cu.resize(T(x), [n_out, n_out + 2], 2)),
        np.asarray(ref).transpose(0, 3, 1, 2))


@pytest.mark.parametrize("dims", [1, 2])
def test_consistency_unet_matches_jax(rng, dims):
    """The UNet with z_dec (projected after the stem in 1-D, concatenated
    before it in 2-D; GroupNorm groups 8, and 1 where a width does not
    divide), within 1e-4 of the peak; without t it runs at t = 0."""
    shp, zs = (((2, 64, 1), (2, 4, 3)) if dims == 1
               else ((2, 16, 8, 3), (2, 2, 1, 4)))
    kw = dict(UNET, c0=12) if dims == 2 else UNET  # 12 % 8: one group
    cfg = dict(dims=dims, in_channels=shp[-1], out_channels=shp[-1],
               z_dec_channels=zs[-1], **kw)
    jm = j_cu.ConsistencyUNet(j_cu.ConsistencyUNetConfig(**cfg))
    x = rng.standard_normal(shp).astype(np.float32)
    z = rng.standard_normal(zs).astype(np.float32)
    t = rng.uniform(size=2).astype(np.float32) * 1000
    v = random_variables(functools.partial(jm.init, jax.random.PRNGKey(0),
                                           x, t, z), seed=2)
    pm = t_io.load_flax_params(
        t_cu.ConsistencyUNet(t_cu.ConsistencyUNetConfig(**cfg)), v)
    run = jax.jit(jm.apply)  # one compile: t None is t = 0 on both sides
    with torch.no_grad():
        _peak_close(np_(pm(T(x), T(t), T(z))), run(v, x, t, z))
        _peak_close(np_(pm(T(x), None, T(z))), run(v, x, 0 * t, z))
    np.testing.assert_allclose(
        np_(t_cu.positional_time_embedding(T(t), 16)),
        j_cu.positional_time_embedding(jnp.asarray(t), 16), atol=1e-6,
        rtol=0)


# --- DiToImage ---------------------------------------------------------------

def image_cfgs(renderer):
    kw = dict(z_dim=4, enc_channels=8, enc_strides=(2, 2),
              renderer_type=renderer, render_n_steps=2)
    dit = dict(hidden=32, depth=2, num_heads=4, patch=4, in_channels=3,
               out_channels=3, cond_dim=4)
    return (j_img.DiToImageConfig(
                **kw, unet=j_cu.ConsistencyUNetConfig(dims=2, **UNET),
                renderer=j_dit.DiTConfig(**dit)),
            t_img.DiToImageConfig(
                **kw, unet=t_cu.ConsistencyUNetConfig(dims=2, **UNET),
                renderer=t_dit.DiTConfig(**dit)))


@functools.lru_cache(maxsize=None)
def _image_ae(renderer):
    jcfg, pcfg = image_cfgs(renderer)
    model = j_img.DiToImage(jcfg)
    v = random_variables(functools.partial(
        model.init, jax.random.PRNGKey(0), jnp.zeros((1,) + HW + (3,)),
        jax.random.PRNGKey(1), 0.1, method=j_img.DiToImage.loss), seed=11)
    return model, v, pcfg


def image_pair(renderer):
    model, v, pcfg = _image_ae(renderer)
    return model, v, t_io.load_flax_params(t_img.DiToImage(pcfg, HW), v)


def images(rng, b=2):
    return np.clip(rng.standard_normal((b,) + HW + (3,)) * 0.5, -1,
                   1).astype(np.float32)


@pytest.mark.parametrize("renderer", ["unet", "dit"])
def test_dito_image_matches_jax(rng, renderer):
    """DiToImage: the f8-style encoder (2-D kernels of 2s, flax's SAME)
    within 1e-5 of its peak; the loss with zaug within 1e-5 relative and
    every leaf's gradient on JAX's draws (the 2-D UNet's gradients, the
    1-D UNet's counterpart); with the DiT renderer the decode with
    renderer CFG within 1e-4 of the peak from JAX's start noise and the
    PSNR eval from the same noise (the Euler loop and CFG do not depend
    on the renderer; the UNet's JAX side would compile twice more)."""
    model, v, port = image_pair(renderer)
    x = images(rng, b=3)
    _, mu, _ = model.apply(v, x, method=j_img.DiToImage.encode)
    with torch.no_grad():
        _, pmu, _ = port.encode(T(x))
    _peak_close(np_(pmu), mu, 1e-5)
    key = mixed_drop_key(3, 0.5)

    def j_loss(params):
        rec, kl, _ = model.apply({"params": params}, x, key, 0.5,
                                 method=j_img.DiToImage.loss)
        return rec + 1e-2 * kl, (rec, kl)

    (_, (jrec, jkl)), jg = jax.jit(jax.value_and_grad(
        j_loss, has_aux=True))(v["params"])
    rec, kl, _ = port.loss(T(x), jax_dito_draws(key, x.shape, mu.shape,
                                                port.cfg, 0.5), 0.5)
    rel_close(rec.detach(), jrec)
    rel_close(kl.detach(), jkl)
    assert_grads_close(port, port_grads(port, rec + 1e-2 * kl), jg)
    if renderer == "unet":
        return
    dkey = jax.random.PRNGKey(SEED)
    noise = T(jax.random.normal(dkey, x.shape))
    ref = j_img.dito_image_decode(model, v, mu, HW, dkey, guidance=2.0)
    _peak_close(np_(t_img.dito_image_decode(port, pmu, HW, noise,
                                            guidance=2.0)), ref)
    jm = j_img.eval_image_reconstruction(model, v, jnp.asarray(x), dkey)
    pm = t_img.eval_image_reconstruction(port, T(x), noise)
    for k in jm:
        rel_close(pm[k], jm[k], 1e-4)


# --- ImageZDM ----------------------------------------------------------------

ZNET = dict(hidden=32, depth=2, num_heads=4, patch=1, in_channels=4,
            out_channels=4, cond_dim=16)


def test_image_zdm_step_and_generate_match_jax(rng):
    """The class-conditional prior over the frozen DiToImage: the step's
    loss, grad norm and every leaf's gradient with JAX's FM draws and
    label drops (to the null class); the CFG generation (prior then
    renderer) within 1e-4 of the peak from JAX's start noises."""
    ae, ae_v, ae_port = image_pair("dit")
    jcfg = j_img.ImageZDMConfig(z_dim=4, net=j_dit.DiTConfig(**ZNET),
                                n_steps=2, n_classes=3, class_emb_dim=16,
                                label_drop=0.5, guidance=2.0)
    pcfg = t_img.ImageZDMConfig(z_dim=4, net=t_dit.DiTConfig(**ZNET),
                                n_steps=2, n_classes=3, class_emb_dim=16,
                                label_drop=0.5, guidance=2.0)
    zdm = j_img.ImageZDMNet(jcfg)
    z_hw = (4, 4)
    v = random_variables(functools.partial(
        zdm.init, jax.random.PRNGKey(0), jnp.zeros((1,) + z_hw + (4,)),
        jnp.zeros((1,)), class_labels=jnp.zeros((1,), jnp.int32)), seed=12)
    port = t_io.load_flax_params(t_img.ImageZDMNet(pcfg, z_hw), v)
    x = images(rng, b=4)
    labels = np.array([0, 1, 2, 1], np.int32)
    batch = {"image": jnp.asarray(x), "label": jnp.asarray(labels)}
    key = jax.random.PRNGKey(SEED + 5)
    step = j_img.make_image_zdm_step(zdm, ae, ae_v)
    jstate, _, jm = jax.jit(step)(capture(v["params"]), v["params"], batch,
                                  key)
    k_enc, k_fm, k_drop = jax.random.split(key, 3)
    drop = T(jax.random.bernoulli(k_drop, 0.5, (4,)))
    assert drop.any() and not drop.all()
    draws = t_img.ImageZDMDraws(jax_fm_draws(k_fm, (4,) + z_hw + (4,),
                                             jcfg.fm), drop)
    captured = []
    orig = t_img.backward_and_update
    t_img.backward_and_update = lambda s, loss: captured.append(
        orig(s, loss)) or captured[-1]
    try:
        state = t_steps.make_train_state(
            port, t_sched.make_optimizer(lr=1e-3, warmup_steps=0))
        _, _, pm = t_img.make_image_zdm_step(port, ae_port, device="cpu")(
            state, ema_init(port), {"image": T(x), "label": T(labels)},
            draws)
    finally:
        t_img.backward_and_update = orig
    rel_close(pm["zdm/loss"], jm["zdm/loss"])
    rel_close(pm["zdm/grad_norm"], jm["zdm/grad_norm"], 1e-4)
    assert_grads_close(port, captured[0], jstate.params)

    port = t_io.load_flax_params(t_img.ImageZDMNet(pcfg, z_hw), v)
    cls = np.array([2, 0])
    ref = j_img.image_zdm_generate(zdm, v, ae, ae_v, 2, z_hw, HW, key,
                                   class_labels=cls)
    k_z, k_dec = jax.random.split(key)
    noise = (T(jax.random.normal(k_z, (2,) + z_hw + (4,))),
             T(jax.random.normal(k_dec, (2,) + HW + (3,))))
    _peak_close(np_(t_img.image_zdm_generate(port, ae_port, 2, z_hw, HW,
                                             noise, class_labels=cls)), ref)
    with pytest.raises(ValueError, match="class_labels"):
        t_img.image_zdm_generate(port, ae_port, 2, z_hw, HW, noise)


# --- VQGAN -------------------------------------------------------------------

VQ = dict(in_channels=3, ch=8, ch_mult=(1, 2), num_res_blocks=1,
          z_channels=8, n_embed=32, embed_dim=8)
VGG = dict(widths=(8, 16), convs_per_stage=(1, 1))


@functools.lru_cache(maxsize=None)
def _vqgan():
    model = j_vq.VQGAN(j_vq.VQGANConfig(**VQ))
    disc = j_vq.NLayerDiscriminator(ndf=8, n_layers=2)
    lpips = j_vq.LPIPS(j_vq.VGGFeatures(**VGG))
    x = jnp.zeros((1,) + HW + (3,))
    gv = random_variables(functools.partial(
        model.init, jax.random.PRNGKey(0), x), seed=13)
    dv = random_variables(functools.partial(
        disc.init, jax.random.PRNGKey(1), x), seed=14)
    pv = random_variables(functools.partial(
        lpips.init, jax.random.PRNGKey(2), x, x), seed=15)
    # the flax init's codebook, uniform(0, 2/n), which forward shifts
    gv["params"]["quantize"]["embedding"] = np.random.default_rng(
        3).uniform(0, 2.0 / 32, (32, 8)).astype(np.float32)
    return model, disc, lpips, gv, dv, pv


def vqgan_ports():
    model, disc, lpips, gv, dv, pv = _vqgan()
    return (t_io.load_flax_params(t_vq.VQGAN(t_vq.VQGANConfig(**VQ)), gv),
            t_io.load_flax_params(t_vq.NLayerDiscriminator(8, 2), dv),
            t_io.load_flax_params(t_vq.LPIPS(t_vq.VGGFeatures(**VGG)), pv))


def test_vqgan_lpips_and_patchgan_match_jax(rng):
    """The VQGAN's encode (the nearest codebook rows, the same indices),
    its codebook loss within 1e-5 relative and its reconstruction within
    1e-4 of the peak; lookup of the indices; LPIPS within 1e-5 relative
    (0 for equal inputs) and the PatchGAN's logits within 1e-4 of the
    peak."""
    model, disc, lpips, gv, dv, pv = _vqgan()
    port, pdisc, plpips = vqgan_ports()
    x = images(rng)
    y = images(rng)
    rec, q_loss, idx = model.apply(gv, x)
    with torch.no_grad():
        prec, pq, pidx = port(T(x))
        np.testing.assert_array_equal(np_(pidx), np.asarray(idx))
        rel_close(pq, q_loss)
        _peak_close(np_(prec), rec)
        ref = model.apply(gv, idx, method=lambda m, i: m.quantize.lookup(i))
        _peak_close(np_(port.quantize.lookup(T(np.asarray(idx)).long())),
                    ref, 1e-6)
        rel_close(plpips(T(x), T(y)), lpips.apply(pv, x, y))
        assert abs(float(plpips(T(x), T(x)))) < 1e-6
        _peak_close(np_(pdisc(T(x))), disc.apply(dv, x))


def test_vqgan_steps_match_jax(rng):
    """make_vqgan_steps with LPIPS: the generator step's losses within
    1e-5 relative, the adaptive weight (the gradient norms at
    decoder.conv_out) within 1e-4, every leaf's gradient (the codebook's
    through the straight-through estimator); the hinge discriminator
    step's loss, logit means and gradients."""
    model, disc, lpips, gv, dv, pv = _vqgan()
    port, pdisc, plpips = vqgan_ports()
    x = images(rng, b=2)
    jgen, jdisc = j_vq.make_vqgan_steps(model, disc, perceptual=lpips,
                                        perceptual_vars=pv)
    batch = {"image": jnp.asarray(x)}
    jg_state, jgm = jax.jit(jgen)(capture(gv["params"]), dv["params"],
                                  batch)
    jd_state, jdm = jax.jit(jdisc)(capture(dv["params"]), gv["params"],
                                   batch)
    captured = []
    orig = t_vq.backward_and_update
    t_vq.backward_and_update = lambda s, loss: captured.append(
        orig(s, loss)) or captured[-1]
    try:
        opt = t_sched.make_optimizer(lr=1e-4, warmup_steps=0)
        pgen, pdisc_step = t_vq.make_vqgan_steps(port, pdisc, plpips,
                                                 device="cpu")
        _, pdm = pdisc_step(t_steps.make_train_state(pdisc, opt),
                            {"image": T(x)})
        pdisc_fresh = t_io.load_flax_params(t_vq.NLayerDiscriminator(8, 2),
                                            dv)
        pgen = t_vq.make_vqgan_steps(port, pdisc_fresh, plpips,
                                     device="cpu")[0]
        _, pgm = pgen(t_steps.make_train_state(port, opt), {"image": T(x)})
    finally:
        t_vq.backward_and_update = orig
    for k in ("vq/loss", "vq/rec", "vq/quant", "vq/g_loss"):
        rel_close(pgm[k], jgm[k])
    rel_close(pgm["vq/adaptive_w"], jgm["vq/adaptive_w"], 1e-4)
    for k in jdm:
        rel_close(pdm[k], jdm[k])
    assert_grads_close(pdisc, captured[0], jd_state.params, min_checked=4)
    assert_grads_close(port, captured[1], jg_state.params)


# --- readers and the grid writer ---------------------------------------------

def write_images(root, rng, n=6):
    """PNGs and JPEGs of odd sizes in two class folders."""
    from PIL import Image
    paths = []
    for i in range(n):
        d = root / ("cat" if i % 2 else "dog")
        d.mkdir(parents=True, exist_ok=True)
        arr = rng.integers(0, 256, (20 + 3 * i, 30 - 2 * i, 3), np.uint8)
        p = d / f"im{i}.{'png' if i % 3 else 'jpg'}"
        Image.fromarray(arr).save(p)
        paths.append(p)
    return paths


def test_image_folders_match_jax(rng, tmp_path):
    """load_image, ImageFolder and ClassImageFolder (order, labels, the
    seeded batches) and synthetic_images: arrays exactly equal; an
    unreadable file is skipped in a batch."""
    paths = write_images(tmp_path, rng)
    for p in paths:
        for size in (None, 16):
            np.testing.assert_array_equal(t_if.load_image(str(p), size),
                                          j_if.load_image(str(p), size))
    (tmp_path / "dog" / "bad.png").write_bytes(b"not an image")
    for cls in ("ImageFolder", "ClassImageFolder"):
        a = getattr(t_if, cls)(str(tmp_path), size=12)
        b = getattr(j_if, cls)(str(tmp_path), size=12)
        assert a.paths == b.paths and len(a) == 7
        if cls == "ClassImageFolder":
            np.testing.assert_array_equal(a.labels, b.labels)
            assert a.n_classes == b.n_classes == 2
            ga = a.batches_with_labels(4, np.random.default_rng(1), 3)
            gb = b.batches_with_labels(4, np.random.default_rng(1), 3)
        else:
            ga = a.batches(4, np.random.default_rng(1), 3)
            gb = b.batches(4, np.random.default_rng(1), 3)
        for xa, xb in zip(ga, gb):
            for u, w in zip(xa if isinstance(xa, tuple) else (xa,),
                            xb if isinstance(xb, tuple) else (xb,)):
                np.testing.assert_array_equal(u, w)
    np.testing.assert_array_equal(t_if.synthetic_images(5, 24, 3),
                                  j_if.synthetic_images(5, 24, 3))


def shard_samples(rng, n):
    from PIL import Image
    for i in range(n):
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, (10 + i, 12, 3),
                                     np.uint8)).save(buf, format="PNG")
        yield f"{i:06d}", {"png": buf.getvalue(),
                           "txt": f"caption {i}".encode(),
                           "cls": str(i % 3).encode()}


@pytest.mark.parametrize("rank,world", [(0, 1), (1, 2)])
def test_webdataset_order_and_samples_match_jax(rng, tmp_path, rank, world):
    """write_shards makes the same tars; WebDatasetShards gives the same
    samples in the same order (per-epoch shard permutation, rank::world
    split, shuffle buffer), images exactly equal, over two epochs; a
    corrupt member is skipped and the epoch goes on."""
    samples = list(shard_samples(rng, 23))
    tp, jp = tmp_path / "t", tmp_path / "j"
    t_paths = t_wds.write_shards(iter(samples), str(tp), 4)
    j_paths = j_wds.write_shards(iter(samples), str(jp), 4)
    assert [p.name for p in t_paths] == [p.name for p in j_paths]
    with tarfile.open(t_paths[2], "a") as tf:  # a corrupt image member
        info = tarfile.TarInfo("999999.png")
        info.size = 5
        tf.addfile(info, io.BytesIO(b"bogus"))
    for epoch in (0, 1):
        a = list(t_wds.WebDatasetShards(str(tp), size=8, shuffle_buffer=5,
                                        seed=4, rank=rank,
                                        world=world).samples(epoch))
        b = list(j_wds.WebDatasetShards(str(tp), size=8, shuffle_buffer=5,
                                        seed=4, rank=rank,
                                        world=world).samples(epoch))
        assert [s["key"] for s in a] == [s["key"] for s in b]
        assert len(a) > 5 and "999999" not in [s["key"] for s in a]
        for sa, sb in zip(a, b):
            np.testing.assert_array_equal(sa["image"], sb["image"])
            assert (sa["caption"], sa["label"]) == (sb["caption"],
                                                     sb["label"])
    batch = next(t_wds.WebDatasetShards(str(tp), size=8).batches(3))
    assert batch["image"].shape == (3, 8, 8, 3) and len(batch["label"]) == 3


@pytest.mark.parametrize("channels,cols", [(3, 4), (1, 2)])
def test_save_image_grid_pixels_match_jax(rng, tmp_path, channels, cols):
    """The port's zlib PNG decodes (PIL) to the pixels of the JAX
    package's PIL-written grid, exactly."""
    from PIL import Image
    imgs = np.clip(rng.standard_normal((5, 6, 7, channels)), -1,
                   1).astype(np.float32)
    t_img.save_image_grid(imgs, str(tmp_path / "t.png"), cols)
    j_img.save_image_grid(imgs, str(tmp_path / "j.png"), cols)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "t.png")),
                                  np.asarray(Image.open(tmp_path / "j.png")))


def test_fm_draws_shapes():
    """make_fm_draws: t in [t_min, 1), k candidates with immiscible
    noise; reproducible from the generator's seed."""
    cfg = t_fm.FMConfig(k_candidates=3)
    a = t_fm.make_fm_draws(cfg, (2, 5, 4), torch.Generator().manual_seed(0),
                           t_min=0.5)
    b = t_fm.make_fm_draws(cfg, (2, 5, 4), torch.Generator().manual_seed(0),
                           t_min=0.5)
    assert a.noise.shape == (2, 3, 5, 4) and (a.t >= 0.5).all()
    assert torch.equal(a.noise, b.noise) and torch.equal(a.t, b.t)
    plain = t_fm.make_fm_draws(t_fm.FMConfig(use_immiscible=False),
                               (2, 5, 4), torch.Generator().manual_seed(0))
    assert plain.noise.shape == (2, 5, 4)
    assert j_fm.FMConfig().k_candidates == t_fm.FMConfig().k_candidates



def _pairs():
    """(name, JAX variables, a port module of the same shapes) of the
    flowae modules whose weights a .npz carries."""
    from minimax_speech_torch.flowae import dito as t_dito
    from minimax_speech_torch.flowae import zdm as t_zdm
    from tests.test_torch_flowae import ZNET, _dito, _zdm
    out = []
    for r in ("dit", "unet"):
        _, v, pcfg = _dito(r)
        out.append((f"DiToAudio {r}", v, t_dito.DiToAudio(pcfg, 64)))
    out.append(("ZDMNet", _zdm()[1], t_zdm.ZDMNet(t_zdm.ZDMConfig(
        z_dim=4, net=t_dit.DiTConfig(**ZNET)), 16)))
    for r in ("unet", "dit"):
        _, v, pcfg = _image_ae(r)
        out.append((f"DiToImage {r}", v, t_img.DiToImage(pcfg, HW)))
    _, _, _, gv, dv, pv = _vqgan()
    out += [("VQGAN", gv, t_vq.VQGAN(t_vq.VQGANConfig(**VQ))),
            ("NLayerDiscriminator", dv, t_vq.NLayerDiscriminator(8, 2)),
            ("LPIPS", pv, t_vq.LPIPS(t_vq.VGGFeatures(**VGG)))]
    return out


def test_npz_files_cross_both_ways(tmp_path):
    """A .npz the JAX package writes loads into the port's module, which
    writes a .npz the JAX package reads back leaf for leaf, exactly."""
    from minimax_speech_tpu.utils import params_io as j_io
    for name, v, port in _pairs():
        j_io.save_params(str(tmp_path / "j.npz"), v)
        t_io.load_flax_params(port, t_io.load_params(str(tmp_path /
                                                         "j.npz")))
        t_io.save_params(str(tmp_path / "p.npz"), port)
        back = t_io._flatten(j_io.load_params(str(tmp_path / "p.npz")))
        ref = t_io._flatten(v)
        assert back.keys() == ref.keys(), name
        for k, a in ref.items():
            np.testing.assert_array_equal(back[k], np.asarray(a),
                                          err_msg=f"{name} {k}")
