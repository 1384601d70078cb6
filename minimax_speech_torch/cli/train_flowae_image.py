"""flowae image experiment runner: train an image DiTo or its latent
prior.

Port of minimax_speech_tpu/cli/train_flowae_image.py:

  python -m minimax_speech_torch.cli.train_flowae_image --model dito \\
      --image_dir data/imgs --save_dir exp/dito_img --steps 2000 \\
      [--device cpu]
  python -m minimax_speech_torch.cli.train_flowae_image --model zdm \\
      --ae_params exp/dito_img/ae_params.npz --save_dir exp/zdm_img \\
      [--class_cond]

Data: an image folder (class subdirectories with --class_cond), tar
shards (--tar_shards, data/webdataset.py; .cls members label them) or
synthetic images (--synthetic, or neither; labels cycle over the
classes), the same arrays as the JAX package's. Each step's draws come
from a host torch.Generator seeded with --seed, the batches from numpy's
generator as in the JAX package. Writes config.json, metrics, PNG grids
of reconstructions (dito) or samples (zdm, with CFG at --guidance when
class-conditional), checkpoints under ckpt/ and ae_params.npz or the
EMA's zdm_params.npz in the JAX package's format. Runs on --device
(default cuda; raises without a GPU).
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def build_dataset(args) -> tuple:
    """-> (images (N, H, W, 3) in [-1, 1], labels (N,) int32 or None,
    n_classes)."""
    from minimax_speech_torch.data.image_folder import (ClassImageFolder,
                                                        ImageFolder,
                                                        synthetic_images)

    def synth():
        imgs = synthetic_images(args.max_images, args.image_size,
                                args.seed)
        if not args.class_cond:
            return imgs, None, 0
        # smoke-run labels: cyclic (the classes' meaning does not matter
        # to the conditioning's plumbing)
        n = max(args.n_classes, 2)
        return imgs, np.arange(len(imgs), dtype=np.int32) % n, n

    if args.synthetic:
        return synth()
    if args.tar_shards:
        from minimax_speech_torch.data.webdataset import WebDatasetShards
        ds = WebDatasetShards(args.tar_shards, size=args.image_size,
                              seed=args.seed,
                              required=("image", "label")
                              if args.class_cond else ("image",))
        imgs, labs = [], []
        for s in ds.samples(epoch=0):
            imgs.append(s["image"])
            if args.class_cond:
                labs.append(int(s["label"]))
            if len(imgs) >= args.max_images:
                break
        return (np.stack(imgs),
                np.asarray(labs, np.int32) if args.class_cond else None,
                (max(labs) + 1) if labs else 0)
    if args.image_dir:
        if args.class_cond:
            ds = ClassImageFolder(args.image_dir, size=args.image_size,
                                  max_images=args.max_images)
            imgs = np.stack([ds[i] for i in range(len(ds))])
            return imgs, ds.labels, ds.n_classes
        ds = ImageFolder(args.image_dir, size=args.image_size,
                         max_images=args.max_images)
        return np.stack([ds[i] for i in range(len(ds))]), None, 0
    return synth()


def image_configs(args, n_classes: int = 0):
    """(DiToImageConfig, ImageZDMConfig) of the CLI's geometry flags, as
    cli/image_dito.py reads them too."""
    from minimax_speech_torch.flowae import image as img_lib
    from minimax_speech_torch.flowae.consistency_unet import \
        ConsistencyUNetConfig
    from minimax_speech_torch.flowae.dit import DiTConfig

    strides = tuple(int(s) for s in args.enc_strides.split(","))
    ae_cfg = img_lib.DiToImageConfig(
        z_dim=args.z_dim, enc_channels=args.enc_channels,
        enc_strides=strides, renderer_type=args.renderer,
        unet=ConsistencyUNetConfig(dims=2, c0=args.c0, c1=2 * args.c0,
                                   c2=4 * args.c0, groups=8,
                                   pe_dim=64, t_dim=4 * args.c0),
        renderer=DiTConfig(hidden=args.hidden, depth=args.depth,
                           num_heads=args.heads, patch=args.patch,
                           in_channels=3, out_channels=3,
                           cond_dim=args.z_dim))
    zcfg = img_lib.ImageZDMConfig(
        z_dim=args.z_dim, n_classes=n_classes,
        label_drop=getattr(args, "label_drop", 0.1), guidance=args.guidance,
        net=DiTConfig(hidden=args.hidden, depth=args.depth,
                      num_heads=args.heads, patch=1,
                      in_channels=args.z_dim, out_channels=args.z_dim,
                      cond_dim=64 if n_classes else 0))
    return ae_cfg, zcfg


def add_geometry_args(p: argparse.ArgumentParser):
    p.add_argument("--image_size", type=int, default=32)
    p.add_argument("--z_dim", type=int, default=4)
    p.add_argument("--enc_channels", type=int, default=16)
    p.add_argument("--enc_strides", default="2,2,2")
    p.add_argument("--renderer", choices=("unet", "dit"), default="unet")
    p.add_argument("--c0", type=int, default=32)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--depth", type=int, default=3)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--patch", type=int, default=4)
    p.add_argument("--guidance", type=float, default=2.0,
                   help="CFG scale for class-conditional generation")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", choices=("dito", "zdm"), default="dito")
    p.add_argument("--save_dir", required=True)
    p.add_argument("--image_dir", default=None)
    p.add_argument("--tar_shards", default=None,
                   help="webdataset-layout .tar shards: a dir of *.tar "
                        "or a .json list (data/webdataset.py)")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--max_images", type=int, default=64)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--warmup", type=int, default=10)
    p.add_argument("--eval_every", type=int, default=100)
    p.add_argument("--save_every", type=int, default=100)
    p.add_argument("--eval_batches", type=int, default=1)
    p.add_argument("--eval_n_steps", type=int, default=None)
    p.add_argument("--kl_weight", type=float, default=1e-4)
    p.add_argument("--zaug_p", type=float, default=0.1)
    p.add_argument("--class_cond", action="store_true",
                   help="class-conditional ZDM prior (labels from class "
                        "subdirs / .cls shard members / cyclic synthetic)")
    p.add_argument("--n_classes", type=int, default=0,
                   help="override the inferred class count")
    p.add_argument("--label_drop", type=float, default=0.1)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--ae_params", default=None)
    p.add_argument("--resume", action="store_true")
    add_geometry_args(p)
    args = p.parse_args(argv)

    import torch

    from minimax_speech_torch.flowae import image as img_lib
    from minimax_speech_torch.flowae.dito import make_dito_draws
    from minimax_speech_torch.flowae.trainer import ema_init, with_params
    from minimax_speech_torch.train import schedule, steps
    from minimax_speech_torch.train.checkpoint import CheckpointManager
    from minimax_speech_torch.utils.device import resolve_device
    from minimax_speech_torch.utils.logging import MetricsLogger
    from minimax_speech_torch.utils.params_io import (init_params,
                                                      load_flax_params,
                                                      load_params,
                                                      save_params)

    device = resolve_device(args.device)
    save_dir = Path(args.save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    (save_dir / "config.json").write_text(json.dumps(vars(args), indent=1))

    data, labels, n_classes = build_dataset(args)
    if args.n_classes:
        n_classes = args.n_classes
    rng = np.random.default_rng(args.seed + 1)
    draws_gen = torch.Generator().manual_seed(args.seed)
    eval_gen = torch.Generator().manual_seed(args.seed + 3)

    strides = tuple(int(s) for s in args.enc_strides.split(","))
    z_stride = int(np.prod(strides))
    if args.image_size % z_stride:
        raise SystemExit(f"image_size must be divisible by the encoder "
                         f"stride product {z_stride}")
    if args.renderer == "unet" and args.image_size % 8:
        raise SystemExit("image_size must be divisible by 8 for the UNet "
                         "renderer (three 2x pools)")
    cls_n = n_classes if args.class_cond else 0
    ae_cfg, zcfg = image_configs(args, cls_n)
    hw = (args.image_size,) * 2
    z_hw = (args.image_size // z_stride,) * 2

    tx = schedule.make_optimizer(lr=args.lr, warmup_steps=args.warmup)
    logger = MetricsLogger(str(save_dir), name=args.model, log_interval=1)
    ckpt = CheckpointManager(str(save_dir / "ckpt"))

    def batches(n):
        for _ in range(n):
            idx = rng.integers(0, data.shape[0], args.batch)
            b = {"image": torch.as_tensor(data[idx], device=device)}
            if labels is not None:
                b["label"] = torch.as_tensor(labels[idx], device=device)
            yield b

    if args.model == "zdm":
        if not args.ae_params:
            raise SystemExit("--model zdm requires --ae_params")
        if args.class_cond and labels is None:
            raise SystemExit("--class_cond needs a labeled dataset")
        ae = load_flax_params(img_lib.DiToImage(ae_cfg, hw),
                              load_params(args.ae_params)).to(device)
        module = init_params(img_lib.ImageZDMNet(zcfg, z_hw),
                             torch.Generator().manual_seed(args.seed + 2))
        step_fn = img_lib.make_image_zdm_step(module.to(device), ae,
                                              device=device)

        def draws():
            return img_lib.make_image_zdm_draws(
                zcfg, (args.batch,) + z_hw + (args.z_dim,), draws_gen)
    else:
        module = ae = init_params(img_lib.DiToImage(ae_cfg, hw),
                                  torch.Generator().manual_seed(args.seed
                                                                + 2))
        step_fn = img_lib.make_dito_image_step(
            ae.to(device), kl_weight=args.kl_weight, zaug_p=args.zaug_p,
            bf16=args.bf16, device=device)

        def draws():
            return make_dito_draws(ae_cfg, (args.batch,) + hw + (3,),
                                   draws_gen, args.zaug_p)
    state = steps.make_train_state(module, tx)
    ema = ema_init(module)

    start = 0
    if args.resume:
        state, start = ckpt.restore(state)
        ema = ema_init(module)
        print(f"resumed at step {start}")

    def run_eval(step_i):
        if args.model == "zdm":
            cls = (np.arange(args.batch) % max(n_classes, 1)
                   if zcfg.n_classes else None)
            gen = img_lib.image_zdm_generate(
                with_params(module, ema), ae, args.batch, z_hw, hw,
                generator=eval_gen, render_steps=args.eval_n_steps,
                class_labels=cls)
            img_lib.save_image_grid(
                gen.cpu().numpy(), str(save_dir / f"samples_{step_i}.png"))
            m = {"zdm_eval/sample_mean": float(torch.mean(gen)),
                 "zdm_eval/sample_std": float(torch.std(gen,
                                                        unbiased=False))}
        else:
            imgs = next(iter(batches(1)))["image"]
            m = img_lib.eval_image_reconstruction(
                ae, imgs, generator=eval_gen, n_steps=args.eval_n_steps)
            m = {k: float(v) for k, v in m.items()}
            with torch.no_grad():
                _, mu, _ = ae.encode(imgs[:4])
            rec = img_lib.dito_image_decode(ae, mu, hw, generator=eval_gen,
                                            n_steps=args.eval_n_steps)
            grid = np.concatenate([imgs[:4].cpu().numpy(),
                                   rec.cpu().numpy()])
            img_lib.save_image_grid(grid,
                                    str(save_dir / f"recon_{step_i}.png"))
        logger.log(step_i, m, force=True)
        return m

    for i in range(start, args.steps):
        batch = next(iter(batches(1)))
        state, ema, metrics = step_fn(state, ema, batch, draws().to(device))
        logger.log(i, metrics)
        if args.eval_every and (i + 1) % args.eval_every == 0:
            run_eval(i + 1)
        if args.save_every and (i + 1) % args.save_every == 0:
            ckpt.save(i + 1, state)

    final = run_eval(args.steps)
    ckpt.save(args.steps, state)
    if args.model != "zdm":
        save_params(str(save_dir / "ae_params.npz"), ae)
    else:
        save_params(str(save_dir / "zdm_params.npz"),
                    with_params(module, ema))
    print(json.dumps({k: float(v) for k, v in final.items()}))
    return final


if __name__ == "__main__":
    main()
