"""Image DiTo inference: reconstruct images or sample from the prior.

Port of minimax_speech_tpu/cli/image_dito.py: encode -> render over a
trained image DiTo, with side-by-side comparison output, or generation
from a trained image ZDM prior.

  python -m minimax_speech_torch.cli.image_dito --ae_params ae.npz \\
      --input img.png --output out.png --compare [--device cpu]
  python -m minimax_speech_torch.cli.image_dito --ae_params ae.npz \\
      --zdm_params zdm.npz --sample 8 --output samples.png

The .npz files are either package's (cli/train_flowae_image.py with the
same geometry flags). Reading --input needs PIL; --sample does not. The
start noises come from a host torch.Generator seeded with --seed (the
same numbers on every device). Runs on --device (default cuda; raises
without a GPU).
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from minimax_speech_torch.cli.dito_infer import start_noises
from minimax_speech_torch.cli.train_flowae_image import (add_geometry_args,
                                                         image_configs)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ae_params", required=True)
    p.add_argument("--input", default=None,
                   help="image file or folder to reconstruct")
    p.add_argument("--output", required=True)
    p.add_argument("--compare", action="store_true",
                   help="write [original | reconstruction] side by side")
    p.add_argument("--max_images", type=int, default=None)
    p.add_argument("--sample", type=int, default=0,
                   help="generate N images from the ZDM prior")
    p.add_argument("--zdm_params", default=None)
    p.add_argument("--n_steps", type=int, default=None)
    p.add_argument("--n_classes", type=int, default=0,
                   help=">0: the ZDM prior is class-conditional; sample "
                        "labels cycle 0..n_classes-1 (or --class_label)")
    p.add_argument("--class_label", type=int, default=None)
    add_geometry_args(p)
    args = p.parse_args(argv)

    import torch

    from minimax_speech_torch.flowae import image as img_lib
    from minimax_speech_torch.utils.device import resolve_device
    from minimax_speech_torch.utils.params_io import (load_flax_params,
                                                      load_params)

    device = resolve_device(args.device)
    cfg, zcfg = image_configs(args, args.n_classes)
    hw = (args.image_size,) * 2
    ae = load_flax_params(img_lib.DiToImage(cfg, hw),
                          load_params(args.ae_params)).to(device)

    if args.sample:
        if not args.zdm_params:
            raise SystemExit("--sample requires --zdm_params")
        z_stride = int(np.prod(cfg.enc_strides))
        z_hw = (args.image_size // z_stride,) * 2
        zdm = load_flax_params(img_lib.ImageZDMNet(zcfg, z_hw),
                               load_params(args.zdm_params)).to(device)
        cls = None
        if args.n_classes:
            cls = (np.full((args.sample,), args.class_label)
                   if args.class_label is not None
                   else np.arange(args.sample) % args.n_classes)
        noise = start_noises([(args.sample,) + z_hw + (args.z_dim,),
                              (args.sample,) + hw + (3,)], args.seed)
        gen = img_lib.image_zdm_generate(
            zdm, ae, args.sample, z_hw, hw, noise,
            render_steps=args.n_steps, class_labels=cls)
        img_lib.save_image_grid(gen.cpu().numpy(), args.output)
        print(f"wrote {args.sample} samples to {args.output}")
        return gen

    from minimax_speech_torch.data.image_folder import (IMAGE_EXTS,
                                                        ImageFolder,
                                                        load_image)
    if not args.input:
        raise SystemExit("need --input (or --sample)")
    inp = Path(args.input)
    if inp.is_dir():
        ds = ImageFolder(str(inp), size=args.image_size,
                         max_images=args.max_images)
        imgs = np.stack([ds[i] for i in range(len(ds))])
    else:
        if inp.suffix.lower() not in IMAGE_EXTS:
            raise SystemExit(f"unsupported image type {inp.suffix}")
        imgs = load_image(str(inp), args.image_size)[None]

    with torch.no_grad():
        _, mu, _ = ae.encode(torch.as_tensor(imgs, device=device))
    noise, = start_noises([imgs.shape], args.seed)
    rec = img_lib.dito_image_decode(ae, mu, hw, noise,
                                    n_steps=args.n_steps).cpu().numpy()
    mse = float(np.mean((rec - imgs) ** 2))
    psnr = -10 * np.log10(max(np.mean(((rec - imgs) / 2) ** 2), 1e-12))
    if args.compare:
        side = np.concatenate([imgs, rec], axis=2)  # horizontal pairs
        img_lib.save_image_grid(side, args.output, cols=1)
    else:
        img_lib.save_image_grid(rec, args.output)
    print(f"reconstructed {len(imgs)} image(s) -> {args.output} "
          f"(mse={mse:.5f}, psnr={psnr:.2f} dB)")
    return rec


if __name__ == "__main__":
    main()
