"""DiTo audio autoencoder inference CLI.

Port of minimax_speech_tpu/cli/dito_infer.py: encode a wav to latents,
decode them back to audio by FM Euler sampling, report the
reconstruction's MSE and SNR.

  python -m minimax_speech_torch.cli.dito_infer --wav in.wav \\
      --out rec.wav [--ckpt ae_params.npz | --random_init] \\
      [--n_steps 18] [--guidance 1.0] [--latents_out z.npy] [--device cpu]

The model is DiToConfig(); --ckpt takes an ae_params.npz of either
package (cli/train_flowae.py with that geometry), its DiT renderer sized
by the file. The input is cut to a multiple of 64 x 16 samples. The
Euler start noise comes from a host torch.Generator seeded with --seed
(the same numbers on every device); the reported metrics decode again
from the same noise, as the JAX package does. Runs on --device (default
cuda; raises without a GPU).
"""
from __future__ import annotations

import argparse

import numpy as np


def start_noises(shapes, seed: int) -> list:
    """The standard normal start noise of each decode, on the host."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=gen) for s in shapes]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--wav", required=True)
    p.add_argument("--out", default="dito_rec.wav")
    p.add_argument("--latents_out", default=None)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--random_init", action="store_true")
    p.add_argument("--n_steps", type=int, default=None)
    p.add_argument("--guidance", type=float, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    import torch

    from minimax_speech_torch.cli.synthesize import write_wav
    from minimax_speech_torch.data.pipeline import _load_audio
    from minimax_speech_torch.flowae.dito import (DiToAudio, DiToConfig,
                                                  dito_decode,
                                                  dito_from_tree)
    from minimax_speech_torch.flowae.trainer import eval_reconstruction
    from minimax_speech_torch.utils.device import resolve_device
    from minimax_speech_torch.utils.params_io import (init_params,
                                                      load_params)

    device = resolve_device(args.device)
    cfg = DiToConfig()
    audio, sr = _load_audio(args.wav)
    down = int(np.prod(cfg.enc_strides)) * cfg.renderer.patch
    n = (len(audio) // down) * down
    if args.ckpt:
        model = dito_from_tree(cfg, load_params(args.ckpt))
    elif args.random_init:
        model = init_params(DiToAudio(cfg, n),
                            torch.Generator().manual_seed(0))
    else:
        raise SystemExit("need --ckpt or --random_init")
    model.to(device)
    x = torch.as_tensor(audio[:n], device=device)[None, :, None]

    with torch.no_grad():
        _, mu, _ = model.encode(x)
    noise, = start_noises([(1, n, 1)], args.seed)
    rec = dito_decode(model, mu, n, noise, n_steps=args.n_steps,
                      guidance=args.guidance)
    metrics = eval_reconstruction(model, x, noise, n_steps=args.n_steps)
    write_wav(args.out, rec[0, :, 0].cpu().numpy(), sr)
    if args.latents_out:
        np.save(args.latents_out, mu[0].cpu().numpy())
    print(f"encoded {n / sr:.2f}s -> z {tuple(mu.shape)}; wrote {args.out} "
          f"(mse={float(metrics['eval/mse']):.5f}, "
          f"snr={float(metrics['eval/snr_db']):.1f}dB)")
    return {k: float(v) for k, v in metrics.items()}


if __name__ == "__main__":
    main()
