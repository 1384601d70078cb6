"""DAC-VAE codec GAN trainer:
`python -m minimax_speech_torch.cli.train_dac --train_folders DIR --model_dir exp/dac`.

Port of minimax_speech_tpu/cli/train_dac.py: the codec (config's dac
section, random weights from seed 0) against the DACDiscriminator, each
with AdamW (constant lr after a warm-up, weight decay 1e-3; clip
--grad_clip for the generator, 10 for the discriminator), the lambda
weights (--lambda_*) with the spectral delay and ramp, random crops of
--duration s from an AudioFolder seeded with the restored step, the
loop, checkpoints (ckpt_g, ckpt_d) and resume of train/gan_loop.py, a
decode of the first crop every --sample_freq iterations
(<model_dir>/sample_<step>.npy) and --export_npz (the generator's
weights in the JAX package's .npz format, which its DACVAE loads). Runs
on --device (default cuda; raises without a GPU).

The audiotools chain (utils/audio_transforms.build_transform: the
--preprocess, --augment at --augment_prob, and --postprocess transforms
by name) runs on each batch's crops on the device, its draws from a
generator seeded TRANSFORM_SEED + the iteration; the Identity-only chain
(the default) is skipped.
"""
from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path

import numpy as np

INIT_SEED = 0
TRANSFORM_SEED = 10_000_019  # the JAX CLI's key for iteration i: this + i


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--train_folders", nargs="+", required=True)
    p.add_argument("--model_dir", required=True)
    p.add_argument("--config", default="configs/default.yaml")
    p.add_argument("--override", action="append", default=[])
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--duration", type=float, default=0.38)
    p.add_argument("--num_iters", type=int, default=500000)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--warmup_steps", type=int, default=500)
    p.add_argument("--gan_start_step", type=int, default=0)
    p.add_argument("--save_iters", type=int, default=1000)
    p.add_argument("--sample_freq", type=int, default=2000)
    p.add_argument("--log_interval", type=int, default=10)
    p.add_argument("--preprocess", nargs="*", default=["Identity"])
    p.add_argument("--augment", nargs="*", default=["Identity"])
    p.add_argument("--postprocess", nargs="*", default=["Identity"])
    p.add_argument("--augment_prob", type=float, default=0.0)
    p.add_argument("--prefetch", type=int, default=2,
                   help="batches prepared ahead in a background thread")
    p.add_argument("--export_npz", type=str, default=None,
                   help="also write the generator's final weights as .npz")
    p.add_argument("--lambda_mel", type=float, default=None)
    p.add_argument("--lambda_waveform", type=float, default=None)
    p.add_argument("--lambda_stft", type=float, default=None)
    p.add_argument("--spectral_warmup_steps", type=int, default=0,
                   help="ramp the mel/stft weights 0 -> lambda over N "
                        "steps (train/gan_steps.spectral_ramp)")
    p.add_argument("--spectral_delay_steps", type=int, default=0,
                   help="hold the mel/stft weights at exactly 0 for N "
                        "steps before the ramp")
    p.add_argument("--grad_clip", type=float, default=1e3)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import torch

    from minimax_speech_torch import config as cfg_lib
    from minimax_speech_torch.data.audio_folder import AudioFolder
    from minimax_speech_torch.models import dac_vae, discriminators
    from minimax_speech_torch.train import gan_steps, schedule, steps
    from minimax_speech_torch.train.gan_loop import GanRun
    from minimax_speech_torch.utils import params_io
    from minimax_speech_torch.utils.audio_signal import AudioSignal
    from minimax_speech_torch.utils.audio_transforms import build_transform
    from minimax_speech_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = cfg_lib.load_tts_config(args.config, args.override).dac
    init = torch.Generator().manual_seed(INIT_SEED)
    gen = params_io.init_params(dac_vae.DACVAE(cfg), init).to(device)
    disc = params_io.init_params(discriminators.DACDiscriminator(),
                                 init).to(device)
    n = int(args.duration * cfg.sample_rate) // cfg.hop_length \
        * cfg.hop_length

    def tx(clip):
        return schedule.make_optimizer(
            lr=args.lr, warmup_steps=args.warmup_steps,
            scheduler="constantlr", grad_clip=clip, weight_decay=1e-3)

    run = GanRun(args.model_dir, steps.make_train_state(gen, tx(
        args.grad_clip)), steps.make_train_state(disc, tx(10.0)))
    lam = dataclasses.replace(gan_steps.DACLambdas(), **{
        k: v for k, v in (("mel", args.lambda_mel),
                          ("waveform", args.lambda_waveform),
                          ("stft", args.lambda_stft)) if v is not None})
    gen_step, disc_step = gan_steps.make_dac_steps(
        gen, disc, lambdas=lam, sample_rate=cfg.sample_rate,
        gan_start_step=args.gan_start_step,
        spectral_warmup_steps=args.spectral_warmup_steps,
        spectral_delay_steps=args.spectral_delay_steps, device=device)
    ds = AudioFolder(args.train_folders, duration=args.duration,
                     sample_rate=cfg.sample_rate, seed=run.start)

    tfm = build_transform(augment_prob=args.augment_prob,
                          preprocess=args.preprocess, augment=args.augment,
                          postprocess=args.postprocess)
    identity_only = (args.preprocess == args.augment == args.postprocess
                     == ["Identity"])

    def batches():
        for i, audio in enumerate(ds.infinite_batches(args.batch_size)):
            audio = audio[:, :n]
            if not identity_only:
                gen = torch.Generator().manual_seed(
                    TRANSFORM_SEED + run.start + i)
                audio = tfm(gen, AudioSignal(audio[:, None, :],
                                             cfg.sample_rate, device=device)
                            ).audio_data[:, 0, :]
            yield {"audio": audio}

    def draws(batch, generator):
        return gan_steps.dac_eps(cfg, *batch["audio"].shape, generator)

    def dump_sample(step, batch):
        if step and step % args.sample_freq == 0:
            with torch.no_grad():
                mu = gen.encode(batch["audio"][:1, :, None])[1]
                rec = gen.decode(mu)
            np.save(Path(args.model_dir) / f"sample_{step}.npy",
                    rec[0, :, 0].cpu().numpy())

    run.train(batches(), gen_step, disc_step, draws, device, "dac",
              args.num_iters, args.log_interval, args.save_iters,
              args.prefetch, after_step=dump_sample)
    if args.export_npz:
        params_io.save_params(args.export_npz, gen)
        print(f"exported generator params to {args.export_npz}")
    print("dac training done")


if __name__ == "__main__":
    main()
