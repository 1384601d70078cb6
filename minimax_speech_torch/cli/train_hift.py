"""HiFT vocoder GAN trainer:
`python -m minimax_speech_torch.cli.train_hift --train_folders DIR --model_dir exp/hift`
or `--train_data LIST`.

Port of minimax_speech_tpu/cli/train_hift.py: the HiFT generator
(config's hift section, random weights from seed 0) against the
CosyVoiceDiscriminator, each with AdamW (constant lr after a warm-up,
clip 1e3), the losses of train/gan_steps.make_hift_steps, and the loop,
checkpoints (ckpt_g, ckpt_d) and resume of train/gan_loop.py. Batches
come from
  * --train_folders: random crops of --duration s (an AudioFolder seeded
    with the restored step), their host log-mel and, with --with_pitch,
    YIN f0;
  * --train_data: a list of wavs with .txt and _fsq sidecars through the
    GAN chain of data/pipeline.py (opener without latents -> filter ->
    resample -> truncate -> compute_fbank -> [extract_pitch] -> shuffle
    -> static_batch -> padding_gan), epoch after epoch from the restored
    step.
Runs on --device (default cuda; raises without a GPU).
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

INIT_SEED = 0


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--train_folders", nargs="+", default=None,
                   help="raw wav folders (fixed-duration random crops)")
    p.add_argument("--train_data", type=str, default=None,
                   help="data list (one wav path per line, with .txt/_fsq "
                        "sidecars): truncate -> compute_fbank -> pitch -> "
                        "padding")
    p.add_argument("--model_dir", required=True)
    p.add_argument("--config", default="configs/default.yaml")
    p.add_argument("--override", action="append", default=[])
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--duration", type=float, default=1.02)
    p.add_argument("--num_iters", type=int, default=200000)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--warmup_steps", type=int, default=500)
    p.add_argument("--save_iters", type=int, default=2000)
    p.add_argument("--log_interval", type=int, default=10)
    p.add_argument("--with_pitch", action="store_true",
                   help="add the f0 L1 loss with YIN targets")
    p.add_argument("--prefetch", type=int, default=2,
                   help="batches prepared ahead in a background thread")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if not args.train_folders and not args.train_data:
        p.error("one of --train_folders / --train_data is required")
    return args


def folder_batches(args, sr: int, hop: int, n: int, seed: int):
    """Random crops of n samples, their (T, 80) host mel and YIN pitch."""
    from minimax_speech_torch.data.audio_folder import AudioFolder
    from minimax_speech_torch.ops import mel as mel_ops
    from minimax_speech_torch.ops.pitch import yin_f0

    t_mel = n // hop
    ds = AudioFolder(args.train_folders, duration=args.duration,
                     sample_rate=sr, seed=seed)
    for audio in ds.infinite_batches(args.batch_size):
        audio = audio[:, :n]
        mel = mel_ops.hifigan_log_mel_np(audio).transpose(0, 2, 1)
        batch = {"speech_feat": mel[:, :t_mel].astype(np.float32),
                 "audio": audio}
        if args.with_pitch:
            pitch = np.stack([yin_f0(a, sr, hop)[:t_mel] for a in audio])
            batch["pitch"] = np.pad(pitch,
                                    ((0, 0), (0, t_mel - pitch.shape[1])))
        yield batch


def list_batches(args, sr: int, hop: int, n: int, epoch: int):
    """The GAN chain over --train_data, epoch after epoch."""
    from minimax_speech_torch.data import pipeline as dp

    items = [{"src": line.strip()} for line in
             Path(args.train_data).read_text().splitlines() if line.strip()]
    source = dp.DataList(items)
    stages = [lambda it: dp.individual_file_opener(it, require_latent=False),
              dp.filter_lengths,
              lambda it: dp.resample(it, sr),
              lambda it: dp.truncate(it, n),
              dp.compute_fbank]
    if args.with_pitch:
        stages.append(lambda it: dp.extract_pitch(it, sr, hop))
    stages += [lambda it: dp.shuffle(it, 1000),
               lambda it: dp.static_batch(it, args.batch_size,
                                          drop_last=True),
               lambda it: dp.padding_gan(it, hop)]
    while True:
        source.set_epoch(epoch)
        yield from dp.build_dataset(source, stages)
        epoch += 1


def main(argv=None):
    args = parse_args(argv)
    import torch

    from minimax_speech_torch import config as cfg_lib
    from minimax_speech_torch.models import discriminators, hifigan
    from minimax_speech_torch.train import gan_steps, schedule, steps
    from minimax_speech_torch.train.gan_loop import GanRun
    from minimax_speech_torch.utils import params_io
    from minimax_speech_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = cfg_lib.load_tts_config(args.config, args.override).hift
    init = torch.Generator().manual_seed(INIT_SEED)
    gen = params_io.init_params(hifigan.HiFTGenerator(cfg), init).to(device)
    disc = params_io.init_params(discriminators.CosyVoiceDiscriminator(),
                                 init).to(device)
    sr, hop = cfg.sampling_rate, cfg.total_upsample
    n = int(args.duration * sr) // hop * hop

    def tx():
        return schedule.make_optimizer(lr=args.lr,
                                       warmup_steps=args.warmup_steps,
                                       scheduler="constantlr", grad_clip=1e3)

    run = GanRun(args.model_dir, steps.make_train_state(gen, tx()),
                 steps.make_train_state(disc, tx()))
    gen_step, disc_step = gan_steps.make_hift_steps(gen, disc, device=device)
    batches = (list_batches(args, sr, hop, n, run.start) if args.train_data
               else folder_batches(args, sr, hop, n, run.start))

    def draws(batch, generator):
        return gan_steps.make_hift_draws(cfg, *batch["speech_feat"].shape[:2],
                                         generator)

    run.train(batches, gen_step, disc_step, draws, device, "hift",
              args.num_iters, args.log_interval, args.save_iters,
              args.prefetch)
    print("hift training done")


if __name__ == "__main__":
    main()
