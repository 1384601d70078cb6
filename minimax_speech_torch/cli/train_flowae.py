"""flowae experiment runner: train a DiTo autoencoder or its ZDM prior,
with the eval suites.

Port of minimax_speech_tpu/cli/train_flowae.py:

  python -m minimax_speech_torch.cli.train_flowae --model dito \\
      --wav_dir data/ --save_dir exp/dito --steps 10000 [--device cpu]
  python -m minimax_speech_torch.cli.train_flowae --model zdm \\
      --ae_params exp/dito/ae_params.npz --save_dir exp/zdm

Data: every .wav under --wav_dir (a random crop each, peak-normalised)
or deterministic sine clips (--synthetic, or no --wav_dir), the same
arrays as the JAX package's for the same seed. Each step's draws come
from a host torch.Generator seeded with --seed (the same numbers on
every device), the batches from numpy's generator as in the JAX
package. Writes config.json, <model>_metrics.jsonl, eval wavs under
cache/ and audio_samples/, checkpoints under ckpt/ (--resume restarts
from the newest) and, for dito, ae_params.npz in the JAX package's
format (the --ae_params of --model zdm, of either package). Runs on
--device (default cuda; raises without a GPU).
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def build_dataset(args) -> np.ndarray:
    """(N, crop_len, 1) float32 clips."""
    rng = np.random.default_rng(args.seed)
    t_len = args.crop_len
    if args.wav_dir:
        from minimax_speech_torch.data.pipeline import _load_audio
        clips = []
        for p in sorted(Path(args.wav_dir).rglob("*.wav")):
            try:
                audio, _ = _load_audio(str(p))
            except Exception as e:  # noqa: BLE001 - skip-and-log a bad file
                print(f"skip {p}: {e}")
                continue
            if len(audio) < t_len:
                audio = np.pad(audio, (0, t_len - len(audio)))
            start = rng.integers(0, len(audio) - t_len + 1)
            clip = audio[start:start + t_len]
            peak = np.abs(clip).max()
            clips.append(clip / peak if peak > 1e-6 else clip)
            if len(clips) >= args.max_clips:
                break
        if not clips:
            raise SystemExit(f"no wavs under {args.wav_dir}")
        return np.stack(clips).astype(np.float32)[..., None]
    # synthetic: sine mixtures at distinct f0s, amplitude-enveloped
    n = args.max_clips
    t = np.arange(t_len) / 24000.0
    clips = []
    for i in range(n):
        f0 = 80.0 * (1.3 ** (i % 12))
        env = 0.5 + 0.5 * np.sin(2 * np.pi * (1 + i % 3) * t)
        clips.append(0.4 * env * np.sin(2 * np.pi * f0 * t)
                     + 0.05 * rng.standard_normal(t_len))
    return np.stack(clips).astype(np.float32)[..., None]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", choices=("dito", "glpto", "zdm"),
                   default="dito")
    p.add_argument("--save_dir", required=True)
    p.add_argument("--wav_dir", default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--max_clips", type=int, default=64)
    p.add_argument("--crop_len", type=int, default=4096)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--warmup", type=int, default=10)
    p.add_argument("--eval_every", type=int, default=100)
    p.add_argument("--vis_every", type=int, default=0,
                   help="dump audio artifacts every N steps (0=only at end)")
    p.add_argument("--save_every", type=int, default=100)
    p.add_argument("--n_vis", type=int, default=2)
    p.add_argument("--eval_batches", type=int, default=2)
    p.add_argument("--eval_n_steps", type=int, default=None)
    p.add_argument("--z_dim", type=int, default=8)
    p.add_argument("--enc_channels", type=int, default=16)
    p.add_argument("--enc_strides", default="4,4")
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--depth", type=int, default=3)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--patch", type=int, default=16)
    p.add_argument("--kl_weight", type=float, default=1e-4)
    p.add_argument("--zaug_p", type=float, default=0.1)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--ae_params", default=None,
                   help="(zdm) npz of the frozen autoencoder params")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--sample_rate", type=int, default=24000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    import torch

    from minimax_speech_torch.flowae import evaluate as ev
    from minimax_speech_torch.flowae import fm as fm_lib
    from minimax_speech_torch.flowae import zdm as zdm_lib
    from minimax_speech_torch.flowae.dit import DiTConfig
    from minimax_speech_torch.flowae.dito import (DiToAudio, DiToConfig,
                                                  dito_from_tree,
                                                  make_dito_draws)
    from minimax_speech_torch.flowae.trainer import (ema_init,
                                                     make_dito_step,
                                                     with_params)
    from minimax_speech_torch.train import schedule, steps
    from minimax_speech_torch.train.checkpoint import CheckpointManager
    from minimax_speech_torch.utils.device import resolve_device
    from minimax_speech_torch.utils.logging import MetricsLogger
    from minimax_speech_torch.utils.params_io import (init_params,
                                                      load_params,
                                                      save_params)

    device = resolve_device(args.device)
    save_dir = Path(args.save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    (save_dir / "config.json").write_text(json.dumps(vars(args), indent=1))

    data = build_dataset(args)
    rng = np.random.default_rng(args.seed + 1)
    draws_gen = torch.Generator().manual_seed(args.seed)
    eval_gen = torch.Generator().manual_seed(args.seed + 3)

    strides = tuple(int(s) for s in args.enc_strides.split(","))
    ae_cfg = DiToConfig(
        z_dim=args.z_dim, enc_channels=args.enc_channels,
        enc_strides=strides,
        renderer=DiTConfig(hidden=args.hidden, depth=args.depth,
                           num_heads=args.heads, patch=args.patch,
                           in_channels=1, out_channels=1,
                           cond_dim=args.z_dim))
    z_stride = int(np.prod(strides))
    if args.crop_len % (z_stride * args.patch):
        raise SystemExit("crop_len must divide enc_strides*patch")

    tx = schedule.make_optimizer(lr=args.lr, warmup_steps=args.warmup)
    logger = MetricsLogger(str(save_dir), name=args.model, log_interval=1)
    ckpt = CheckpointManager(str(save_dir / "ckpt"))

    def batches(n):
        for _ in range(n):
            idx = rng.integers(0, data.shape[0], args.batch)
            yield data[idx]

    n_z = args.crop_len // z_stride
    if args.model == "zdm":
        if not args.ae_params:
            raise SystemExit("--model zdm requires --ae_params")
        ae = dito_from_tree(ae_cfg, load_params(args.ae_params)).to(device)
        zcfg = zdm_lib.ZDMConfig(
            z_dim=args.z_dim,
            net=DiTConfig(hidden=args.hidden, depth=args.depth,
                          num_heads=args.heads, patch=1,
                          in_channels=args.z_dim, out_channels=args.z_dim,
                          cond_dim=0))
        module = init_params(zdm_lib.ZDMNet(zcfg, n_z),
                             torch.Generator().manual_seed(args.seed + 2))
        step_fn = zdm_lib.make_zdm_step(module.to(device), ae, device=device)

        def draws():
            return fm_lib.make_fm_draws(zcfg.fm, (args.batch, n_z,
                                                  args.z_dim), draws_gen)
    else:
        if args.model == "glpto":
            raise SystemExit("glpto: use tests/test_flowae.py pattern; "
                             "runner supports dito/zdm tracks")
        module = ae = init_params(DiToAudio(ae_cfg, args.crop_len),
                                  torch.Generator().manual_seed(args.seed
                                                                + 2))
        step_fn = make_dito_step(ae.to(device), kl_weight=args.kl_weight,
                                 zaug_p=args.zaug_p, bf16=args.bf16,
                                 device=device)

        def draws():
            return make_dito_draws(ae_cfg, (args.batch, args.crop_len, 1),
                                   draws_gen, args.zaug_p)
    state = steps.make_train_state(module, tx)
    ema = ema_init(module)

    start = 0
    if args.resume:
        state, start = ckpt.restore(state)
        ema = ema_init(module)  # the EMA restarts from the restored params
        print(f"resumed at step {start}")

    def run_eval(step_i):
        if args.model == "zdm":
            m = ev.evaluate_audio_zdm(
                with_params(module, ema), ae, batches(args.eval_batches),
                eval_gen, save_dir=str(save_dir),
                sample_rate=args.sample_rate)
        else:
            m = ev.evaluate_audio_ae(
                ae, batches(args.eval_batches), eval_gen,
                n_steps=args.eval_n_steps, save_dir=str(save_dir),
                sample_rate=args.sample_rate)
        logger.log(step_i, m, force=True)
        return m

    def run_vis(step_i):
        if args.model == "zdm":
            ev.visualize_audio_zdm_random(
                with_params(module, ema), ae, args.crop_len, eval_gen,
                str(save_dir), step_i, n_samples=args.n_vis,
                sample_rate=args.sample_rate)
        else:
            ev.visualize_audio_ae_random(
                ae, data, eval_gen, str(save_dir), step_i,
                n_samples=args.n_vis, n_steps=args.eval_n_steps,
                sample_rate=args.sample_rate)

    for i in range(start, args.steps):
        batch = {"audio": torch.as_tensor(next(iter(batches(1))),
                                          device=device)}
        state, ema, metrics = step_fn(state, ema, batch,
                                      draws().to(device))
        logger.log(i, metrics)
        if args.eval_every and (i + 1) % args.eval_every == 0:
            run_eval(i + 1)
        if args.vis_every and (i + 1) % args.vis_every == 0:
            run_vis(i + 1)
        if args.save_every and (i + 1) % args.save_every == 0:
            ckpt.save(i + 1, state)

    final = run_eval(args.steps)
    run_vis(args.steps)
    ckpt.save(args.steps, state)
    if args.model != "zdm":
        save_params(str(save_dir / "ae_params.npz"), ae)
    print(json.dumps({k: float(v) for k, v in final.items()}))
    return final


if __name__ == "__main__":
    main()
