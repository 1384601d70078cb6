"""DAC latent extraction: `python -m minimax_speech_torch.cli.extract_dac_latents --dir DATA --ckpt codec.npz`.

Port of minimax_speech_tpu/cli/extract_dac_latents.py: every wav under
--dir (or in --file_list), this process's share, at the codec's sample
rate, padded to a hop multiple and encoded; {z, mu, logs} written as
<stem>_latent2x.npz (z = mu unless --sample draws it, from a generator
seeded with the file's index). A share --verify_fraction of the files
(drawn from `random`) is decoded from mu and its MSE and SNR printed.
Then the per-channel mean and std of mu over every sidecar of this
share (those already on disk with --skip_existing included) go to
--stats_out, default latent_stats.json beside --ckpt on process 0: the
file cli/train.py --model flow --latent_stats reads. Weights from
--ckpt or --random_init (seed 0), geometry from --config's model.dac
section or the default. A file that fails is logged and listed in
failed_latents_rank<i>.txt. Runs on --device (default cuda; raises
without a GPU).
"""
from __future__ import annotations

import argparse
import json
import random
import sys
import time
from pathlib import Path

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dir", type=str, default=None)
    p.add_argument("--file_list", type=str, default=None)
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--random_init", action="store_true")
    p.add_argument("--skip_existing", action="store_true")
    p.add_argument("--verify_fraction", type=float, default=0.02)
    p.add_argument("--process_index", type=int, default=0)
    p.add_argument("--process_count", type=int, default=1)
    p.add_argument("--sample", action="store_true",
                   help="save z (sampled); default saves mu")
    p.add_argument("--config", type=str, default=None,
                   help="yaml whose model.dac section sets the codec "
                        "geometry")
    p.add_argument("--stats_out", type=str, default=None,
                   help="per-channel latent mean/std JSON (default: "
                        "latent_stats.json beside --ckpt on process 0)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def latent_stats(files) -> dict | None:
    """{mean, std, frames} of mu over the files' _latent2x.npz sidecars,
    float64 sums; None when there is none."""
    s = ss = None
    n = 0
    for path in files:
        side = path.with_name(path.stem + "_latent2x.npz")
        if not side.exists():
            continue
        mu = np.load(side)["mu"].astype(np.float64)
        s = mu.sum(0) if s is None else s + mu.sum(0)
        ss = (mu * mu).sum(0) if ss is None else ss + (mu * mu).sum(0)
        n += mu.shape[0]
    if not n:
        return None
    mean = s / n
    var = np.maximum(ss / n - mean * mean, 1e-12)
    return {"mean": mean.tolist(), "std": np.sqrt(var).tolist(), "frames": n}


def main(argv=None):
    args = parse_args(argv)
    import torch

    from minimax_speech_torch.cli.extract_fsq import (collect_files,
                                                      load_weights)
    from minimax_speech_torch.data.pipeline import _load_audio
    from minimax_speech_torch.models import dac_vae
    from minimax_speech_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    pi, pc = args.process_index, args.process_count
    files = collect_files(args)[pi::pc]
    cfg = dac_vae.DACVAEConfig()
    if args.config:
        from minimax_speech_torch import config as cfg_lib
        cfg = cfg_lib.build_tts_config(
            cfg_lib.load_yaml(args.config).get("model", {})).dac
    model = load_weights(dac_vae.DACVAE(cfg), args).to(device).eval()

    failed, done = [], 0
    t0 = time.time()
    for path in files:
        out = path.with_name(path.stem + "_latent2x.npz")
        if args.skip_existing and out.exists():
            continue
        try:
            audio, sr = _load_audio(str(path))
            if sr != cfg.sample_rate:
                raise ValueError(f"expected {cfg.sample_rate}Hz, got {sr}")
            a = dac_vae.pad_to_hop(audio[None, :], cfg.hop_length)
            gen = torch.Generator(device=device).manual_seed(done) \
                if args.sample else None
            with torch.no_grad():
                z, mu, logs = model.encode(
                    torch.as_tensor(a[..., None], device=device), gen)
            np.savez(out, z=z[0].cpu().numpy(), mu=mu[0].cpu().numpy(),
                     logs=logs[0].cpu().numpy())
            if random.random() < args.verify_fraction:
                with torch.no_grad():
                    rec = model.decode(mu)[0, :, 0].cpu().numpy()
                n = min(len(rec), len(audio))
                mse = float(np.mean((rec[:n] - audio[:n]) ** 2))
                sig = float(np.mean(audio[:n] ** 2))
                snr = 10 * np.log10(sig / max(mse, 1e-12))
                print(f"verify {path.name}: mse={mse:.6f} snr={snr:.1f}dB")
            done += 1
        except Exception as e:  # noqa: BLE001 - log, list and go on
            print(f"FAILED {path}: {e}", file=sys.stderr)
            failed.append(str(path))
    if failed:
        Path(f"failed_latents_rank{pi}.txt").write_text("\n".join(failed))
    print(f"[rank {pi}/{pc}] encoded {done} files in "
          f"{time.time() - t0:.1f}s ({len(failed)} failed)")

    stats_out = args.stats_out
    if stats_out is None and args.ckpt and pi == 0:
        stats_out = str(Path(args.ckpt).parent / "latent_stats.json")
    stats = latent_stats(files) if stats_out else None
    if stats is not None:
        Path(stats_out).write_text(json.dumps(stats))
        print(f"[rank {pi}/{pc}] latent stats ({stats['frames']} frames) "
              f"-> {stats_out}")


if __name__ == "__main__":
    main()
