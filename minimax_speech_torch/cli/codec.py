"""Codec artifact CLI: wavs to .dacz and back.

Port of minimax_speech_tpu/cli/codec.py (infer/codec_file.py around the
default DAC-VAE):

  python -m minimax_speech_torch.cli.codec compress --ckpt dac.npz \\
      --inputs a.wav b.wav [--win 5.0 --overlap 24000 --normalize_db -16]
  python -m minimax_speech_torch.cli.codec decompress --ckpt dac.npz \\
      --inputs a.dacz [--out_dir D]

--ckpt is the DAC-VAE's .npz in the JAX package's format (random weights
from seed 0 without it). compress writes <stem>.dacz, decompress
<stem>_recon.wav at the artifact's sample rate, each beside its input
or in --out_dir. Runs on --device (default cuda; raises without a GPU).
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("mode", choices=["compress", "decompress"])
    p.add_argument("--ckpt", type=str, default=None,
                   help="DAC-VAE params .npz (random init if omitted)")
    p.add_argument("--inputs", nargs="+", required=True)
    p.add_argument("--out_dir", type=str, default=None)
    p.add_argument("--win", type=float, default=5.0)
    p.add_argument("--overlap", type=int, default=24000)
    p.add_argument("--normalize_db", type=float, default=-16.0)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)

    import torch

    from minimax_speech_torch.cli.synthesize import write_wav
    from minimax_speech_torch.data.pipeline import _load_audio
    from minimax_speech_torch.infer.codec_file import DACVAECodec, DACVAEFile
    from minimax_speech_torch.models import dac_vae
    from minimax_speech_torch.utils import params_io
    from minimax_speech_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    model = dac_vae.DACVAE(dac_vae.DACVAEConfig())
    if args.ckpt:
        params_io.load_flax_params(model, params_io.load_params(args.ckpt))
    else:
        params_io.init_params(model, torch.Generator().manual_seed(0))
    codec = DACVAECodec(model.to(device), win_duration=args.win,
                        overlap=args.overlap)

    outs = []
    for src in args.inputs:
        src = Path(src)
        out_dir = Path(args.out_dir) if args.out_dir else src.parent
        t0 = time.perf_counter()
        if args.mode == "compress":
            audio, sr = _load_audio(str(src))
            f = codec.compress(audio, sr, normalize_db=args.normalize_db)
            out = f.save(out_dir / src.stem)
            secs = f.original_length / sr
            kbps = f.latents.nbytes * 8 / secs / 1000
            print(f"{src} -> {out} ({f.latents.shape[0]} frames, "
                  f"{kbps:.1f} kbit/s, {secs / (time.perf_counter() - t0):.1f}"
                  f" audio-s/s)")
        else:
            f = DACVAEFile.load(str(src))
            wav = codec.decompress(f)
            out = out_dir / (src.stem + "_recon.wav")
            write_wav(str(out), wav, f.sample_rate)
            secs = len(wav) / f.sample_rate
            print(f"{src} -> {out} ({len(wav)} samples, "
                  f"{secs / (time.perf_counter() - t0):.1f} audio-s/s)")
        outs.append(out)
    return outs


if __name__ == "__main__":
    main()
