"""DAC-VAE codec evaluation: `python -m minimax_speech_torch.cli.eval_dac --ckpt codec.npz --wav_dir DIR`.

Port of minimax_speech_tpu/cli/eval_dac.py: the first --max_files wavs
under --wav_dir (sorted), each resampled to --sample_rate, encoded to mu
and decoded; STOI, SI-SDR, waveform L1 and the multi-scale mel distance
(utils/audio_metrics.py) of each reconstruction, their means (nan
ignored) and the file count printed as one JSON line. A file that does
not decode is skipped and logged. Runs on --device (default cuda;
raises without a GPU).
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", required=True)
    p.add_argument("--wav_dir", required=True)
    p.add_argument("--config", default=None)
    p.add_argument("--max_files", type=int, default=32)
    p.add_argument("--sample_rate", type=int, default=24000)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    import torch

    from minimax_speech_torch.data.pipeline import _load_audio, linear_resample
    from minimax_speech_torch.models import dac_vae
    from minimax_speech_torch.utils import audio_metrics as am
    from minimax_speech_torch.utils import params_io
    from minimax_speech_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = dac_vae.DACVAEConfig()
    if args.config:
        from minimax_speech_torch import config as cfg_lib
        cfg = cfg_lib.build_tts_config(
            cfg_lib.load_yaml(args.config).get("model", {})).dac
    model = params_io.load_flax_params(dac_vae.DACVAE(cfg),
                                       params_io.load_params(args.ckpt))
    model.to(device).eval()
    files = sorted(Path(args.wav_dir).rglob("*.wav"))[: args.max_files]
    if not files:
        raise SystemExit(f"no wavs under {args.wav_dir}")

    rows = []
    for f in files:
        try:
            audio, sr = _load_audio(str(f))
        except Exception as e:  # noqa: BLE001 - skip and log
            print(f"skip {f}: {e}")
            continue
        audio = linear_resample(audio, sr, args.sample_rate)
        a = dac_vae.pad_to_hop(audio[None, :], cfg.hop_length)
        with torch.no_grad():
            mu = model.encode(torch.as_tensor(a[..., None], device=device))[1]
            rec = model.decode(mu)[0, :, 0].cpu().numpy()
        n = min(len(rec), len(audio))
        rows.append({"stoi": am.stoi(audio[:n], rec[:n], args.sample_rate),
                     "si_sdr_db": am.si_sdr(audio[:n], rec[:n]),
                     "l1": am.l1_distance(audio[:n], rec[:n]),
                     "mel_l1": am.mel_distance(audio[:n], rec[:n],
                                               args.sample_rate)})
    if not rows:
        raise SystemExit("no files evaluated")
    mean = {k: float(np.nanmean([r[k] for r in rows])) for k in rows[0]}
    mean["n_files"] = len(rows)
    print(json.dumps(mean))
    return mean


if __name__ == "__main__":
    main()
