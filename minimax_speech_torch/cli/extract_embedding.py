"""Speaker-embedding extraction: `python -m minimax_speech_torch.cli.extract_embedding --dir DATA --ckpt llm.npz`.

Port of minimax_speech_tpu/cli/extract_embedding.py: every wav under
--dir (or in --file_list), this process's share, to <stem>_spk.npy:
  * by default, resampled to 24 kHz, its log-mel through the
    LearnableSpeakerEncoder (the default geometry) whose weights are the
    `speaker_encoder` subtree of --ckpt (an LM or flow .npz in the JAX
    package's format) or random (--random_init, seed 0);
  * with --campplus (a campplus.onnx or a torch state dict), resampled
    to 16 kHz, its kaldi fbank less its mean through CAM++: the (192,)
    x-vector.
The JAX CLI's --source, which it does not read, is not taken. Runs on
--device (default cuda; raises without a GPU).
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dir", type=str, default=None)
    p.add_argument("--file_list", type=str, default=None)
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--random_init", action="store_true")
    p.add_argument("--campplus", type=str, default=None,
                   help="CAM++ weights (.onnx or torch .pt/.bin): embed "
                        "x-vectors with CAM++")
    p.add_argument("--skip_existing", action="store_true")
    p.add_argument("--process_index", type=int, default=0)
    p.add_argument("--process_count", type=int, default=1)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import torch

    from minimax_speech_torch.cli.extract_fsq import (collect_files,
                                                      load_weights)
    from minimax_speech_torch.data.pipeline import _load_audio, linear_resample
    from minimax_speech_torch.models.speaker_encoder import (
        LearnableSpeakerEncoder, SpeakerEncoderConfig)
    from minimax_speech_torch.ops import mel as mel_ops
    from minimax_speech_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    pi, pc = args.process_index, args.process_count
    files = collect_files(args)[pi::pc]
    if args.campplus:
        from minimax_speech_torch.models import campplus
        model = campplus.load_campplus(args.campplus, device=device)
        sample_rate, what = 16000, "campplus "

        def embed(audio):
            return campplus.xvector(model, audio)
    else:
        model = load_weights(
            LearnableSpeakerEncoder(SpeakerEncoderConfig()), args,
            subtree="speaker_encoder").to(device).eval()
        sample_rate, what = 24000, ""

        def embed(audio):
            with torch.no_grad():
                return model(mel_ops.hifigan_log_mel(audio).T[None])

    done, failed = 0, []
    t0 = time.time()
    for path in files:
        out = path.with_name(path.stem + "_spk.npy")
        if args.skip_existing and out.exists():
            continue
        try:
            audio, sr = _load_audio(str(path))
            emb = embed(torch.as_tensor(
                linear_resample(audio, sr, sample_rate), device=device))
            np.save(out, emb[0].cpu().numpy())
            done += 1
        except Exception as e:  # noqa: BLE001 - log and go on
            print(f"FAILED {path}: {e}", file=sys.stderr)
            failed.append(str(path))
    print(f"[rank {pi}/{pc}] {what}embedded {done} files in "
          f"{time.time() - t0:.1f}s ({len(failed)} failed)")


if __name__ == "__main__":
    main()
