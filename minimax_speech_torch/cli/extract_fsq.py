"""Speech-token extraction: `python -m minimax_speech_torch.cli.extract_fsq --dir DATA --ckpt s3.npz`.

Port of minimax_speech_tpu/cli/extract_fsq.py: every wav under --dir (or
in --file_list), this process's share (--process_index of
--process_count), resampled to 16 kHz, its whisper log-mel through
models/s3tokenizer.quantize_long (any length, 30 s windows in one
batched call), the tokens written as <stem><--output_suffix> (default
_fsq.npy). --model_version v2 (FSQ, the geometry of --config's model.s3
section or the default) or v1_25hz / v1_50hz (the Euclidean codebook of
4096 at the default geometry); weights from --ckpt (.npz in the JAX
package's format) or --random_init (seed 0). A file that fails is
logged, counted and listed in failed_files_rank<i>.txt. Runs on
--device (default cuda; raises without a GPU).
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dir", type=str, default=None)
    p.add_argument("--file_list", type=str, default=None)
    p.add_argument("--ckpt", type=str, default=None,
                   help=".npz of the tokenizer's weights (the JAX "
                        "package's format; see convert_checkpoint)")
    p.add_argument("--output_suffix", type=str, default="_fsq.npy")
    p.add_argument("--skip_existing", action="store_true")
    p.add_argument("--process_index", type=int, default=0)
    p.add_argument("--process_count", type=int, default=1)
    p.add_argument("--random_init", action="store_true",
                   help="random weights (seed 0), a smoke test without a "
                        "checkpoint")
    p.add_argument("--model_version", choices=["v2", "v1_25hz", "v1_50hz"],
                   default="v2",
                   help="v2 = FSQ (default); v1 = the VQ codebook at 25/50 Hz")
    p.add_argument("--config", type=str, default=None,
                   help="yaml whose model.s3 section sets the v2 geometry")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def collect_files(args) -> list[Path]:
    """--file_list's paths, else every *.wav under --dir, sorted."""
    if args.file_list:
        return [Path(line.strip()) for line in
                Path(args.file_list).read_text().splitlines() if line.strip()]
    if args.dir:
        return sorted(Path(args.dir).rglob("*.wav"))
    raise SystemExit("need --dir or --file_list")


def load_weights(module, args, subtree: str | None = None,
                 init_seed: int = 0):
    """`module` with --ckpt's weights (the flax tree, or its `subtree` of
    params), else random weights from init_seed (--random_init)."""
    import torch

    from minimax_speech_torch.utils import params_io
    if args.ckpt:
        tree = params_io.load_params(args.ckpt)
        if subtree is not None:
            tree = tree["params"][subtree]
        return params_io.load_flax_params(module, tree)
    if args.random_init:
        return params_io.init_params(module,
                                     torch.Generator().manual_seed(init_seed))
    raise SystemExit("need --ckpt or --random_init")


def build_model(args):
    from minimax_speech_torch.models import s3tokenizer as s3
    if args.model_version == "v2":
        cfg = s3.S3TokenizerConfig()
        if args.config:
            from minimax_speech_torch import config as cfg_lib
            cfg = cfg_lib.build_tts_config(
                cfg_lib.load_yaml(args.config).get("model", {})).s3
        return s3.S3TokenizerV2(cfg)
    return s3.S3TokenizerV1(s3.S3TokenizerConfig(codebook_size=4096),
                            stride=2 if args.model_version == "v1_25hz"
                            else 1)


def main(argv=None):
    args = parse_args(argv)
    import torch

    from minimax_speech_torch.data.pipeline import _load_audio, linear_resample
    from minimax_speech_torch.models import s3tokenizer as s3
    from minimax_speech_torch.ops import mel as mel_ops
    from minimax_speech_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    pi, pc = args.process_index, args.process_count
    files = collect_files(args)[pi::pc]
    model = load_weights(build_model(args), args).to(device).eval()

    failed, done = [], 0
    t0 = time.time()
    for path in files:
        out = path.with_name(path.stem + args.output_suffix)
        if args.skip_existing and out.exists():
            continue
        try:
            audio, sr = _load_audio(str(path))
            with torch.no_grad():
                mel = mel_ops.whisper_log_mel(torch.as_tensor(
                    linear_resample(audio, sr, 16000), device=device)).T
            mel = mel.cpu().numpy()
            tokens = s3.quantize_long(model, mel, mel.shape[0])
            np.save(out, np.asarray(tokens, np.int32))
            done += 1
        except Exception as e:  # noqa: BLE001 - log, list and go on
            print(f"FAILED {path}: {e}", file=sys.stderr)
            failed.append(str(path))
    if failed:
        Path(f"failed_files_rank{pi}.txt").write_text("\n".join(failed))
    print(f"[rank {pi}/{pc}] tokenized {done} files in "
          f"{time.time() - t0:.1f}s ({len(failed)} failed)")


if __name__ == "__main__":
    main()
