"""Stream a Hugging Face audio corpus (Emilia / viVoice layout) to wav+txt.

Port of minimax_speech_tpu/cli/download_dataset.py: a streaming
`datasets.load_dataset`, then per sample a 16-bit mono wav and a
transcript sidecar. The decode takes the sample's already-decoded array
where it has one, else decodes raw wav or flac bytes through the native
loader (data/native_loader.py). Pairs already on disk are skipped, so a
run resumes. `write_sample` holds the per-sample logic, which runs
without the network.

  python -m minimax_speech_torch.cli.download_dataset \
      --dataset amphion/Emilia-Dataset --subset EN --split train \
      --out_dir data/emilia_en [--max_samples N] [--data_list F]
"""
from __future__ import annotations

import argparse
import tempfile
from pathlib import Path

import numpy as np

from minimax_speech_torch.cli.synthesize import write_wav


def _write_wav(path: Path, audio: np.ndarray, sr: int):
    path.parent.mkdir(parents=True, exist_ok=True)
    write_wav(str(path), audio, sr)


def _decode(sample: dict):
    """-> (audio float32 mono, sr) from whatever the dataset provides."""
    for key in ("mp3", "audio", "flac", "wav"):
        a = sample.get(key)
        if a is None:
            continue
        if isinstance(a, dict) and a.get("array") is not None:
            arr = np.asarray(a["array"], np.float32)
            if arr.ndim == 2:
                arr = arr.mean(axis=0 if arr.shape[0] <= 2 else 1)
            return arr, int(a["sampling_rate"])
        if isinstance(a, (bytes, bytearray)):
            # raw container bytes: the native loader reads wav and flac
            from minimax_speech_torch.data.native_loader import batch_load
            suffix = ".wav" if bytes(a[:4]) == b"RIFF" else ".flac"
            with tempfile.NamedTemporaryFile(suffix=suffix) as f:
                f.write(a)
                f.flush()
                arr, sr = batch_load([f.name])[0]
                return np.asarray(arr, np.float32), int(sr)
    raise ValueError("no decodable audio field in sample")


def sample_paths(meta: dict, out_dir: Path) -> tuple[Path, Path]:
    """metadata['wav'] (else '<id>.wav') with the /mp3 shard directory
    dropped and .mp3 -> .wav, under out_dir; the .txt beside it."""
    rel = str(meta.get("wav") or f"{meta['id']}.wav")
    rel = rel.replace("/mp3", "").replace(".mp3", ".wav")
    wav = out_dir / rel
    return wav, wav.with_suffix(".txt")


def write_sample(sample: dict, out_dir: Path) -> tuple[str, bool, Path]:
    """One dataset record -> (id, written, wav_path). Skips existing
    pairs. Returns the path it used, so callers never derive it again
    from another metadata fallback."""
    meta = sample.get("json") or {
        "id": sample.get("id", "sample"),
        "text": sample.get("text", ""),
        "wav": sample.get("wav")}
    wav_path, txt_path = sample_paths(meta, out_dir)
    if wav_path.exists() and txt_path.exists():
        return str(meta["id"]), False, wav_path
    audio, sr = _decode(sample)
    txt_path.parent.mkdir(parents=True, exist_ok=True)
    txt_path.write_text(meta.get("text", ""))
    _write_wav(wav_path, audio, sr)
    return str(meta["id"]), True, wav_path


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", required=True,
                   help="HF dataset id, e.g. amphion/Emilia-Dataset")
    p.add_argument("--subset", default=None)
    p.add_argument("--split", default="train")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--max_samples", type=int, default=None)
    p.add_argument("--data_list", default=None,
                   help="also write a data.list of the wav paths")
    args = p.parse_args(argv)

    try:
        from datasets import load_dataset
    except ImportError:
        raise SystemExit("the `datasets` package is required for "
                         "streaming downloads")

    ds = load_dataset(args.dataset, args.subset, split=args.split,
                      streaming=True)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    written, skipped, errors = 0, 0, 0
    paths = []
    for i, sample in enumerate(ds):
        if args.max_samples is not None and i >= args.max_samples:
            break
        try:
            sid, fresh, wav_path = write_sample(sample, out_dir)
            paths.append(str(wav_path))
            written += fresh
            skipped += not fresh
        except Exception as e:  # noqa: BLE001 — a bad sample is skipped
            errors += 1
            print(f"  skip sample {i}: {e}")
        if (i + 1) % 100 == 0:
            print(f"  {i + 1} samples ({written} new, {skipped} present, "
                  f"{errors} errors)")
    if args.data_list:
        Path(args.data_list).write_text("\n".join(paths))
    print(f"done: {written} written, {skipped} existing, {errors} errors")


if __name__ == "__main__":
    main()
