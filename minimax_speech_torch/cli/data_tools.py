"""Data-prep tools: data lists, validation, a JSON index, parquet shards
and Kaldi-style manifests.

Port of minimax_speech_tpu/cli/data_tools.py, with the same arguments
and outputs (host-only; nothing here touches a device):

  python -m minimax_speech_torch.cli.data_tools create_list --dir D --out l.txt
  python -m minimax_speech_torch.cli.data_tools validate --list l.txt
  python -m minimax_speech_torch.cli.data_tools index --dir D --out idx.json
  python -m minimax_speech_torch.cli.data_tools make_parquet --list l.txt \
      --out_dir shards/ --per_shard 500
  python -m minimax_speech_torch.cli.data_tools manifest --dir D --out_dir m/

make_parquet needs pyarrow; data/pipeline.py parquet_opener reads its
shards, and a list file or index feeds cli/train.py.
"""
from __future__ import annotations

import argparse
import json
import sys
import wave
from pathlib import Path

import numpy as np

# what reading a wav or a sidecar raises for a bad or missing file
_READ_ERRORS = (OSError, EOFError, ValueError, wave.Error)


def create_list(args):
    """One wav path per line for every utterance with complete sidecars
    (reference: tools/create_data_list.py)."""
    files = sorted(Path(args.dir).rglob("*.wav"))
    kept, skipped = [], 0
    for f in files:
        stem = f.with_suffix("")
        has = ((stem.with_suffix(".txt")).exists()
               and any((Path(str(stem) + "_fsq" + ext)).exists()
                       for ext in (".npy", ".pt"))
               and any((Path(str(stem) + "_latent2x" + ext)).exists()
                       for ext in (".npz", ".npy", ".pt")))
        if has or args.all:
            kept.append(str(f))
        else:
            skipped += 1
    Path(args.out).write_text("\n".join(kept) + "\n")
    print(f"wrote {args.out}: {len(kept)} utterances ({skipped} incomplete)")


def validate(args):
    """Audit completeness + basic integrity of every item
    (reference: tools/validate_data.py)."""
    lines = [l.strip() for l in Path(args.list).read_text().splitlines()
             if l.strip()]
    problems = []
    for path in lines:
        f = Path(path)
        stem = f.with_suffix("")
        if not f.exists():
            problems.append((path, "missing wav"))
            continue
        try:
            with wave.open(path) as w:
                if w.getnframes() == 0:
                    problems.append((path, "empty wav"))
        except _READ_ERRORS as e:
            problems.append((path, f"bad wav: {e}"))
            continue
        txt = stem.with_suffix(".txt")
        if not txt.exists() or not txt.read_text().strip():
            problems.append((path, "missing/empty transcript"))
        fsq = Path(str(stem) + "_fsq.npy")
        if fsq.exists():
            toks = np.load(fsq)
            if toks.size == 0 or toks.min() < 0 or toks.max() >= 6561:
                problems.append((path, "invalid fsq tokens"))
        lat = Path(str(stem) + "_latent2x.npz")
        if lat.exists():
            z = np.load(lat)
            if "mu" in z and z["mu"].shape[-1] != 80:
                problems.append((path, f"latent dim {z['mu'].shape}"))
    for p, why in problems:
        print(f"BAD {p}: {why}")
    print(f"validated {len(lines)} items, {len(problems)} problems")
    return 1 if problems else 0


def index(args):
    """JSON index with durations (reference: tools/generate_json_index.py)."""
    files = sorted(Path(args.dir).rglob("*.wav"))
    rows = []
    for f in files:
        try:
            with wave.open(str(f)) as w:
                dur = w.getnframes() / w.getframerate()
            rows.append({"wav": str(f), "duration": round(dur, 3)})
        except _READ_ERRORS:
            continue
    Path(args.out).write_text(json.dumps(
        {"total": len(rows),
         "hours": round(sum(r["duration"] for r in rows) / 3600, 2),
         "items": rows}, indent=1))
    print(f"indexed {len(rows)} files -> {args.out}")


def make_parquet(args):
    """Bundle utterances into parquet shards (legacy recipe,
    reference: tools/make_parquet_list.py)."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    lines = [l.strip() for l in Path(args.list).read_text().splitlines()
             if l.strip()]
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    shard, shard_id, shard_paths = [], 0, []

    def flush(shard, shard_id):
        table = pa.Table.from_pylist(shard)
        path = out_dir / f"shard_{shard_id:05d}.parquet"
        pq.write_table(table, path)
        shard_paths.append(str(path))

    for path in lines:
        f = Path(path)
        stem = f.with_suffix("")
        try:
            row = {"utt": f.stem,
                   "audio_data": f.read_bytes(),
                   "text": stem.with_suffix(".txt").read_text().strip()}
            fsq = Path(str(stem) + "_fsq.npy")
            if fsq.exists():
                row["speech_token"] = np.load(fsq).tolist()
            shard.append(row)
        except _READ_ERRORS as e:
            print(f"skip {path}: {e}", file=sys.stderr)
        if len(shard) >= args.per_shard:
            flush(shard, shard_id)
            shard, shard_id = [], shard_id + 1
    if shard:
        flush(shard, shard_id)
    (out_dir / "data.list").write_text("\n".join(shard_paths) + "\n")
    print(f"wrote {len(shard_paths)} shards -> {out_dir}")


def manifest(args):
    """Kaldi-style wav.scp + text manifests (reference:
    speech/local/prepare_data.py LibriTTS recipe)."""
    files = sorted(Path(args.dir).rglob("*.wav"))
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    scp, txt = [], []
    for f in files:
        utt = f.stem
        t = f.with_suffix(".txt")
        alt = f.with_suffix(".normalized.txt")
        text = (t.read_text().strip() if t.exists()
                else alt.read_text().strip() if alt.exists() else None)
        if text is None:
            continue
        scp.append(f"{utt} {f}")
        txt.append(f"{utt} {text}")
    (out / "wav.scp").write_text("\n".join(scp) + "\n")
    (out / "text").write_text("\n".join(txt) + "\n")
    # utt2spk / spk2utt (LibriTTS convention: spk = utt prefix before _)
    spk2utt: dict = {}
    u2s = []
    for line in scp:
        utt = line.split()[0]
        spk = utt.split("_")[0]
        u2s.append(f"{utt} {spk}")
        spk2utt.setdefault(spk, []).append(utt)
    (out / "utt2spk").write_text("\n".join(u2s) + "\n")
    (out / "spk2utt").write_text("\n".join(
        f"{s} {' '.join(us)}" for s, us in sorted(spk2utt.items())) + "\n")
    print(f"wrote {len(scp)} entries -> {out}/{{wav.scp,text,utt2spk,"
          f"spk2utt}}")


def main(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("create_list")
    c.add_argument("--dir", required=True)
    c.add_argument("--out", required=True)
    c.add_argument("--all", action="store_true",
                   help="include items without sidecars")
    v = sub.add_parser("validate")
    v.add_argument("--list", required=True)
    i = sub.add_parser("index")
    i.add_argument("--dir", required=True)
    i.add_argument("--out", required=True)
    m = sub.add_parser("make_parquet")
    m.add_argument("--list", required=True)
    m.add_argument("--out_dir", required=True)
    m.add_argument("--per_shard", type=int, default=500)
    k = sub.add_parser("manifest")
    k.add_argument("--dir", required=True)
    k.add_argument("--out_dir", required=True)
    args = p.parse_args(argv)
    return {"create_list": create_list, "validate": validate,
            "index": index, "make_parquet": make_parquet,
            "manifest": manifest}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main() or 0)
