"""Fetch released checkpoints and convert them to .npz weights.

Port of minimax_speech_tpu/cli/download_pretrained.py. The fetch is
resumable stdlib HTTP; each file's sha256 and size go into the model
directory's manifest.json ({name: {"sha256", "bytes"}}, the JAX
package's layout). With --convert each upstream torch or .onnx artifact
is converted once, on the host, into the flat .npz parameter files that
both packages load (utils/convert.py, utils/params_io.py), so no
checkpoint needs converting at run time.

  python -m minimax_speech_torch.cli.download_pretrained \
      --model_dir pretrained/cosyvoice2-0.5b \
      [--base_url https://huggingface.co/.../resolve/main] \
      [--files llm.pt flow.pt ...] [--convert]

--base_url accepts any URL scheme urllib supports (file:// works for
air-gapped mirrors and tests).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
import urllib.error
import urllib.request
from pathlib import Path

DEFAULT_BASE = ("https://huggingface.co/FunAudioLLM/CosyVoice2-0.5B"
                "/resolve/main")
DEFAULT_FILES = ("llm.pt", "flow.pt", "hift.pt",
                 "speech_tokenizer_v2.onnx", "campplus.onnx",
                 "cosyvoice2.yaml")


def fetch(url: str, dest: Path, chunk: int = 1 << 20,
          progress: bool = True) -> str:
    """Resumable download -> dest; returns the file's sha256."""
    dest.parent.mkdir(parents=True, exist_ok=True)
    tmp = dest.with_suffix(dest.suffix + ".part")
    have = tmp.stat().st_size if tmp.exists() else 0
    req = urllib.request.Request(url)
    if have:
        req.add_header("Range", f"bytes={have}-")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            # resume only on an explicit 206 Partial Content: a server
            # that ignores Range (file://, some CDNs) sends the whole
            # body, which appended after the stale prefix would corrupt
            # the file
            partial = have and getattr(r, "status", None) == 206
            if have and not partial:
                have = 0
            with open(tmp, "ab" if partial else "wb") as f:
                total = have + int(r.headers.get("Content-Length") or 0)
                done = have
                for buf in iter(lambda: r.read(chunk), b""):
                    f.write(buf)
                    done += len(buf)
                    if progress and total:
                        pct = 100.0 * done / total
                        print(f"\r  {dest.name}: {pct:5.1f}%", end="",
                              file=sys.stderr)
    except urllib.error.HTTPError as e:
        if not (e.code == 416 and tmp.exists()):  # 416: already complete
            raise
    if progress:
        print(file=sys.stderr)
    tmp.replace(dest)
    h = hashlib.sha256()
    with open(dest, "rb") as f:
        for blk in iter(lambda: f.read(chunk), b""):
            h.update(blk)
    return h.hexdigest()


def convert_checkpoints(model_dir: Path,
                        config: str = "configs/default.yaml") -> list[str]:
    """The upstream torch and .onnx artifacts in model_dir -> .npz
    parameter files beside them (host work, no device). Returns the
    names written."""
    import torch

    from minimax_speech_torch import config as cfg_lib
    from minimax_speech_torch.models import s3tokenizer as s3
    from minimax_speech_torch.utils import convert
    from minimax_speech_torch.utils.onnx_reader import read_onnx_initializers
    from minimax_speech_torch.utils.params_io import save_tree

    cfg = cfg_lib.load_tts_config(config)

    def torch_load(p):
        sd = torch.load(p, map_location="cpu", weights_only=True)
        return convert.strip_prefix({k: v.numpy() for k, v in sd.items()})

    made = []
    jobs = (
        ("llm.pt", "llm.npz",
         lambda s: convert.speech_lm_params(s, cfg.lm)),
        ("flow.pt", "flow.npz",
         lambda s: convert.flow_params(s, cfg.flow)),
        ("hift.pt", "hift.npz",
         lambda s: convert.hift_params(s, cfg.hift)),
        ("speech_tokenizer_v2.onnx", "s3.npz", s3.params_from_torch_state),
        ("campplus.onnx", "campplus.npz", convert.campplus_params),
    )
    for src, dst, fn in jobs:
        sp = model_dir / src
        if not sp.exists():
            continue
        state = (read_onnx_initializers(str(sp)) if sp.suffix == ".onnx"
                 else torch_load(sp))
        save_tree(str(model_dir / dst), fn(state))
        made.append(dst)
        print(f"  converted {src} -> {dst}")
    return made


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_dir", required=True)
    p.add_argument("--base_url", default=DEFAULT_BASE)
    p.add_argument("--files", nargs="*", default=list(DEFAULT_FILES))
    p.add_argument("--convert", action="store_true",
                   help="convert fetched torch/onnx artifacts to .npz")
    p.add_argument("--config", default="configs/default.yaml",
                   help="model geometry for the torch->npz conversion")
    p.add_argument("--skip_existing", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="--no-skip_existing forces a re-fetch of files "
                        "already in the manifest")
    args = p.parse_args(argv)

    model_dir = Path(args.model_dir)
    manifest = {}
    mpath = model_dir / "manifest.json"
    if mpath.exists():
        manifest = json.loads(mpath.read_text())
    for name in args.files:
        dest = model_dir / name
        if args.skip_existing and dest.exists() and name in manifest:
            print(f"  {name}: present, skipping")
            continue
        url = f"{args.base_url}/{name}"
        print(f"fetching {url}")
        digest = fetch(url, dest)
        manifest[name] = {"sha256": digest, "bytes": dest.stat().st_size}
        model_dir.mkdir(parents=True, exist_ok=True)
        mpath.write_text(json.dumps(manifest, indent=2))
    if args.convert:
        for dst in convert_checkpoints(model_dir, args.config):
            f = model_dir / dst
            h = hashlib.sha256(f.read_bytes()).hexdigest()
            manifest[dst] = {"sha256": h, "bytes": f.stat().st_size}
        mpath.write_text(json.dumps(manifest, indent=2))
    print(f"done; manifest at {mpath}")


if __name__ == "__main__":
    main()
