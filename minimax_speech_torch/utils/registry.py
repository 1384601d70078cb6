"""Model registry: named model directories with sha256 manifests.

Port of minimax_speech_tpu/utils/registry.py, the same stdlib code: a
name -> directory registry whose load_model() verifies every artifact's
hash before use and, given a `fetcher`, fetches a missing directory and
re-fetches a corrupted one once (into a temporary directory swapped in
atomically). The manifest format is the JAX package's, so each package
verifies the other's directories, and load_model reads `<dir>/<kind>.npz`
through the port's params_io, the same flat .npz format.

  registry.write_manifest("ckpts/tts")       # after converting ckpts
  registry.register("my-tts", "ckpts/tts")
  tree = registry.load_model("my-tts", kind="llm")   # verifies sha256

verify_model_dir reads the manifest's "files" map only. A directory
written by cli/download_pretrained.py, whose manifest maps each name to
{"sha256", "bytes"} at the top level, therefore verifies with nothing
checked, in both packages alike.
"""
from __future__ import annotations

import hashlib
import json
import shutil
import tempfile
from pathlib import Path
from typing import Callable, Dict, Optional

MANIFEST = "manifest.json"

# name -> model dir (this process's registry; register(..., persist_to=)
# also writes it to a JSON file that load_registry reads back)
_MODELS: Dict[str, str] = {}


def sha256_file(path: str | Path, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(chunk), b""):
            h.update(block)
    return h.hexdigest()


def write_manifest(model_dir: str | Path,
                   patterns=("*.npz", "*.tiktoken", "*.json")) -> dict:
    """Hash every model artifact in the dir into manifest.json."""
    d = Path(model_dir)
    files = {}
    for pat in patterns:
        for p in sorted(d.glob(pat)):
            if p.name != MANIFEST:
                files[p.name] = sha256_file(p)
    manifest = {"files": files}
    (d / MANIFEST).write_text(json.dumps(manifest, indent=1))
    return manifest


def verify_model_dir(model_dir: str | Path) -> list[str]:
    """The problems found (an empty list: verified): a missing manifest,
    missing files, sha256 mismatches."""
    d = Path(model_dir)
    mpath = d / MANIFEST
    if not mpath.exists():
        return [f"missing {MANIFEST}"]
    manifest = json.loads(mpath.read_text())
    problems = []
    for name, want in manifest.get("files", {}).items():
        p = d / name
        if not p.exists():
            problems.append(f"missing file {name}")
        elif sha256_file(p) != want:
            problems.append(f"sha256 mismatch: {name}")
    return problems


def register(name: str, model_dir: str | Path,
             persist_to: Optional[str] = None) -> None:
    _MODELS[name] = str(model_dir)
    if persist_to:
        p = Path(persist_to)
        data = json.loads(p.read_text()) if p.exists() else {}
        data[name] = str(model_dir)
        p.write_text(json.dumps(data, indent=1))


def load_registry(path: str | Path) -> None:
    for name, d in json.loads(Path(path).read_text()).items():
        _MODELS[name] = d


def available_models() -> list[str]:
    return sorted(_MODELS)


def resolve(name_or_dir: str) -> Path:
    return Path(_MODELS.get(name_or_dir, name_or_dir))


def load_model(name_or_dir: str, kind: str = "llm", verify: bool = True,
               fetcher: Optional[Callable[[str, Path], None]] = None
               ) -> dict:
    """`<dir>/<kind>.npz` as a nested dict of numpy arrays, after the
    directory verifies. `fetcher(name, dir)` materialises a missing
    directory first, and is called once more, into a fresh directory,
    when files are missing or corrupted."""
    d = resolve(name_or_dir)

    if not d.exists() and fetcher is not None:
        d.mkdir(parents=True, exist_ok=True)
        try:
            fetcher(name_or_dir, d)
        except Exception:
            # leave no half-fetched dir to wedge later loads
            shutil.rmtree(d, ignore_errors=True)
            raise
    if verify:
        problems = verify_model_dir(d)
        # a missing manifest on a present dir (say, checkpoints converted
        # here, which no fetcher reproduces) is not corruption: never
        # delete the user's files for it
        corrupted = [p for p in problems
                     if not p.startswith("missing manifest")]
        if problems and fetcher is not None and (corrupted
                                                 or not d.exists()):
            tmp = Path(tempfile.mkdtemp(dir=str(d.parent),
                                        prefix=d.name + ".fetch"))
            try:
                fetcher(name_or_dir, tmp)
            except Exception:
                shutil.rmtree(tmp, ignore_errors=True)
                raise
            shutil.rmtree(d, ignore_errors=True)
            tmp.rename(d)
            problems = verify_model_dir(d)
        if problems:
            raise ValueError(f"model dir {d} failed verification: "
                             f"{problems}")
    from minimax_speech_torch.utils.params_io import load_params
    return load_params(str(d / f"{kind}.npz"))
