"""The native C++ audio loader: wav, flac and mp3 decoded, and resampled,
in threads that release the GIL.

Port of minimax_speech_tpu/data/native_loader.py. The extension is the
repository's native/audio_loader.cpp, compiled by g++ at first use into
build/native/_native_audio-<hash>.so inside the checkout (the hash covers
the source, the flags and the Python headers' directory), never beside
the source. Where it cannot be built or loaded, batch_load says why once
and decodes with data/pipeline.py's Python loader instead: host I/O, not
a device path.
"""
from __future__ import annotations

import functools
import hashlib
import importlib.util
import os
import subprocess
import sysconfig
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "audio_loader.cpp"
BUILD_DIR = ROOT / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def library_path() -> Path:
    include = sysconfig.get_path("include")
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join((*GXX_FLAGS, include)).encode())
    return BUILD_DIR / f"_native_audio-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the extension unless its library exists; returns its
    path. Raises where g++ is missing or fails."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run(["g++", *GXX_FLAGS, f"-I{sysconfig.get_path('include')}",
                    str(SOURCE), "-o", str(tmp), "-lpthread"], check=True,
                   capture_output=True)
    os.replace(tmp, lib)
    return lib


@functools.cache
def _native():
    """The loaded extension module, or None (the reason printed)."""
    try:
        lib = build()
        spec = importlib.util.spec_from_file_location("_native_audio", lib)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    except (OSError, ImportError, subprocess.CalledProcessError) as e:
        why = (getattr(e, "stderr", None) or b"").decode(errors="replace")
        print(f"native loader unavailable ({e} {why[-500:]}); using python "
              f"fallback")
        return None


def native_available() -> bool:
    return _native() is not None


def batch_load(paths: list[str], target_sr: int = 0,
               num_threads: int = 4) -> list:
    """Decode the files in `num_threads` threads: [(float32 mono audio,
    sample rate)], resampled linearly to target_sr when it is not 0.
    Raises IOError on the first file that fails (the caller decides what
    to skip)."""
    mod = _native()
    if mod is None:
        from minimax_speech_torch.data.pipeline import (_load_audio,
                                                        linear_resample)
        out = []
        for p in paths:
            audio, sr = _load_audio(p)
            if target_sr and sr != target_sr:
                audio = linear_resample(audio, sr, target_sr)
                sr = target_sr
            out.append((audio, sr))
        return out
    out = []
    for (data, sr, err), p in zip(
            mod.load_batch([str(p) for p in paths], target_sr, num_threads),
            paths):
        if err is not None:
            raise IOError(f"{p}: {err}")
        out.append((np.frombuffer(data, np.float32), target_sr or sr))
    return out


def native_file_opener(data, prefetch: int = 16, num_threads: int = 4,
                       target_sr: int = 0):
    """A pipeline stage in place of individual_file_opener: decodes
    `prefetch` files at a time by batch_load, then attaches the
    sidecars. A group with a file that fails is skipped and logged."""
    from minimax_speech_torch.data import pipeline as dp

    def flush(buf):
        try:
            audios = batch_load([s["src"] for s in buf], target_sr,
                                num_threads)
        except IOError as e:
            print(f"native opener batch failed, skipping: {e}")
            return
        for s, (audio, sr) in zip(buf, audios):
            s["audio"] = audio
            s["sample_rate"] = sr
            yield from dp.attach_sidecars(s)

    buf = []
    for sample in data:
        buf.append(sample)
        if len(buf) >= prefetch:
            yield from flush(buf)
            buf = []
    if buf:
        yield from flush(buf)
