"""MP3 decode through the system's libmpg123, by ctypes.

Port of minimax_speech_tpu/data/mp3.py: data/pipeline.py's _load_audio
takes this branch for an mp3 source, and data/native_loader.py falls
back to it. Where libmpg123 is absent, decoding raises IOError (the
openers skip the file and log it), as the JAX package's does. Output:
mono float32 (the channels averaged) at the file's own sample rate.
"""
from __future__ import annotations

import ctypes
import ctypes.util
from functools import lru_cache

import numpy as np

_ENC_SIGNED_16 = 0xD0   # MPG123_ENC_SIGNED_16 (the universal default)
_ENC_FLOAT_32 = 0x200   # MPG123_ENC_FLOAT_32
_OK = 0
_DONE = -12
_NEW_FORMAT = -11


@lru_cache(maxsize=1)
def _lib():
    for name in ("libmpg123.so.0", "libmpg123.so",
                 ctypes.util.find_library("mpg123")):
        if not name:
            continue
        try:
            lib = ctypes.CDLL(name)
            break
        except OSError:
            continue
    else:
        return None
    lib.mpg123_new.restype = ctypes.c_void_p
    lib.mpg123_new.argtypes = [ctypes.c_char_p,
                               ctypes.POINTER(ctypes.c_int)]
    lib.mpg123_open.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.mpg123_close.argtypes = [ctypes.c_void_p]
    lib.mpg123_delete.argtypes = [ctypes.c_void_p]
    lib.mpg123_delete.restype = None
    lib.mpg123_getformat.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.mpg123_format_none.argtypes = [ctypes.c_void_p]
    lib.mpg123_format.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                  ctypes.c_int, ctypes.c_int]
    lib.mpg123_read.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_size_t,
                                ctypes.POINTER(ctypes.c_size_t)]
    lib.mpg123_strerror.restype = ctypes.c_char_p
    lib.mpg123_strerror.argtypes = [ctypes.c_void_p]
    try:  # no-op since libmpg123 1.27, required before
        lib.mpg123_init()
    except AttributeError:
        pass
    return lib


def mpg123_available() -> bool:
    return _lib() is not None


def decode_mp3(path: str) -> tuple[np.ndarray, int]:
    """Decode an mp3 file to (mono float32 samples, sample_rate)."""
    lib = _lib()
    if lib is None:
        raise IOError(f"libmpg123 unavailable, cannot decode mp3: {path}")
    err = ctypes.c_int(0)
    mh = lib.mpg123_new(None, ctypes.byref(err))
    if not mh:
        raise IOError(f"mpg123_new failed for {path}")

    def fail(what: str):
        detail = lib.mpg123_strerror(mh) or b""
        lib.mpg123_close(mh)
        lib.mpg123_delete(mh)
        raise IOError(f"{what} for {path}: {detail.decode(errors='replace')}")

    if lib.mpg123_open(mh, str(path).encode()) != _OK:
        fail("mpg123_open")
    rate = ctypes.c_long(0)
    channels = ctypes.c_int(0)
    enc = ctypes.c_int(0)
    if lib.mpg123_getformat(mh, ctypes.byref(rate), ctypes.byref(channels),
                            ctypes.byref(enc)) != _OK:
        fail("mpg123_getformat")
    # lock the negotiated format so it cannot change mid-stream (format
    # requests only apply to the NEXT track once decoding has started,
    # so we decode whatever encoding was negotiated — int16 everywhere
    # in practice — instead of forcing one)
    lib.mpg123_format_none(mh)
    lib.mpg123_format(mh, rate.value, channels.value, enc.value)
    sr = int(rate.value)

    def to_mono(raw: bytes) -> np.ndarray:
        if enc.value == _ENC_FLOAT_32:
            x = np.frombuffer(raw, np.float32)
        elif enc.value == _ENC_SIGNED_16:
            x = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
        else:
            fail(f"unsupported mpg123 output encoding {enc.value:#x}")
        nch = max(1, channels.value)
        x = x[:len(x) - len(x) % nch]
        return x.reshape(-1, nch).mean(axis=1).astype(np.float32)

    buf = ctypes.create_string_buffer(1 << 16)
    done = ctypes.c_size_t(0)
    chunks: list[np.ndarray] = []
    while True:
        r = lib.mpg123_read(mh, buf, len(buf), ctypes.byref(done))
        if done.value:
            chunks.append(to_mono(buf.raw[:done.value]))
        if r == _DONE:
            break
        if r == _NEW_FORMAT:
            e0 = enc.value
            lib.mpg123_getformat(mh, ctypes.byref(rate),
                                 ctypes.byref(channels), ctypes.byref(enc))
            if rate.value != sr or enc.value != e0:
                fail("unexpected mid-stream format change")
            continue
        if r != _OK:
            # measured: mpg123 returns DONE even for files truncated
            # mid-frame, so any other code is a real decode error —
            # raise (the pipeline opener logs and skips) rather than
            # return silently truncated audio
            fail("mpg123_read")
    lib.mpg123_close(mh)
    lib.mpg123_delete(mh)
    if not chunks:
        raise IOError(f"no audio frames decoded in {path}")
    return np.concatenate(chunks), sr


def id3v2_size(head: bytes) -> int:
    """Total ID3v2 tag bytes at the start of `head`, 0 if none."""
    if len(head) < 10 or head[:3] != b"ID3":
        return 0
    size = ((head[6] & 0x7F) << 21 | (head[7] & 0x7F) << 14
            | (head[8] & 0x7F) << 7 | (head[9] & 0x7F))
    return 10 + size + (10 if head[5] & 0x10 else 0)  # +footer


def looks_like_mp3(path: str) -> bool:
    """Content sniff, matching native/audio_loader.cpp: container magic
    (RIFF/fLaC, including behind an ID3v2 tag) wins over the extension,
    so a misnamed wav/flac routes to its real decoder on both the
    native and pure-python paths."""
    try:
        with open(path, "rb") as f:
            head = f.read(16)
            skip = id3v2_size(head)
            if skip:
                f.seek(skip)
                head = f.read(4)
                # ID3-tagged flac/wav is NOT mp3; anything else after a
                # real ID3v2 tag is
                return head[:4] not in (b"fLaC", b"RIFF")
    except OSError:
        return False
    if head[:4] in (b"fLaC", b"RIFF"):
        return False
    if len(head) >= 2 and head[0] == 0xFF and (head[1] & 0xE0) == 0xE0:
        return True
    return str(path).endswith(".mp3")
