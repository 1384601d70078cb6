"""Host-side data pipeline for LM, flow and vocoder training: chained
generator stages.

Port of minimax_speech_tpu/data/pipeline.py. The chains of cli/train.py
run:

  DataList -> individual_file_opener (wav or mp3 + sidecars) ->
  tokenize -> filter_lengths -> resample -> extract_reference_mel ->
  shuffle -> sort_by_len -> dynamic_batch -> padding_llm (--model llm,
  with the rejected plans under --dpo) or padding_flow (--model flow) ->
  prefetch

and, for multi-process training (static shapes: every rank runs the same
shapes each step), filter_static_shapes -> static_batch(drop_last) in
place of dynamic_batch, and padding_llm(pad_to, pad_ref) or
padding_flow(pad_tokens, pad_ref) at fixed pads; DataList partitions the
items by data-parallel rank (`process_index` / `process_count`).

cli/train_hift.py --train_data runs the GAN chain:

  individual_file_opener(require_latent=False) -> filter_lengths ->
  resample -> truncate -> compute_fbank -> [extract_pitch] -> shuffle ->
  static_batch(drop_last) -> padding_gan

and the other openers: parquet_opener (parquet shards of
cli/data_tools.py make_parquet) and data/native_loader.py's
native_file_opener. Stages are generator transformers, fn(iterable,
**cfg) -> iterable of sample dicts (batches: lists of dicts, then dicts
of numpy arrays). They draw from Python's `random` in the JAX package's
order, so a run seeded the same way gives the same batches.
"""
from __future__ import annotations

import io
import logging
import queue
import random
import threading
import wave
from pathlib import Path
from typing import Callable, Iterable, Iterator

import numpy as np

from minimax_speech_torch.data import mp3 as mp3_mod
from minimax_speech_torch.models import llm as llm_mod
from minimax_speech_torch.ops import mel as mel_ops
from minimax_speech_torch.ops.pitch import yin_f0
from minimax_speech_torch.utils.logging import span

TOKEN_LATENT_RATIO = 2  # 50 Hz latents per 25 Hz token


class DataList:
    """The items, shuffled by a Random seeded with the epoch, then (with
    `partition`) every process_count-th from process_index. Multi-process
    training partitions by data-parallel rank: the tensor-parallel peers
    of one dp rank share its batches."""

    def __init__(self, items: list, shuffle: bool = True,
                 partition: bool = True, process_index: int = 0,
                 process_count: int = 1):
        self.items = list(items)
        self.shuffle = shuffle
        self.partition = partition
        self.pi, self.pc = process_index, process_count
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self):
        data = list(self.items)
        if self.shuffle:
            random.Random(self.epoch).shuffle(data)
        if self.partition:
            data = data[self.pi::self.pc]
        for item in data:
            yield dict(item) if isinstance(item, dict) else {"src": item}


def _load_array(stem: str) -> np.ndarray:
    for suffix, loader in ((".npy", np.load), (".npz", _load_npz),
                           (".pt", _load_pt)):
        p = Path(stem + suffix)
        if p.exists():
            return loader(str(p))
    raise FileNotFoundError(stem + ".{npy,npz,pt}")


def _load_npz(path: str) -> np.ndarray:
    """{z, mu, ...} archive: prefer mu."""
    z = np.load(path)
    for k in ("mu", "z", "tokens"):
        if k in z.files:
            return z[k]
    return z[z.files[0]]


def _load_pt(path: str) -> np.ndarray:
    import torch
    t = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(t, dict):
        t = t.get("z", t.get("tokens", next(iter(t.values()))))
    return t.numpy() if hasattr(t, "numpy") else np.asarray(t)


def attach_sidecars(sample: dict, require_latent: bool = True
                    ) -> Iterator[dict]:
    """Attach <stem>.txt, <stem>_fsq.* and <stem>_latent2x.* to a sample
    that already carries decoded audio, tokens and latents cut to a
    common length, and an optional <stem>_fsq_reject.* (DPO's rejected
    tokens) as reject_speech_token; skip-and-log on any error.
    require_latent=False (the vocoder's chain): text and tokens only,
    the tokens whole."""
    try:
        stem = Path(sample["src"]).with_suffix("")
        sample["text"] = Path(str(stem) + ".txt").read_text().strip()
        tok = _load_array(str(stem) + "_fsq")
        if not require_latent:
            sample["speech_token"] = np.asarray(tok, np.int32)
            yield sample
            return
        lat = _load_array(str(stem) + "_latent2x")
        if lat.ndim == 3:
            lat = lat[0]
        if lat.shape[0] == 80 and lat.shape[1] != 80:  # (80, T) -> (T, 80)
            lat = lat.T
        n = min(len(tok), lat.shape[0] // TOKEN_LATENT_RATIO)
        sample["speech_token"] = np.asarray(tok[:n], np.int32)
        sample["speech_latent"] = np.asarray(
            lat[: n * TOKEN_LATENT_RATIO], np.float32)
        try:
            sample["reject_speech_token"] = np.asarray(
                _load_array(str(stem) + "_fsq_reject"), np.int32)
        except Exception:  # noqa: BLE001 - absent or unreadable: no reject
            pass  # padding_llm(dpo=True) drops the sample
        yield sample
    except Exception as e:  # noqa: BLE001 - one sample's fault skips it
        print(f"opener skip {sample.get('src')}: {e}")


def _expand_src(src: str) -> Iterator[str]:
    """One data-list entry -> wav paths: a `.json` index ({"items": [{"wav":
    ...}]} or {"data": [...]}), a directory (every *.wav below it), or a
    file."""
    if src.endswith(".json"):
        import json
        idx = json.loads(Path(src).read_text())
        for r in idx.get("items", idx.get("data", [])):
            yield r["wav"] if isinstance(r, dict) else r
    elif Path(src).is_dir():
        yield from sorted(str(p) for p in Path(src).rglob("*.wav"))
    else:
        yield src


def _load_audio(path: str):
    """(float32 mono audio in [-1, 1), sample rate) of a 16-bit wav (its
    first channel) or an mp3 (data/mp3.py: channels averaged), told apart
    by their content."""
    if mp3_mod.looks_like_mp3(path):
        return mp3_mod.decode_mp3(path)
    with wave.open(path) as w:
        return _wav_audio(w)


def _wav_audio(w: wave.Wave_read):
    sr = w.getframerate()
    raw = w.readframes(w.getnframes())
    audio = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    if w.getnchannels() > 1:
        audio = audio.reshape(-1, w.getnchannels())[:, 0]
    return audio, sr


def individual_file_opener(data: Iterable[dict],
                           require_latent: bool = True) -> Iterator[dict]:
    """Read wav + sidecars per item (attach_sidecars, require_latent as
    it takes it); a file that fails to decode, for any reason, is skipped
    and logged."""
    for sample in data:
        for wav_path in _expand_src(str(sample["src"])):
            item = {**sample, "src": wav_path}
            try:
                audio, sr = _load_audio(wav_path)
            except Exception as e:  # noqa: BLE001 - one file's fault skips it
                print(f"opener skip {wav_path}: {e}")
                continue
            item["audio"] = audio
            item["sample_rate"] = sr
            yield from attach_sidecars(item, require_latent)


def parquet_opener(data: Iterable[dict]) -> Iterator[dict]:
    """Each item's `src` is a parquet shard; yields one sample per row,
    its fields (utt, text, speech_token, ...) beside the item's, with
    audio_data (wav bytes) decoded to audio and sample_rate. An
    unreadable shard is skipped and logged. Needs pyarrow."""
    import pyarrow.parquet as pq
    for sample in data:
        try:
            rows = pq.read_table(sample["src"]).to_pylist()
        except (OSError, ValueError) as e:  # Arrow's errors subclass these
            print(f"parquet opener skip {sample.get('src')}: {e}")
            continue
        for row in rows:
            out = {**sample, **row}
            if "audio_data" in out:
                with wave.open(io.BytesIO(out.pop("audio_data"))) as w:
                    out["audio"], out["sample_rate"] = _wav_audio(w)
            if "speech_token" in out:
                out["speech_token"] = np.asarray(out["speech_token"],
                                                 np.int32)
            yield out


def tokenize(data, tokenizer) -> Iterator[dict]:
    for s in data:
        s["text_token"] = np.asarray(tokenizer.encode(s["text"]), np.int32)
        yield s


def filter_lengths(data, max_length: int = 40960, min_length: int = 100,
                   token_max_length: int = 200, token_min_length: int = 1
                   ) -> Iterator[dict]:
    """Length gates in 10 ms frames and text tokens."""
    for s in data:
        frames = len(s["audio"]) / s["sample_rate"] * 100
        if not (min_length < frames < max_length):
            continue
        if "text_token" in s and not (
                token_min_length <= len(s["text_token"]) <= token_max_length):
            continue
        if len(s.get("speech_token", ())) == 0:
            continue
        if "reject_speech_token" in s and len(s["reject_speech_token"]) == 0:
            continue  # an empty rejected sequence cannot pair
        yield s


def linear_resample(audio: np.ndarray, sr: int, target_sr: int
                    ) -> np.ndarray:
    """(T,) audio at sr -> round(T * target_sr / sr) samples at target_sr,
    linearly interpolated (np.interp), float32."""
    if sr == target_sr:
        return audio.astype(np.float32)
    n = int(round(len(audio) * target_sr / sr))
    return np.interp(np.linspace(0.0, 1.0, n, endpoint=False),
                     np.linspace(0.0, 1.0, len(audio), endpoint=False),
                     audio).astype(np.float32)


def resample(data, target_sr: int = 24000) -> Iterator[dict]:
    """Linear resample, and peak normalization above 1."""
    for s in data:
        if s["sample_rate"] != target_sr:
            s["audio"] = linear_resample(s["audio"], s["sample_rate"],
                                         target_sr)
            s["sample_rate"] = target_sr
        peak = np.abs(s["audio"]).max() if len(s["audio"]) else 0.0
        if peak > 1.0:
            s["audio"] = s["audio"] / peak * 0.9
        yield s


def truncate(data, truncate_length: int = 24480) -> Iterator[dict]:
    """A random crop of truncate_length samples (from `random`), or the
    audio zero-padded to it."""
    for s in data:
        a = s["audio"]
        if len(a) > truncate_length:
            start = random.randint(0, len(a) - truncate_length)
            s["audio"] = a[start: start + truncate_length]
        else:
            s["audio"] = np.pad(a, (0, truncate_length - len(a)))
        yield s


def compute_fbank(data, token_mel_ratio: int = 2) -> Iterator[dict]:
    """speech_feat: the 24 kHz (T, 80) log-mel, cut with the tokens to a
    common length (token_mel_ratio frames per token)."""
    for s in data:
        m = mel_ops.hifigan_log_mel_np(s["audio"]).T
        n = min(m.shape[0] // token_mel_ratio, len(s["speech_token"]))
        s["speech_token"] = s["speech_token"][:n]
        s["speech_feat"] = m[: n * token_mel_ratio].astype(np.float32)
        yield s


def extract_pitch(data, sample_rate: int = 24000, hop: int = 480
                  ) -> Iterator[dict]:
    """pitch_feat: YIN f0 (ops/pitch.py) every `hop` samples."""
    for s in data:
        s["pitch_feat"] = yin_f0(s["audio"], sample_rate, hop)
        yield s


def extract_reference_mel(data, sample_rate: int = 24000,
                          min_length: float = 0.5, max_length: float = 4.0,
                          num_crops: int = 1) -> Iterator[dict]:
    """Random crops -> (T, 80) mels for the speaker encoder."""
    for s in data:
        a = s["audio"]
        crops = []
        for _ in range(num_crops):
            dur = random.uniform(min_length, max_length)
            n = min(int(dur * sample_rate), len(a))
            start = random.randint(0, max(len(a) - n, 0))
            m = mel_ops.hifigan_log_mel_np(a[start: start + n]).T
            crops.append(m.astype(np.float32))
        s["reference_mels"] = crops
        yield s


def shuffle(data, shuffle_size: int = 1000) -> Iterator[dict]:
    buf = []
    for s in data:
        buf.append(s)
        if len(buf) >= shuffle_size:
            random.shuffle(buf)
            yield from buf
            buf = []
    random.shuffle(buf)
    yield from buf


def _len_of(s):
    return len(s["speech_latent"])


def sort_by_len(data, sort_size: int = 500) -> Iterator[dict]:
    buf = []
    for s in data:
        buf.append(s)
        if len(buf) >= sort_size:
            buf.sort(key=_len_of)
            yield from buf
            buf = []
    buf.sort(key=_len_of)
    yield from buf


def dynamic_batch(data, max_frames_in_batch: int = 25000) -> Iterator[list]:
    """Frame-budget batching: longest latent * count stays within the
    budget."""
    buf, longest = [], 0
    for s in data:
        n = _len_of(s)
        if buf and (max(longest, n) * (len(buf) + 1)) > max_frames_in_batch:
            yield buf
            buf, longest = [], 0
        buf.append(s)
        longest = max(longest, n)
    if buf:
        yield buf


def filter_static_shapes(data, model_kind: str, max_len: int,
                         dpo: bool = False,
                         use_spk: bool = True) -> Iterator[dict]:
    """Static-shape mode: drop, before batching, every sample that
    cannot fit the fixed pads (a late drop in the padding stages would
    shrink one rank's batch below the others'): an LM plan longer than
    max_len (sos + spk + text + task + speech; under dpo also a missing,
    empty or over-long rejected one), a flow sample of more than max_len
    tokens."""
    overhead = 3 if use_spk else 2
    dropped = 0
    for s in data:
        if model_kind == "llm":
            n = len(s["text_token"]) + overhead
            ok = n + len(s["speech_token"]) <= max_len
            if dpo:
                rej = s.get("reject_speech_token")
                ok = ok and rej is not None and len(rej) > 0 \
                    and n + len(rej) <= max_len
        else:
            ok = len(s["speech_token"]) <= max_len
        if not ok:
            dropped += 1
            if dropped % 100 == 1:
                logging.warning("filter_static_shapes: dropped %d samples "
                                "that do not fit max_len=%d", dropped,
                                max_len)
            continue
        yield s


def static_batch(data, batch_size: int = 16,
                 drop_last: bool = False) -> Iterator[list]:
    """Batches of batch_size samples; drop_last (multi-process training)
    drops the short last batch, whose shape the other ranks would not
    share."""
    buf = []
    for s in data:
        buf.append(s)
        if len(buf) >= batch_size:
            yield buf
            buf = []
    if buf and not drop_last:
        yield buf


def _bucket(n: int, multiple: int = 64) -> int:
    return max(((n + multiple - 1) // multiple) * multiple, multiple)


def _pad_reference_mels(batch, bucket_multiple: int,
                        pad_ref: int | None = None) -> dict:
    """The first reference mel of each sample, padded to a multiple of
    bucket_multiple, or cut and padded to pad_ref frames."""
    rl = np.array([min(s["reference_mels"][0].shape[0], pad_ref or 1 << 30)
                   for s in batch], np.int32)
    ref = np.zeros((len(batch),
                    pad_ref or _bucket(int(rl.max()), bucket_multiple), 80),
                   np.float32)
    for i, s in enumerate(batch):
        ref[i, : rl[i]] = s["reference_mels"][0][: rl[i]]
    return {"reference_mel": ref, "reference_mel_len": rl}


def padding_flow(batches, token_latent_ratio: int = TOKEN_LATENT_RATIO,
                 bucket_multiple: int = 32, pad_tokens: int | None = None,
                 pad_ref: int | None = None) -> Iterator[dict]:
    """Stage-2 flow batch: tokens padded to a multiple of
    `bucket_multiple`, target latents to token_latent_ratio x that, and
    the reference mels padded to a multiple of `bucket_multiple`. Fixed
    pads (static shapes): tokens to pad_tokens (longer samples dropped
    with a warning), reference mels cut and padded to pad_ref."""
    for batch in batches:
        if pad_tokens is not None:
            kept = [s for s in batch if len(s["speech_token"]) <= pad_tokens]
            if len(kept) < len(batch):
                logging.warning("padding_flow: dropped %d samples longer "
                                "than pad_tokens=%d", len(batch) - len(kept),
                                pad_tokens)
            if not kept:
                continue
            batch = kept
        b = len(batch)
        tl = np.array([len(s["speech_token"]) for s in batch], np.int32)
        tmax = pad_tokens or _bucket(int(tl.max()), bucket_multiple)
        token = np.zeros((b, tmax), np.int32)
        feat = np.zeros((b, tmax * token_latent_ratio, 80), np.float32)
        for i, s in enumerate(batch):
            token[i, : tl[i]] = s["speech_token"]
            feat[i, : len(s["speech_latent"])] = s["speech_latent"]
        out = {"token": token, "token_len": tl, "feat": feat,
               "feat_len": tl * token_latent_ratio}
        if "reference_mels" in batch[0]:
            out.update(_pad_reference_mels(batch, bucket_multiple, pad_ref))
        yield out


def padding_llm(batches, mix_ratio=(5, 15), use_spk: bool = True,
                bucket_multiple: int = 64, bistream_prob: float = 0.5,
                dpo: bool = False, eos: int = 6561, fill: int = 6563,
                pad_to: int | None = None, pad_ref: int | None = None
                ) -> Iterator[dict]:
    """Stage-1 LM batch: the fixed-shape interleave plan (models/llm.py
    build_lm_plan) padded to a multiple of `bucket_multiple`, plus the
    reference mels padded to a multiple of 32. With dpo=True, samples
    without reject_speech_token are dropped with a warning, the bucket
    fits the longer of each sample's chosen and rejected plans, and the
    rejected plans follow at the same pad under `_rej`-suffixed keys,
    with the chosen plans' bistream flags. Fixed pads (static shapes):
    plans padded to pad_to (samples whose chosen or rejected plan is
    longer dropped with a warning), reference mels cut and padded to
    pad_ref. Its own work on each batch is span `data.pad` while tracing
    (utils/logging.py), closed before the batch is yielded."""
    for batch in batches:
        with span("data.pad"):
            if dpo:
                kept = [s for s in batch if "reject_speech_token" in s]
                if len(kept) < len(batch):
                    logging.warning(
                        "padding_llm(dpo): dropping %d/%d samples missing "
                        "reject_speech_token", len(batch) - len(kept),
                        len(batch))
                if not kept:
                    continue
                batch = kept
            flags = [random.random() < bistream_prob for _ in batch]

            def plan_for(token_key, pad_to=None):
                return llm_mod.build_lm_plan(
                    [s["text_token"] for s in batch],
                    [s[token_key] for s in batch], mix_ratio=mix_ratio,
                    use_spk=use_spk, bistream_flags=flags, pad_to=pad_to,
                    eos=eos, fill=fill)

            keys = ("speech_token", "reject_speech_token") if dpo \
                else ("speech_token",)
            lens = np.max([plan_for(k)["seq_len"] for k in keys], axis=0)
            if pad_to is None:
                pad = _bucket(int(lens.max()), bucket_multiple)
            else:
                keep = [i for i in range(len(batch)) if lens[i] <= pad_to]
                if len(keep) < len(batch):
                    logging.warning("padding_llm: dropped %d samples longer "
                                    "than pad_to=%d", len(batch) - len(keep),
                                    pad_to)
                if not keep:
                    continue
                batch = [batch[i] for i in keep]
                flags = [flags[i] for i in keep]
                pad = pad_to
            out = plan_for("speech_token", pad)
            if dpo:
                out.update({k + "_rej": v for k, v in
                            plan_for("reject_speech_token", pad).items()})
            if "reference_mels" in batch[0]:
                out.update(_pad_reference_mels(batch, 32, pad_ref))
        yield out


def padding_gan(batches, hop: int = 480) -> Iterator[dict]:
    """The vocoder's batch: speech_feat (B, T, 80) cut to the shortest
    sample's T, audio (B, T * hop) aligned to it, and pitch (B, T) (the
    YIN frames past a sample's last zero: unvoiced) when the samples
    carry pitch_feat."""
    for batch in batches:
        feats = [s["speech_feat"] for s in batch]
        t_mel = min(f.shape[0] for f in feats)
        out = {"speech_feat": np.stack([f[:t_mel] for f in feats]
                                       ).astype(np.float32),
               "audio": np.stack([s["audio"][: t_mel * hop] for s in batch]
                                 ).astype(np.float32)}
        if "pitch_feat" in batch[0]:
            pitch = [s["pitch_feat"][:t_mel] for s in batch]
            out["pitch"] = np.stack([np.pad(p, (0, t_mel - len(p)))
                                     for p in pitch]).astype(np.float32)
        yield out


def prefetch(batches: Iterable, depth: int = 2) -> Iterator:
    """Prepare up to `depth` batches ahead in a background thread (the
    wav reads and mels overlap the device's steps). Exceptions re-raise
    at the consumer; closing the generator stops the producer."""
    if depth <= 0:
        yield from batches
        return
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    end = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for b in batches:
                if not put(b):
                    return
            put(end)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            put(e)

    t = threading.Thread(target=worker, daemon=True, name="batch-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        t.join(timeout=5.0)


def build_dataset(source: Iterable[dict], stages: list[Callable]
                  ) -> Iterator:
    """Chain the stages over the source."""
    it = iter(source)
    for stage in stages:
        it = stage(it)
    return it
