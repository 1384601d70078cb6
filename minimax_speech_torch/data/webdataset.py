"""WebDataset-layout tar-shard reader (stdlib tarfile, no wds package).

Port of minimax_speech_tpu/data/webdataset.py, the same order and the
same samples for the same shards, seed, rank and world:

  * samples are tar members sharing a key (the name up to the first
    dot, the webdataset convention), e.g. `000123.jpg` + `000123.txt`
  * shards are split across ranks (rank::world) after a per-epoch
    permutation from np.random.default_rng((seed, epoch))
  * samples pass through a shuffle buffer drawn from the same generator
  * an unreadable member is skipped with a warning, the epoch goes on

Decoded fields: images (.jpg/.png/...) -> (H, W, 3) float32 in [-1, 1]
square-cropped and resized (PIL, imported where an image is decoded);
.txt -> caption str; .cls -> int label; .json -> dict; .npy -> array.
Batches stack the images and collect the other fields.
"""
from __future__ import annotations

import io
import json
import tarfile
from pathlib import Path
from typing import Iterator, Optional, Sequence

import numpy as np

from minimax_speech_torch.data.image_folder import IMAGE_EXTS


def _decode_image(data: bytes, size: Optional[int]) -> np.ndarray:
    from PIL import Image

    img = Image.open(io.BytesIO(data)).convert("RGB")
    w, h = img.size
    side = min(w, h)
    img = img.crop(((w - side) // 2, (h - side) // 2,
                    (w - side) // 2 + side, (h - side) // 2 + side))
    if size is not None:
        img = img.resize((size, size), Image.BILINEAR)
    arr = np.asarray(img, np.float32) / 255.0
    return arr * 2.0 - 1.0


def decode_member(name: str, data: bytes, size: Optional[int]):
    """-> (field, value) or None for unknown extensions."""
    ext = "." + name.split(".")[-1].lower()
    if ext in IMAGE_EXTS:
        return "image", _decode_image(data, size)
    if ext == ".txt":
        return "caption", data.decode("utf-8")
    if ext == ".cls":
        return "label", int(data.decode("utf-8").strip())
    if ext == ".json":
        return "meta", json.loads(data.decode("utf-8"))
    if ext == ".npy":
        return "array", np.load(io.BytesIO(data), allow_pickle=False)
    return None


class WebDatasetShards:
    """Iterate key-grouped samples from .tar shards.

    shards: explicit paths, a directory of *.tar, or a .json file
    holding a list of shard paths (the reference's tar_list layout).
    """

    def __init__(self, shards, size: Optional[int] = 64,
                 shuffle_buffer: int = 690, seed: int = 0,
                 rank: int = 0, world: int = 1,
                 required: Sequence[str] = ("image",)):
        if isinstance(shards, (str, Path)):
            p = Path(shards)
            if p.suffix == ".json":
                shards = [Path(s) for s in json.loads(p.read_text())]
            elif p.is_dir():
                shards = sorted(p.glob("*.tar"))
            else:
                shards = [p]
        self.shards = [Path(s) for s in shards]
        if not self.shards:
            raise FileNotFoundError("no tar shards")
        if not (0 <= rank < world):
            raise ValueError(f"rank {rank} outside world {world}")
        self.size = size
        self.shuffle_buffer = shuffle_buffer
        self.seed = seed
        self.rank, self.world = rank, world
        self.required = tuple(required)

    def _shard_samples(self, shard: Path) -> Iterator[dict]:
        with tarfile.open(shard) as tf:
            cur_key, sample = None, {}
            for m in tf:
                if not m.isfile():
                    continue
                base = Path(m.name).name
                key = base.split(".")[0]
                if key != cur_key:
                    if cur_key is not None and all(
                            r in sample for r in self.required):
                        yield sample
                    cur_key, sample = key, {"key": key}
                try:
                    dec = decode_member(base, tf.extractfile(m).read(),
                                        self.size)
                except Exception as e:  # warn-and-continue
                    print(f"skip {shard.name}/{m.name}: {e}")
                    continue
                if dec is not None:
                    sample[dec[0]] = dec[1]
            if cur_key is not None and all(
                    r in sample for r in self.required):
                yield sample

    def samples(self, epoch: int = 0) -> Iterator[dict]:
        rng = np.random.default_rng((self.seed, epoch))
        order = rng.permutation(len(self.shards))
        mine = [self.shards[i] for i in order[self.rank::self.world]]
        buf: list[dict] = []
        for shard in mine:
            for s in self._shard_samples(shard):
                buf.append(s)
                if len(buf) >= self.shuffle_buffer:
                    i = int(rng.integers(0, len(buf)))
                    buf[i], buf[-1] = buf[-1], buf[i]
                    yield buf.pop()
        rng.shuffle(buf)  # type: ignore[arg-type]
        yield from buf

    def batches(self, batch_size: int, epoch: int = 0,
                drop_last: bool = True) -> Iterator[dict]:
        """-> {"image": (B, H, W, 3), "caption": [B str], "key": [B]}"""
        acc: list[dict] = []
        for s in self.samples(epoch):
            acc.append(s)
            if len(acc) == batch_size:
                yield self._collate(acc)
                acc = []
        if acc and not drop_last:
            yield self._collate(acc)

    @staticmethod
    def _collate(acc: list[dict]) -> dict:
        out: dict = {"key": [s["key"] for s in acc]}
        if "image" in acc[0]:
            out["image"] = np.stack([s["image"] for s in acc])
        for field in ("caption", "label", "meta", "array"):
            if field in acc[0]:
                out[field] = [s.get(field) for s in acc]
        return out


def write_shards(samples: Iterator[tuple[str, dict]], out_dir: str,
                 samples_per_shard: int = 1000,
                 prefix: str = "shard") -> list[Path]:
    """Pack (key, {ext: bytes}) pairs into webdataset-layout tars —
    the prep-side tool (tests + dataset conversion)."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    paths, tf, count, idx = [], None, 0, 0
    for key, fields in samples:
        if tf is None:
            paths.append(out / f"{prefix}-{idx:06d}.tar")
            tf = tarfile.open(paths[-1], "w")
        for ext, data in fields.items():
            info = tarfile.TarInfo(f"{key}.{ext.lstrip('.')}")
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
        count += 1
        if count >= samples_per_shard:
            tf.close()
            tf, count, idx = None, 0, idx + 1
    if tf is not None:
        tf.close()
    return paths
