"""Image folder datasets for the flowae image track.

Port of minimax_speech_tpu/data/image_folder.py, host-side numpy (PIL,
imported where an image is decoded): a recursive folder scan with
resize + centre crop + [-1, 1] normalisation, subdirectory names as
class labels, and synthetic images for tests and smoke runs (the tar
shards: data/webdataset.py). Batches are (B, H, W, C) float32 in
[-1, 1], channel-last, the layout the flowae image modules take.
"""
from __future__ import annotations

from pathlib import Path
from typing import Iterator, Optional

import numpy as np

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


def load_image(path: str, size: Optional[int] = None) -> np.ndarray:
    """PIL load -> RGB -> resize(short side)+center-crop(size) ->
    (H, W, 3) float32 in [-1, 1] (reference: image_dito_inference.py
    transforms.Resize+CenterCrop+Normalize(0.5, 0.5))."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if size is not None:
        w, h = img.size
        scale = size / min(w, h)
        img = img.resize((max(size, round(w * scale)),
                          max(size, round(h * scale))),
                         Image.BILINEAR)
        w, h = img.size
        left = (w - size) // 2
        top = (h - size) // 2
        img = img.crop((left, top, left + size, top + size))
    arr = np.asarray(img, np.float32) / 255.0
    return arr * 2.0 - 1.0


class ImageFolder:
    """Recursive image scan with deterministic order
    (reference: datasets/image_folder.py)."""

    def __init__(self, root: str, size: int = 64,
                 max_images: Optional[int] = None):
        self.size = size
        self.paths = sorted(
            p for p in Path(root).rglob("*")
            if p.suffix.lower() in IMAGE_EXTS)
        if max_images:
            self.paths = self.paths[:max_images]
        if not self.paths:
            raise FileNotFoundError(f"no images under {root}")

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i: int) -> np.ndarray:
        return load_image(str(self.paths[i]), self.size)

    def batches(self, batch_size: int, rng: np.random.Generator,
                n_batches: Optional[int] = None
                ) -> Iterator[np.ndarray]:
        """Random-sample batches; skip-and-log unreadable files
        (pipeline failure-detection convention)."""
        produced = 0
        while n_batches is None or produced < n_batches:
            out = []
            while len(out) < batch_size:
                i = int(rng.integers(0, len(self.paths)))
                try:
                    out.append(self[i])
                except Exception as e:
                    print(f"skip {self.paths[i]}: {e}")
            yield np.stack(out)
            produced += 1


class ClassImageFolder(ImageFolder):
    """Subdirectory name = class label (reference: class_folder.py)."""

    def __init__(self, root: str, size: int = 64,
                 max_images: Optional[int] = None):
        super().__init__(root, size, max_images)
        classes = sorted({p.parent.name for p in self.paths})
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.labels = np.array(
            [self.class_to_idx[p.parent.name] for p in self.paths],
            np.int32)

    @property
    def n_classes(self) -> int:
        return len(self.class_to_idx)

    def batches_with_labels(self, batch_size: int,
                            rng: np.random.Generator,
                            n_batches: Optional[int] = None):
        produced = 0
        while n_batches is None or produced < n_batches:
            idx = rng.integers(0, len(self.paths), batch_size)
            imgs, labs = [], []
            for i in idx:
                try:
                    imgs.append(self[int(i)])
                    labs.append(self.labels[int(i)])
                except Exception as e:
                    print(f"skip {self.paths[int(i)]}: {e}")
            if not imgs:
                continue
            yield np.stack(imgs), np.asarray(labs, np.int32)
            produced += 1


def synthetic_images(n: int, size: int = 32, seed: int = 0) -> np.ndarray:
    """Deterministic gradient+shape images for tests/smoke runs
    (N, size, size, 3) in [-1, 1]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    out = np.zeros((n, size, size, 3), np.float32)
    for i in range(n):
        cx, cy, r = rng.uniform(0.2, 0.8, 3)
        disk = ((xx - cx) ** 2 + (yy - cy) ** 2) < (0.15 * r) ** 2
        img = np.stack([xx * rng.uniform(0.5, 1),
                        yy * rng.uniform(0.5, 1),
                        (xx + yy) / 2], -1)
        img[disk] = rng.uniform(-1, 1, 3)
        out[i] = img * 2.0 - 1.0
    return np.clip(out, -1, 1)
