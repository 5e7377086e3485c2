"""Raw-bytes image ingestion: JPEG/PNG files -> uint8 [B, S, S, 3] batches.

Port of ``metatransformer_tpu/data/image_folder.py``, the loader behind the
image recipes' ``--data``. The host decodes and applies the geometric
augmentation (RandomResizedCrop or resize + center crop, horizontal flip)
straight to **uint8 HWC**; every float op (the /255 scaling, normalising)
runs on the device in the tokenizer. The batches are numpy; the Trainer
moves them.

Decoding is Pillow's only, as ``data/codecs.py`` does: the reference
prefers OpenCV where it imports, which downscales without antialiasing and
applies EXIF rotation (ROADMAP queue 3, reference caveats). The port's
decode equals the reference's PIL branch: eval decodes byte for byte, and
training crops and flips are the same for the same numpy seed.

Decode workers are a thread pool (PIL releases the GIL in its C decode);
``workers=N`` scales the way the reference's ``num_workers`` do.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def scan_image_folder(root: str) -> Tuple[List[Tuple[str, int]], List[str]]:
    """torchvision-ImageFolder layout: root/<class_name>/<image files>.

    Returns (samples, class_names); class index = sorted class-dir order.
    """
    classes = sorted(
        d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
    )
    if not classes:
        raise FileNotFoundError(f"no class subdirectories under {root}")
    samples: List[Tuple[str, int]] = []
    for idx, cls in enumerate(classes):
        cdir = os.path.join(root, cls)
        for dirpath, _, files in os.walk(cdir):
            for f in sorted(files):
                if f.lower().endswith(IMG_EXTENSIONS):
                    samples.append((os.path.join(dirpath, f), idx))
    if not samples:
        raise FileNotFoundError(f"no image files under {root}")
    return samples, classes


def read_manifest(path: str) -> List[Tuple[str, int]]:
    """``<path>\\t<int label>`` per line (AST-manifest-style alternative
    to the class-dir tree; relative paths resolve against the manifest's
    directory)."""
    base = os.path.dirname(os.path.abspath(path))
    samples = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            p, label = line.rsplit("\t", 1)
            if not os.path.isabs(p):
                p = os.path.join(base, p)
            samples.append((p, int(label)))
    if not samples:
        raise ValueError(f"empty manifest {path}")
    return samples


def _random_resized_crop_box(
    w: int, h: int, rng: np.random.Generator,
    scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
) -> Tuple[int, int, int, int]:
    """torchvision RandomResizedCrop box sampling (10 tries, center
    fallback) — the ImageNet train-time geometry every reference image
    recipe inherits from timm."""
    area = w * h
    log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
    for _ in range(10):
        target = area * rng.uniform(*scale)
        ar = np.exp(rng.uniform(*log_ratio))
        cw = int(round(np.sqrt(target * ar)))
        ch = int(round(np.sqrt(target / ar)))
        if 0 < cw <= w and 0 < ch <= h:
            x0 = int(rng.integers(0, w - cw + 1))
            y0 = int(rng.integers(0, h - ch + 1))
            return x0, y0, cw, ch
    # fallback: largest center crop within ratio bounds
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        cw, ch = int(round(h * ratio[1])), h
    else:
        cw, ch = w, h
    return (w - cw) // 2, (h - ch) // 2, cw, ch


def _pil_image():
    """PIL's ``Image`` module, or an ImportError naming Pillow."""
    try:
        from PIL import Image
    except ImportError as exc:
        raise ImportError("decoding image files needs Pillow (PIL), which is not importable") from exc
    return Image


def decode_image(
    path: str,
    size: int = 224,
    train: bool = False,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """One file -> uint8 [size, size, 3], through Pillow.

    train=True: RandomResizedCrop(size) + horizontal flip (p=0.5).
    train=False: resize short side to size*256/224, center crop (the
    standard ImageNet eval protocol).
    """
    Image = _pil_image()
    with Image.open(path) as im:
        im = im.convert("RGB")
        w, h = im.size
        if train:
            rng = rng if rng is not None else np.random.default_rng()
            x0, y0, cw, ch = _random_resized_crop_box(w, h, rng)
            im = im.resize((size, size), Image.BILINEAR, box=(x0, y0, x0 + cw, y0 + ch))
            if rng.random() < 0.5:
                im = im.transpose(Image.FLIP_LEFT_RIGHT)
        else:
            short = int(round(size * 256 / 224))
            if w <= h:
                nw, nh = short, max(int(round(h * short / w)), short)
            else:
                nh, nw = short, max(int(round(w * short / h)), short)
            im = im.resize((nw, nh), Image.BILINEAR)
            x0, y0 = (nw - size) // 2, (nh - size) // 2
            im = im.crop((x0, y0, x0 + size, y0 + size))
        return np.asarray(im, np.uint8)


class ImageFolderLoader:
    """Epoch iterator over an image tree/manifest: shuffle -> threaded
    decode -> uint8 batches ``{"input": [B,S,S,3] u8, "label": [B] i64}``.

    Decode overlaps the consumer: each batch is submitted to the pool
    before the previous one is yielded (``prefetch_batches`` deep), so on a
    multi-core host the device never waits for PIL.
    """

    def __init__(
        self,
        root_or_manifest: str,
        batch_size: int,
        img_size: int = 224,
        train: bool = True,
        seed: int = 0,
        workers: int = 4,
        drop_last: bool = True,
        prefetch_batches: int = 2,
    ):
        if os.path.isdir(root_or_manifest):
            self.samples, self.classes = scan_image_folder(root_or_manifest)
        else:
            self.samples = read_manifest(root_or_manifest)
            self.classes = None
        self.batch_size = batch_size
        self.img_size = img_size
        self.train = train
        self.workers = max(1, workers)
        self.drop_last = drop_last
        self.prefetch_batches = max(1, prefetch_batches)
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = len(self.samples)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        import collections

        idx = np.arange(len(self.samples))
        if self.train:
            self._rng.shuffle(idx)
        end = (
            len(idx) - len(idx) % self.batch_size
            if self.drop_last
            else len(idx)
        )
        starts = list(range(0, end, self.batch_size))
        with ThreadPoolExecutor(max_workers=self.workers) as pool:
            # Only leaf decode_image tasks enter the pool (no nested
            # batch tasks -> no pool-starvation deadlock); the window
            # keeps prefetch_batches batches of futures in flight.
            def submit(start: int):
                sel = idx[start : start + self.batch_size]
                seeds = self._rng.integers(0, 2**31, len(sel))
                futs = [
                    pool.submit(
                        decode_image,
                        self.samples[i][0],
                        self.img_size,
                        self.train,
                        np.random.default_rng(s),
                    )
                    for i, s in zip(sel, seeds)
                ]
                return sel, futs

            window = collections.deque(
                submit(s) for s in starts[: self.prefetch_batches]
            )
            next_i = self.prefetch_batches
            while window:
                sel, futs = window.popleft()
                if next_i < len(starts):
                    window.append(submit(starts[next_i]))
                    next_i += 1
                imgs = np.stack([f.result() for f in futs])
                labels = np.asarray([self.samples[i][1] for i in sel], np.int64)
                yield {"input": imgs, "label": labels}
