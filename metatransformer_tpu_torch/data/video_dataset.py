"""Kinetics-style video classification pipeline (format-level).

Port of ``metatransformer_tpu/data/video_dataset.py``: the same numpy
code, kept as the port's own copy.

Reference: ``Video/dataset/datasets.py`` (714 LoC: decord-decoded
Kinetics-400 with segment-based temporal sampling, RandomResizedCrop
train augs, 5 temporal x 3 spatial multi-view test protocol from
``Video/run.sh``).

Container ingestion via ``data/video_decode.py``: ``.avi`` (MJPEG or
uncompressed DIB) decodes through the dependency-free native RIFF walk;
``.mp4/.mkv/.mov/.webm`` and compressed-fourcc AVIs (H.264/HEVC/VP9/
MPEG-4) through OpenCV's FFmpeg backend when cv2 is importable. Only the
segment-sampled frames are decoded, mirroring decord's
``get_batch(indices)``; ``.npy`` frame arrays remain the no-dependency
fallback. The sampling/cropping/normalization logic here IS the
reference's either way.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def read_manifest(path: str) -> List[Dict[str, object]]:
    """JSONL manifest: {"clip": <npy path>, "label": int} per line."""
    items = []
    with open(path) as f:
        for line in f:
            if line.strip():
                items.append(json.loads(line))
    return items


def sample_frame_indices(
    total: int, num_frames: int, rng: np.random.Generator = None,
    test_clip: int = 0, test_num_clips: int = 1,
) -> np.ndarray:
    """Segment-based temporal sampling (datasets.py _sample_indices):
    train = one random frame per equal segment; test = evenly spaced
    offsets per temporal view."""
    seg = total / num_frames
    if rng is not None:  # train
        offs = rng.random(num_frames)
    else:  # deterministic view `test_clip` of `test_num_clips`
        offs = np.full(num_frames, (test_clip + 0.5) / test_num_clips)
    idx = (np.arange(num_frames) + offs) * seg
    return np.clip(idx.astype(np.int64), 0, total - 1)


def random_resized_crop(
    frames: np.ndarray, size: int, rng: np.random.Generator,
    scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0),
) -> np.ndarray:
    """Train spatial aug (video_transforms.random_resized_crop): one crop
    window shared by all frames of the clip."""
    t, h, w, c = frames.shape
    area = h * w
    for _ in range(10):
        target = rng.uniform(*scale) * area
        ar = np.exp(rng.uniform(np.log(ratio[0]), np.log(ratio[1])))
        cw = int(round(np.sqrt(target * ar)))
        ch = int(round(np.sqrt(target / ar)))
        if cw <= w and ch <= h:
            y = rng.integers(0, h - ch + 1)
            x = rng.integers(0, w - cw + 1)
            crop = frames[:, y : y + ch, x : x + cw]
            return _resize(crop, size, size)
    side = min(h, w)  # fallback: center crop
    y, x = (h - side) // 2, (w - side) // 2
    return _resize(frames[:, y : y + side, x : x + side], size, size)


def _resize(frames: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """Nearest-neighbor resize (host-side; bilinear runs on-device)."""
    t, h, w, c = frames.shape
    yi = (np.arange(oh) * h / oh).astype(np.int64)
    xi = (np.arange(ow) * w / ow).astype(np.int64)
    return frames[:, yi][:, :, xi]


def three_crop(frames: np.ndarray, size: int) -> List[np.ndarray]:
    """The 3 spatial test views (left/center/right or top/center/bottom
    after short-side resize — final_test's 3-crop protocol)."""
    t, h, w, c = frames.shape
    if h < w:
        frames = _resize(frames, size, max(size, int(round(w * size / h))))
    else:
        frames = _resize(frames, max(size, int(round(h * size / w))), size)
    t, h, w, c = frames.shape
    crops = []
    if w >= h:
        xs = [0, (w - size) // 2, w - size]
        crops = [frames[:, :size, x : x + size] for x in xs]
    else:
        ys = [0, (h - size) // 2, h - size]
        crops = [frames[:, y : y + size, :size] for y in ys]
    return crops


def normalize(frames: np.ndarray) -> np.ndarray:
    """uint8 -> float, ImageNet mean/std (datasets.py GroupNormalize)."""
    return ((frames.astype(np.float32) / 255.0) - IMAGENET_MEAN) / IMAGENET_STD


@dataclasses.dataclass
class VideoDatasetConfig:
    num_frames: int = 16
    crop_size: int = 224
    test_num_clips: int = 5  # temporal views
    test_num_crops: int = 3  # spatial views
    # Kinetics finetune recipe augs (run_class_finetuning args:
    # --aa rand-m7-n4-mstd0.5 --reprob 0.25)
    rand_augment: str = ""  # e.g. "rand-m7-n4-mstd0.5"; "" = off
    erase_prob: float = 0.0  # RandomErasing probability


def train_clip(
    frames: np.ndarray, cfg: VideoDatasetConfig, rng: np.random.Generator
) -> np.ndarray:
    """-> [num_frames, crop, crop, 3] float, augmented + normalized."""
    idx = sample_frame_indices(frames.shape[0], cfg.num_frames, rng)
    return augment_sampled_clip(frames[idx], cfg, rng)


def augment_sampled_clip(
    clip: np.ndarray, cfg: VideoDatasetConfig, rng: np.random.Generator
) -> np.ndarray:
    """Spatial augs on an already-temporally-sampled [num_frames, H, W, 3]
    clip (the container path decodes only sampled frames, so temporal
    sampling happens before decode)."""
    clip = random_resized_crop(clip, cfg.crop_size, rng)
    if rng.random() < 0.5:  # horizontal flip
        clip = clip[:, :, ::-1]
    if cfg.rand_augment:
        from metatransformer_tpu_torch.data import rand_augment as ra

        clip = ra.rand_augment_clip(
            np.ascontiguousarray(clip).astype(np.float32),
            ra.parse_config(cfg.rand_augment), rng,
        )
    clip = normalize(clip)
    if cfg.erase_prob > 0 and rng.random() < cfg.erase_prob:
        # RandomErasing AFTER normalization (timm order), same region
        # across the clip's frames
        t, h, w, _ = clip.shape
        area = rng.uniform(0.02, 1.0 / 3.0) * h * w
        ar = rng.uniform(0.3, 3.3)
        eh = int(round(np.sqrt(area * ar)))
        ew = int(round(np.sqrt(area / ar)))
        if eh < h and ew < w:
            y0 = rng.integers(0, h - eh)
            x0 = rng.integers(0, w - ew)
            clip = clip.copy()
            clip[:, y0 : y0 + eh, x0 : x0 + ew] = rng.standard_normal(
                (t, eh, ew, 3)
            )
    return clip


def test_views(frames: np.ndarray, cfg: VideoDatasetConfig) -> np.ndarray:
    """-> [clips*crops, num_frames, crop, crop, 3]: the 5x3 multi-view
    protocol consumed by models/video_eval.multi_view_logits."""
    views = []
    for ci in range(cfg.test_num_clips):
        idx = sample_frame_indices(
            frames.shape[0], cfg.num_frames,
            test_clip=ci, test_num_clips=cfg.test_num_clips,
        )
        for crop in three_crop(frames[idx], cfg.crop_size):
            views.append(normalize(crop))
    return np.stack(views)


def iter_batches(
    manifest: Sequence[Dict[str, object]],
    cfg: VideoDatasetConfig,
    batch_size: int,
    rng: np.random.Generator,
    train: bool = True,
) -> Iterator[Dict[str, np.ndarray]]:
    order = rng.permutation(len(manifest)) if train else range(len(manifest))
    clip_buf, label_buf = [], []
    for i in order:
        item = manifest[int(i)]
        path = str(item["clip"])
        from metatransformer_tpu_torch.data import video_decode

        if path.lower().endswith(
            (".avi",) + video_decode.CV2_CONTAINER_EXTS
        ):
            total = video_decode.count_video_frames(path)
            idx = sample_frame_indices(total, cfg.num_frames, rng)
            clip = video_decode.read_video(path, idx)  # decode only sampled
            clip_buf.append(augment_sampled_clip(clip, cfg, rng))
        else:
            frames = np.load(path)
            clip_buf.append(train_clip(frames, cfg, rng))
        label_buf.append(int(item["label"]))
        if len(clip_buf) == batch_size:
            yield {
                "video": np.stack(clip_buf),
                "label": np.asarray(label_buf, np.int64),
            }
            clip_buf, label_buf = [], []
