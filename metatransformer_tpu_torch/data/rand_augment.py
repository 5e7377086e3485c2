"""RandAugment for video clips (host-side numpy).

Port of ``metatransformer_tpu/data/rand_augment.py``: the same numpy
code, kept as the port's own copy.

Reference: ``Video/dataset/rand_augment.py`` (521 LoC, PIL-based; the
Kinetics-400 finetune recipe applies ``rand-m7-n4-mstd0.5`` to every
frame of a clip with ONE sampled op sequence per clip). This is a
clean-room numpy implementation of the same op set and magnitude
schedule, applied uniformly over the temporal axis — frames of a clip
must get identical transforms or the tubelet tokens see temporal
flicker.

Ops (timm/reference list): AutoContrast, Equalize, Invert, Rotate,
Posterize, Solarize, SolarizeAdd, Color, Contrast, Brightness,
Sharpness, ShearX/Y, TranslateX/Y (relative).

All ops take float32 frames [T, H, W, C] in [0, 255].
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

_MAX_LEVEL = 10.0


def _affine(frames: np.ndarray, mat: np.ndarray, fill: float = 128.0) -> np.ndarray:
    """Apply a 2x3 inverse affine map with nearest sampling to every
    frame (PIL Image.transform AFFINE semantics, fillcolor=128)."""
    t, h, w, c = frames.shape
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    sx = mat[0, 0] * xx + mat[0, 1] * yy + mat[0, 2]
    sy = mat[1, 0] * xx + mat[1, 1] * yy + mat[1, 2]
    xi = np.round(sx).astype(np.int64)
    yi = np.round(sy).astype(np.int64)
    inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    xi = np.clip(xi, 0, w - 1)
    yi = np.clip(yi, 0, h - 1)
    out = frames[:, yi, xi, :]
    out[:, ~inside] = fill
    return out


def _blend(a: np.ndarray, b: np.ndarray, factor: float) -> np.ndarray:
    return np.clip(b + factor * (a - b), 0.0, 255.0)


def autocontrast(frames, _level):
    lo = frames.min(axis=(0, 1, 2), keepdims=True)
    hi = frames.max(axis=(0, 1, 2), keepdims=True)
    scale = 255.0 / np.maximum(hi - lo, 1e-6)
    return np.clip((frames - lo) * scale, 0, 255)


def equalize(frames, _level):
    out = np.empty_like(frames)
    for ci in range(frames.shape[-1]):
        ch = frames[..., ci].astype(np.int64).ravel()
        hist = np.bincount(np.clip(ch, 0, 255), minlength=256)
        nz = hist[hist > 0]
        if len(nz) <= 1:
            out[..., ci] = frames[..., ci]
            continue
        step = (hist.sum() - nz[-1]) // 255
        if step == 0:
            out[..., ci] = frames[..., ci]
            continue
        lut = (np.cumsum(hist) - hist) // step
        lut = np.clip(lut, 0, 255)
        out[..., ci] = lut[np.clip(frames[..., ci].astype(np.int64), 0, 255)]
    return out.astype(np.float32)


def invert(frames, _level):
    return 255.0 - frames


def rotate(frames, level):
    deg = (level / _MAX_LEVEL) * 30.0
    if np.random.uniform() < 0.5:
        deg = -deg
    rad = np.deg2rad(deg)
    t, h, w, _ = frames.shape
    cx, cy = w / 2.0, h / 2.0
    cos, sin = np.cos(rad), np.sin(rad)
    # inverse rotation about the center
    mat = np.asarray(
        [[cos, sin, cx - cos * cx - sin * cy],
         [-sin, cos, cy + sin * cx - cos * cy]]
    )
    return _affine(frames, mat)


def posterize(frames, level):
    bits = 4 - int((level / _MAX_LEVEL) * 4)
    bits = max(bits, 1)
    shift = 8 - bits
    q = (frames.astype(np.int64) >> shift) << shift
    return q.astype(np.float32)


def solarize(frames, level):
    thr = 256 - int((level / _MAX_LEVEL) * 256)
    return np.where(frames < thr, frames, 255.0 - frames)


def solarize_add(frames, level):
    add = int((level / _MAX_LEVEL) * 110)
    return np.where(frames < 128, np.clip(frames + add, 0, 255), frames)


def _enh_factor(level):
    f = (level / _MAX_LEVEL) * 1.8 + 0.1
    return f


def color(frames, level):
    gray = frames.mean(axis=-1, keepdims=True)
    return _blend(frames, np.broadcast_to(gray, frames.shape), _enh_factor(level))


def contrast(frames, level):
    mean = frames.mean(axis=(1, 2, 3), keepdims=True)
    return _blend(frames, np.broadcast_to(mean, frames.shape), _enh_factor(level))


def brightness(frames, level):
    return _blend(frames, np.zeros_like(frames), _enh_factor(level))


def sharpness(frames, level):
    k = np.asarray([[1, 1, 1], [1, 5, 1], [1, 1, 1]], np.float32) / 13.0
    t, h, w, c = frames.shape
    sm = np.empty_like(frames)
    pad = np.pad(frames, ((0, 0), (1, 1), (1, 1), (0, 0)), mode="edge")
    for dy in range(3):
        for dx in range(3):
            if dy == 0 and dx == 0:
                sm = k[0, 0] * pad[:, 0 : h, 0 : w]
            else:
                sm = sm + k[dy, dx] * pad[:, dy : dy + h, dx : dx + w]
    return _blend(frames, sm, _enh_factor(level))


def shear_x(frames, level):
    s = (level / _MAX_LEVEL) * 0.3
    if np.random.uniform() < 0.5:
        s = -s
    return _affine(frames, np.asarray([[1.0, s, 0.0], [0.0, 1.0, 0.0]]))


def shear_y(frames, level):
    s = (level / _MAX_LEVEL) * 0.3
    if np.random.uniform() < 0.5:
        s = -s
    return _affine(frames, np.asarray([[1.0, 0.0, 0.0], [s, 1.0, 0.0]]))


def translate_x(frames, level):
    t = (level / _MAX_LEVEL) * 0.45 * frames.shape[2]
    if np.random.uniform() < 0.5:
        t = -t
    return _affine(frames, np.asarray([[1.0, 0.0, t], [0.0, 1.0, 0.0]]))


def translate_y(frames, level):
    t = (level / _MAX_LEVEL) * 0.45 * frames.shape[1]
    if np.random.uniform() < 0.5:
        t = -t
    return _affine(frames, np.asarray([[1.0, 0.0, 0.0], [0.0, 1.0, t]]))


OPS: Dict[str, Callable] = {
    "AutoContrast": autocontrast,
    "Equalize": equalize,
    "Invert": invert,
    "Rotate": rotate,
    "Posterize": posterize,
    "Solarize": solarize,
    "SolarizeAdd": solarize_add,
    "Color": color,
    "Contrast": contrast,
    "Brightness": brightness,
    "Sharpness": sharpness,
    "ShearX": shear_x,
    "ShearY": shear_y,
    "TranslateX": translate_x,
    "TranslateY": translate_y,
}


@dataclasses.dataclass
class RandAugmentConfig:
    """``rand-m{magnitude}-n{num_ops}-mstd{mag_std}`` (the Kinetics
    recipe uses m7 n4 mstd0.5)."""

    num_ops: int = 4
    magnitude: float = 7.0
    mag_std: float = 0.5
    prob: float = 0.5  # per-op apply probability (reference default)


def parse_config(spec: str) -> RandAugmentConfig:
    """'rand-m7-n4-mstd0.5' -> RandAugmentConfig."""
    cfg = RandAugmentConfig()
    for part in spec.split("-")[1:]:
        if part.startswith("mstd"):
            cfg.mag_std = float(part[4:])
        elif part.startswith("m"):
            cfg.magnitude = float(part[1:])
        elif part.startswith("n"):
            cfg.num_ops = int(part[1:])
    return cfg


def rand_augment_clip(
    frames: np.ndarray,  # [T, H, W, C] float32 in [0, 255]
    cfg: RandAugmentConfig,
    rng: np.random.Generator,
) -> np.ndarray:
    """One sampled op sequence applied to EVERY frame of the clip."""
    out = frames.astype(np.float32)
    names = list(OPS)
    for _ in range(cfg.num_ops):
        if rng.uniform() > cfg.prob:
            continue
        name = names[rng.integers(len(names))]
        level = cfg.magnitude
        if cfg.mag_std > 0:
            level = float(np.clip(rng.normal(level, cfg.mag_std), 0, _MAX_LEVEL))
        np.random.seed(int(rng.integers(2**31)))  # sign flips inside ops
        out = OPS[name](out, level)
    return out
