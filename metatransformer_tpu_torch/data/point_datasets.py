"""Point-cloud classification datasets: ModelNet40 + ScanObjectNN.

Port of ``metatransformer_tpu/data/point_datasets.py``, line for line: plain
numpy (``h5py`` imported where a file is read), kept as a copy of its
own since importing anything of the reference's package imports JAX.

Reference: ``PointCloud/openpoints/dataset/modelnet/modelnet40_ply.py``
(HDF5 shards of [N, 2048, 3] points + labels, train/test file lists) and
``dataset/scanobjectnn/scanobjectnn.py`` (single h5 per split with keys
``data``/``label``, the PB_T50_RS hardest variant by default).

Host-side numpy loaders (the reference feeds them to its
data/loaders.NumpyLoader); per-split transforms follow the reference
recipes (train: random scale + translate; points are sampled/subsampled
to npoints).
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Dict, List, Tuple

import numpy as np


def _read_h5(path: str) -> Tuple[np.ndarray, np.ndarray]:
    import h5py

    with h5py.File(path, "r") as f:
        return np.asarray(f["data"], np.float32), np.asarray(
            f["label"], np.int64
        ).reshape(-1)


def load_modelnet40_h5(root: str, split: str = "train"):
    """Concatenate the split's HDF5 shards (ply_data_{split}*.h5).
    -> (points [N, P, 3], labels [N])."""
    files = sorted(glob.glob(os.path.join(root, f"*{split}*.h5")))
    if not files:
        raise FileNotFoundError(f"no {split} h5 shards under {root}")
    parts = [_read_h5(f) for f in files]
    return (
        np.concatenate([p for p, _ in parts], 0),
        np.concatenate([l for _, l in parts], 0),
    )


def load_scanobjectnn_h5(root: str, split: str = "train",
                         variant: str = "main_split"):
    """ScanObjectNN: {root}/{variant}/{training|test}_objectdataset*.h5."""
    name = "training" if split == "train" else "test"
    files = sorted(
        glob.glob(os.path.join(root, variant, f"{name}_objectdataset*.h5"))
    )
    if not files:
        raise FileNotFoundError(f"no {split} h5 under {root}/{variant}")
    return _read_h5(files[0])


# ---------------------------------------------------------------------------
# train-time transforms (openpoints/transforms point_transform_cpu)
# ---------------------------------------------------------------------------

def random_scale(points, rng, lo=2.0 / 3.0, hi=3.0 / 2.0):
    """PointsToTensor+PointCloudScaling train recipe (modelnet cfg)."""
    return points * rng.uniform(lo, hi)


def random_translate(points, rng, shift=0.2):
    return points + rng.uniform(-shift, shift, (1, 3)).astype(points.dtype)


def random_point_dropout(points, rng, max_ratio=0.875):
    """Replace a random fraction of points with the first point
    (PointCloudJitter-style dropout used by several recipes)."""
    ratio = rng.uniform(0, max_ratio)
    drop = rng.random(points.shape[0]) < ratio
    out = points.copy()
    out[drop] = points[0]
    return out


def subsample(points, n, rng):
    """Random subsample (train) / first-n (deterministic eval)."""
    if points.shape[0] >= n:
        idx = rng.choice(points.shape[0], n, replace=False)
    else:
        idx = rng.choice(points.shape[0], n, replace=True)
    return points[idx]


@dataclasses.dataclass
class PointDatasetConfig:
    npoints: int = 1024
    train_transforms: bool = True


def make_batches(
    points: np.ndarray,  # [N, P, 3]
    labels: np.ndarray,
    cfg: PointDatasetConfig,
    batch_size: int,
    rng: np.random.Generator,
    train: bool = True,
) -> List[Dict[str, np.ndarray]]:
    """Epoch of batches with per-sample transforms + fixed npoints."""
    order = rng.permutation(len(points)) if train else np.arange(len(points))
    batches = []
    for i in range(0, len(order) - batch_size + 1, batch_size):
        idx = order[i : i + batch_size]
        pts = []
        for j in idx:
            p = subsample(points[j], cfg.npoints, rng)
            if train and cfg.train_transforms:
                p = random_scale(p, rng)
                p = random_translate(p, rng)
            pts.append(p)
        batches.append(
            {"points": np.stack(pts).astype(np.float32), "label": labels[idx]}
        )
    return batches
