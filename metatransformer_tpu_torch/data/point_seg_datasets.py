"""Point-cloud segmentation dataset loaders: S3DIS rooms and ShapeNetPart.

Port of ``metatransformer_tpu/data/point_seg_datasets.py``, line for line: plain
numpy (``h5py`` imported where a file is read), kept as a copy of its
own since importing anything of the reference's package imports JAX.

References:
* S3DIS — ``PointCloud/openpoints/dataset/s3dis/s3dis.py``: rooms stored
  as per-object ``Annotations/{class}_{i}.txt`` files of ``x y z r g b``
  rows; training samples 1 m x 1 m blocks of ``num_points`` with the
  9-dim feature layout (xyz, rgb/255, normalized room xyz).
* ShapeNetPart — ``openpoints/dataset/shapenetpart/shapenetpart.py``:
  ``*.txt`` files of ``x y z nx ny nz seg_label`` rows under per-category
  synset dirs, with train/val/test JSON file lists.

Host-side numpy loaders (the reference does this in dataloader workers);
outputs are fixed-size arrays ready for the seg models.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

S3DIS_CLASSES = (
    "ceiling", "floor", "wall", "beam", "column", "window", "door",
    "table", "chair", "sofa", "bookcase", "board", "clutter",
)
_S3DIS_IDX = {c: i for i, c in enumerate(S3DIS_CLASSES)}


def load_s3dis_room(room_dir: str) -> Tuple[np.ndarray, np.ndarray]:
    """``{room}/Annotations/{class}_{k}.txt`` objects -> (points [N, 6]
    xyzrgb, labels [N]). Unknown class names fall into 'clutter'
    (collect_indoor3d_data semantics)."""
    pts_list, lab_list = [], []
    for path in sorted(glob.glob(os.path.join(room_dir, "Annotations", "*.txt"))):
        cls = os.path.basename(path).split("_")[0]
        label = _S3DIS_IDX.get(cls, _S3DIS_IDX["clutter"])
        arr = np.loadtxt(path, dtype=np.float32).reshape(-1, 6)
        pts_list.append(arr)
        lab_list.append(np.full(len(arr), label, np.int64))
    if not pts_list:
        raise FileNotFoundError(f"no Annotations/*.txt under {room_dir}")
    return np.concatenate(pts_list), np.concatenate(lab_list)


def s3dis_block_sample(
    points: np.ndarray,  # [N, 6] xyzrgb
    labels: np.ndarray,  # [N]
    num_points: int,
    rng: np.random.Generator,
    block_size: float = 1.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Sample one block around a random seed point -> (feat [P, 9],
    labels [P]). Feature layout: centered xy + z, rgb/255, xyz normalized
    by the room extent (the classic 9-dim S3DIS input)."""
    xyz = points[:, :3]
    room_min, room_max = xyz.min(0), xyz.max(0)
    for _ in range(16):
        seed = xyz[rng.integers(len(xyz))]
        lo = seed[:2] - block_size / 2
        hi = seed[:2] + block_size / 2
        mask = np.all((xyz[:, :2] >= lo) & (xyz[:, :2] <= hi), axis=1)
        if mask.sum() >= max(num_points // 4, 1):
            break
    idx = np.where(mask)[0]
    sel = rng.choice(idx, num_points, replace=len(idx) < num_points)
    block = points[sel]
    feat = np.zeros((num_points, 9), np.float32)
    center = (lo + hi) / 2
    feat[:, 0:2] = block[:, 0:2] - center
    feat[:, 2] = block[:, 2]
    feat[:, 3:6] = block[:, 3:6] / 255.0
    feat[:, 6:9] = (block[:, :3] - room_min) / np.maximum(
        room_max - room_min, 1e-6
    )
    return feat, labels[sel]


def list_s3dis_rooms(
    root: str, test_area: int = 5, split: str = "train"
) -> List[str]:
    """``{root}/Area_{k}/{room}`` dirs; Area_{test_area} held out
    (the 6-fold protocol's single-fold slice)."""
    rooms = sorted(glob.glob(os.path.join(root, "Area_*", "*")))
    rooms = [r for r in rooms if os.path.isdir(r)]
    tag = f"Area_{test_area}"
    if split == "train":
        return [r for r in rooms if tag not in r]
    return [r for r in rooms if tag in r]


# ---------------------------------------------------------------------------
# ShapeNetPart
# ---------------------------------------------------------------------------

# synset -> (category name, part-label offset); 50 parts over 16 cats
SHAPENETPART_CATEGORIES = {
    "02691156": ("airplane", 0), "02773838": ("bag", 4),
    "02954340": ("cap", 6), "02958343": ("car", 8),
    "03001627": ("chair", 12), "03261776": ("earphone", 16),
    "03467517": ("guitar", 19), "03624134": ("knife", 22),
    "03636649": ("lamp", 24), "03642806": ("laptop", 28),
    "03790512": ("motorbike", 30), "03797390": ("mug", 36),
    "03948459": ("pistol", 38), "04099429": ("rocket", 41),
    "04225987": ("skateboard", 44), "04379243": ("table", 47),
}


def load_shapenetpart_file(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``x y z nx ny nz seg`` rows -> (xyz [N, 3], normals [N, 3],
    seg labels [N])."""
    arr = np.loadtxt(path, dtype=np.float32).reshape(-1, 7)
    return arr[:, :3], arr[:, 3:6], arr[:, 6].astype(np.int64)


def load_shapenetpart_split(
    root: str, split: str = "train"
) -> List[Tuple[str, str]]:
    """``train_test_split/shuffled_{split}_file_list.json`` entries
    ``shape_data/{synset}/{id}`` -> [(synset, txt path)]."""
    with open(
        os.path.join(
            root, "train_test_split", f"shuffled_{split}_file_list.json"
        )
    ) as f:
        entries = json.load(f)
    out = []
    for e in entries:
        _, synset, sid = e.split("/")
        out.append((synset, os.path.join(root, synset, f"{sid}.txt")))
    return out


def shapenetpart_sample(
    path: str,
    synset: str,
    num_points: int,
    rng: np.random.Generator,
) -> Dict[str, np.ndarray]:
    """One shape -> fixed-size sample with globally-offset part labels and
    the category id (the seg head predicts all 50 parts; category
    conditions the valid slice — shapenetpart.py label layout)."""
    xyz, normals, seg = load_shapenetpart_file(path)
    name, offset = SHAPENETPART_CATEGORIES[synset]
    sel = rng.choice(len(xyz), num_points, replace=len(xyz) < num_points)
    # normalize into the unit sphere (pc_normalize)
    p = xyz[sel]
    p = p - p.mean(0)
    p = p / np.maximum(np.linalg.norm(p, axis=1).max(), 1e-6)
    cat_id = sorted(SHAPENETPART_CATEGORIES).index(synset)
    return {
        "points": p.astype(np.float32),
        "normals": normals[sel],
        "seg": seg[sel] + offset,
        "category": np.int64(cat_id),
        "category_name": name,
    }


# ---------------------------------------------------------------------------
# SemanticKITTI
# ---------------------------------------------------------------------------

# raw label id -> train id (the learning_map in semantic-kitti.yaml;
# openpoints/dataset/semantic_kitti pipeline). 0 = unlabeled/ignored.
SEMANTICKITTI_LEARNING_MAP = {
    0: 0, 1: 0, 10: 1, 11: 2, 13: 5, 15: 3, 16: 5, 18: 4, 20: 5, 30: 6,
    31: 7, 32: 8, 40: 9, 44: 10, 48: 11, 49: 12, 50: 13, 51: 14, 52: 0,
    60: 9, 70: 15, 71: 16, 72: 17, 80: 18, 81: 19, 99: 0, 252: 1, 253: 7,
    254: 6, 255: 8, 256: 5, 257: 5, 258: 4, 259: 5,
}
_SK_LUT = np.zeros(1 << 16, np.int64)
for _raw, _train in SEMANTICKITTI_LEARNING_MAP.items():
    _SK_LUT[_raw] = _train

SEMANTICKITTI_SPLITS = {
    "train": ("00", "01", "02", "03", "04", "05", "06", "07", "09", "10"),
    "valid": ("08",),
    "test": ("11", "12", "13", "14", "15", "16", "17", "18", "19", "20", "21"),
}


def read_semantickitti_scan(path: str) -> np.ndarray:
    """``velodyne/{frame}.bin``: float32 (x, y, z, remission) -> [N, 4]."""
    return np.fromfile(path, np.float32).reshape(-1, 4)


def read_semantickitti_label(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """``labels/{frame}.label``: uint32 per point — low 16 bits semantic
    id, high 16 bits instance id -> (train labels [N], instance [N]).
    Semantic ids pass through the learning_map (moving classes collapse
    onto their static counterparts)."""
    raw = np.fromfile(path, np.uint32)
    sem = (raw & 0xFFFF).astype(np.int64)
    inst = (raw >> 16).astype(np.int64)
    return _SK_LUT[sem], inst


def list_semantickitti_frames(root: str, split: str = "train") -> List[Tuple[str, str]]:
    """``{root}/sequences/{seq}/velodyne/*.bin`` -> [(scan, label or '')]
    for the split's sequences (test has no labels)."""
    out = []
    for seq in SEMANTICKITTI_SPLITS[split]:
        vdir = os.path.join(root, "sequences", seq, "velodyne")
        for scan in sorted(glob.glob(os.path.join(vdir, "*.bin"))):
            frame = os.path.splitext(os.path.basename(scan))[0]
            lab = os.path.join(root, "sequences", seq, "labels", f"{frame}.label")
            out.append((scan, lab if os.path.exists(lab) else ""))
    return out


# ---------------------------------------------------------------------------
# ScanNet v2 (preprocessed per-scene arrays)
# ---------------------------------------------------------------------------

# NYU40 id -> ScanNet-benchmark 20-class train id (-1 = ignored);
# the VALID_CLASS_IDS of the benchmark (openpoints scannet pipeline).
SCANNET20_VALID_NYU40 = (
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39,
)
_SN_LUT = np.full(41, -1, np.int64)
for _ti, _nyu in enumerate(SCANNET20_VALID_NYU40):
    _SN_LUT[_nyu] = _ti


def scannet_remap_labels(nyu40_labels: np.ndarray) -> np.ndarray:
    """NYU40 per-point labels -> 20-class train ids (-1 ignored)."""
    lab = np.asarray(nyu40_labels, np.int64)
    out = np.full(lab.shape, -1, np.int64)
    valid = (lab >= 0) & (lab < 41)
    out[valid] = _SN_LUT[lab[valid]]
    return out


def load_scannet_scene(path: str) -> Dict[str, np.ndarray]:
    """Per-scene ``.npz`` with coords [N, 3], colors [N, 3] (0-255),
    nyu40 labels [N] (the one-time preprocessing of the ply+aggregation
    files — scannet's raw zips stay offline). -> dict with train labels
    remapped."""
    z = np.load(path)
    coords = np.asarray(z["coords"], np.float32)
    colors = np.asarray(z["colors"], np.float32)
    labels = scannet_remap_labels(z["labels"]) if "labels" in z else None
    out = {"coords": coords, "colors": colors}
    if labels is not None:
        out["labels"] = labels
    return out


def scannet_block_sample(
    scene: Dict[str, np.ndarray],
    num_points: int,
    rng: np.random.Generator,
) -> Tuple[np.ndarray, np.ndarray]:
    """Whole-scene random subsample -> (feat [P, 6] xyz+rgb/255,
    labels [P]); ScanNet trains on scene chunks/subsamples rather than
    S3DIS-style 1 m blocks."""
    n = len(scene["coords"])
    sel = rng.choice(n, num_points, replace=n < num_points)
    feat = np.concatenate(
        [scene["coords"][sel], scene["colors"][sel] / 255.0], axis=1
    ).astype(np.float32)
    labels = scene.get("labels")
    lab = labels[sel] if labels is not None else np.full(num_points, -1, np.int64)
    return feat, lab
