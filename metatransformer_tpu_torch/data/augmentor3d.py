"""3D detection data augmentation: gt-database sampling + scene augments.

Port of ``metatransformer_tpu/data/augmentor3d.py``, line for line: host numpy, kept
as a copy of its own since importing anything of the reference's
package imports JAX.

Reference: ``AutonomousDriving/pcdet/datasets/augmentor/data_augmentor.py``
(:9-176 — the augmentor queue: gt_sampling, random_world_flip,
random_world_rotation, random_world_scaling) and
``augmentor/database_sampler.py`` (paste gt boxes from a database into
scenes with BEV collision tests).

Host-side numpy by design: augmentation runs in the input pipeline
(reference: dataloader workers), not on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# geometry helpers
# ---------------------------------------------------------------------------

def rotate_points_z(points: np.ndarray, angle: float) -> np.ndarray:
    """Rotate xyz(+extra) points around z by `angle` (radians)."""
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, -s], [s, c]], points.dtype)
    out = points.copy()
    out[:, :2] = points[:, :2] @ rot.T
    return out


def points_in_box(points: np.ndarray, box: np.ndarray) -> np.ndarray:
    """bool mask of points inside a 7-dof box (x,y,z,l,w,h,ry);
    z center convention = box center (pcdet)."""
    local = points[:, :3] - box[:3]
    c, s = np.cos(-box[6]), np.sin(-box[6])
    x = local[:, 0] * c - local[:, 1] * s
    y = local[:, 0] * s + local[:, 1] * c
    return (
        (np.abs(x) <= box[3] / 2)
        & (np.abs(y) <= box[4] / 2)
        & (np.abs(local[:, 2]) <= box[5] / 2)
    )


def _bev_corners(boxes: np.ndarray) -> np.ndarray:
    """[N, 7] -> BEV corners [N, 4, 2]."""
    n = boxes.shape[0]
    dx, dy = boxes[:, 3] / 2, boxes[:, 4] / 2
    corners = np.stack(
        [
            np.stack([dx, dy], -1), np.stack([dx, -dy], -1),
            np.stack([-dx, -dy], -1), np.stack([-dx, dy], -1),
        ],
        axis=1,
    )  # [N, 4, 2]
    c, s = np.cos(boxes[:, 6]), np.sin(boxes[:, 6])
    rot = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], axis=1)
    return np.einsum("nij,nkj->nki", rot, corners) + boxes[:, None, :2]


def boxes_bev_overlap(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Conservative BEV collision test via circumscribed circles +
    axis-aligned corner overlap — used only to REJECT sampled boxes, so a
    slightly-over-eager test is safe (database_sampler uses exact rotated
    IoU; the exact kernel lives in ops/iou3d for the model path)."""
    ca = _bev_corners(a)
    cb = _bev_corners(b)
    amin, amax = ca.min(1), ca.max(1)  # [N, 2]
    bmin, bmax = cb.min(1), cb.max(1)
    inter_x = np.minimum(amax[:, None, 0], bmax[None, :, 0]) - np.maximum(
        amin[:, None, 0], bmin[None, :, 0]
    )
    inter_y = np.minimum(amax[:, None, 1], bmax[None, :, 1]) - np.maximum(
        amin[:, None, 1], bmin[None, :, 1]
    )
    return (inter_x > 0) & (inter_y > 0)


# ---------------------------------------------------------------------------
# gt database
# ---------------------------------------------------------------------------

def build_gt_database(
    scenes: Sequence[Dict[str, np.ndarray]],
) -> Dict[str, List[Dict[str, np.ndarray]]]:
    """Crop every gt object's points out of its scene
    (pcdet's create_groundtruth_database). Scene dict: ``points [N, 3+F]``,
    ``gt_boxes [G, 7]``, ``gt_names [G]`` (str). -> {class: [entries]}
    where each entry has box-frame-local ``points`` and its ``box``."""
    db: Dict[str, List[Dict[str, np.ndarray]]] = {}
    for scene in scenes:
        for box, name in zip(scene["gt_boxes"], scene["gt_names"]):
            mask = points_in_box(scene["points"], box)
            pts = scene["points"][mask].copy()
            pts[:, :3] -= box[:3]  # store box-local
            db.setdefault(str(name), []).append(
                {"points": pts, "box": box.copy()}
            )
    return db


@dataclasses.dataclass
class GTSamplerConfig:
    sample_groups: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {"Car": 15, "Pedestrian": 10, "Cyclist": 10}
    )  # target counts per class (kitti_dataset.yaml SAMPLE_GROUPS)
    min_points: int = 5  # filter_by_min_points


def sample_gt_boxes(
    db: Dict[str, List[Dict[str, np.ndarray]]],
    points: np.ndarray,
    gt_boxes: np.ndarray,
    gt_names: np.ndarray,
    cfg: GTSamplerConfig,
    rng: np.random.Generator,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Paste database objects into the scene until each class reaches its
    target count, rejecting BEV collisions (database_sampler.__call__).
    Points inside pasted boxes are removed first (remove_points_in_boxes).
    -> (points, gt_boxes, gt_names)."""
    placed = gt_boxes.copy()
    new_points = [points]
    new_boxes, new_names = [], []
    for cls, target in cfg.sample_groups.items():
        entries = [
            e for e in db.get(cls, []) if e["points"].shape[0] >= cfg.min_points
        ]
        have = int(np.sum(gt_names == cls))
        need = max(0, target - have)
        if not entries or need == 0:
            continue
        order = rng.permutation(len(entries))
        taken = 0
        for i in order:
            if taken >= need:
                break
            entry = entries[i]
            box = entry["box"].copy()
            if placed.shape[0] and boxes_bev_overlap(
                box[None], placed
            ).any():
                continue
            placed = np.concatenate([placed, box[None]], 0)
            pts = entry["points"].copy()
            pts[:, :3] += box[:3]
            new_points.append(pts)
            new_boxes.append(box)
            new_names.append(cls)
            taken += 1
    if new_boxes:
        pasted = np.stack(new_boxes)
        keep = np.ones(points.shape[0], bool)
        for box in pasted:
            keep &= ~points_in_box(points, box)
        new_points[0] = points[keep]
        gt_boxes = np.concatenate([gt_boxes, pasted], 0)
        gt_names = np.concatenate([gt_names, np.asarray(new_names)], 0)
    return np.concatenate(new_points, 0), gt_boxes, gt_names


# ---------------------------------------------------------------------------
# world augmentations (data_augmentor.py random_world_* queue)
# ---------------------------------------------------------------------------

def random_world_flip(points, gt_boxes, rng, axis: str = "x"):
    """Flip along x (y -> -y) with p=0.5 (ALONG_AXIS_LIST: ['x'])."""
    if rng.random() < 0.5:
        points = points.copy()
        gt_boxes = gt_boxes.copy()
        if axis == "x":
            points[:, 1] = -points[:, 1]
            gt_boxes[:, 1] = -gt_boxes[:, 1]
            gt_boxes[:, 6] = -gt_boxes[:, 6]
        else:  # axis == 'y'
            points[:, 0] = -points[:, 0]
            gt_boxes[:, 0] = -gt_boxes[:, 0]
            gt_boxes[:, 6] = -(gt_boxes[:, 6] + np.pi)
    return points, gt_boxes


def random_world_rotation(points, gt_boxes, rng,
                          rot_range=(-np.pi / 4, np.pi / 4)):
    angle = rng.uniform(*rot_range)
    points = rotate_points_z(points, angle)
    gt_boxes = gt_boxes.copy()
    gt_boxes[:, :3] = rotate_points_z(gt_boxes[:, :3], angle)
    gt_boxes[:, 6] += angle
    return points, gt_boxes


def random_world_scaling(points, gt_boxes, rng, scale_range=(0.95, 1.05)):
    s = rng.uniform(*scale_range)
    points = points.copy()
    gt_boxes = gt_boxes.copy()
    points[:, :3] *= s
    gt_boxes[:, :6] *= s
    return points, gt_boxes


@dataclasses.dataclass
class Augmentor3DConfig:
    gt_sampling: Optional[GTSamplerConfig] = dataclasses.field(
        default_factory=GTSamplerConfig
    )
    flip: bool = True
    rotation: Tuple[float, float] = (-np.pi / 4, np.pi / 4)
    scaling: Tuple[float, float] = (0.95, 1.05)


def augment_scene(
    points: np.ndarray,
    gt_boxes: np.ndarray,
    gt_names: np.ndarray,
    cfg: Augmentor3DConfig,
    rng: np.random.Generator,
    db: Optional[Dict[str, List[Dict[str, np.ndarray]]]] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The full augmentor queue in the reference's order
    (data_augmentor.forward): gt_sampling -> flip -> rotation -> scaling."""
    if cfg.gt_sampling is not None and db is not None:
        points, gt_boxes, gt_names = sample_gt_boxes(
            db, points, gt_boxes, gt_names, cfg.gt_sampling, rng
        )
    if cfg.flip:
        points, gt_boxes = random_world_flip(points, gt_boxes, rng)
    points, gt_boxes = random_world_rotation(points, gt_boxes, rng, cfg.rotation)
    points, gt_boxes = random_world_scaling(points, gt_boxes, rng, cfg.scaling)
    return points, gt_boxes, gt_names
