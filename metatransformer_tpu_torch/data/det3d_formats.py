"""Dataset format readers for the 3D-detection corpora: nuScenes table
JSONs, Waymo (pcdet-preprocessed layout), ONCE annotation JSONs, Lyft
info pickles, PandaSet sequence pickles.

Port of ``metatransformer_tpu/data/det3d_formats.py``, line for line: host numpy, kept
as a copy of its own since importing anything of the reference's
package imports JAX.

References:
* nuScenes — ``AutonomousDriving/pcdet/datasets/nuscenes/
  nuscenes_dataset.py`` + the devkit's table schema (relational JSON
  tables keyed by token: sample, sample_data, sample_annotation,
  ego_pose, calibrated_sensor, category). We read the tables directly
  (the devkit the reference shells out to is an external dep).
* Waymo — ``pcdet/datasets/waymo/waymo_dataset.py``: the raw TFRecords
  are preprocessed once into per-frame ``.npy`` point arrays + an info
  list with an ``annos`` dict; we read THAT layout (the proto decode is
  the one-time offline step, out of the serving path).
* ONCE — ``pcdet/datasets/once/once_dataset.py`` + devkit: per-sequence
  ``{seq_id}.json`` with ``frames[*].annos`` (names, boxes_3d [N, 7]),
  lidar ``.bin`` files (x, y, z, intensity rows like KITTI).
* Lyft — ``pcdet/datasets/lyft/lyft_dataset.py``: info pickles with
  ``lidar_path``/``sweeps``/``gt_boxes``/``gt_names``; 5-float lidar
  rows (x, y, z, intensity, ring) that may be TRUNCATED mid-row on
  disk; ego-point removal; kitti-style eval via a name collapse
  (lyft_dataset.kitti_eval map_name_to_kitti).
* PandaSet — ``pcdet/datasets/pandaset/pandaset_dataset.py``: per-frame
  pickled lidar tables in WORLD coordinates + a pose (position +
  heading quaternion); world -> ego via the inverse pose, then an axis
  swap into the normative frame (x forward, y left); cuboid yaws get
  the ego z-rotation added (`zrot_world_to_ego`).

All readers emit the native evaluators' frame records
(``nuscenes_eval.NuscFrame`` / ``waymo_eval.WaymoFrame``) so a raw
annotation tree drives ``evaluate`` end-to-end.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from metatransformer_tpu_torch.data.nuscenes_eval import NuscFrame
from metatransformer_tpu_torch.data.waymo_eval import WaymoFrame

# ---------------------------------------------------------------------------
# nuScenes
# ---------------------------------------------------------------------------

NUSC_TABLES = (
    "sample", "sample_data", "sample_annotation", "ego_pose",
    "calibrated_sensor", "category",
)

# detection-challenge class collapse (nuscenes_dataset map_name_from_general...)
NUSC_CLASS_MAP = {
    "vehicle.car": 0,
    "vehicle.truck": 1,
    "vehicle.bus.rigid": 2,
    "human.pedestrian.adult": 3,
    "vehicle.bicycle": 4,
}


def load_nusc_tables(root: str, version: str = "v1.0-mini") -> Dict[str, Dict]:
    """Each table JSON (a list of records) -> {token: record}."""
    out: Dict[str, Dict] = {}
    base = os.path.join(root, version)
    for name in NUSC_TABLES:
        with open(os.path.join(base, f"{name}.json")) as f:
            rows = json.load(f)
        out[name] = {r["token"]: r for r in rows}
    return out


def quaternion_yaw(q: Sequence[float]) -> float:
    """(w, x, y, z) -> yaw around +z (devkit quaternion_yaw: rotate the
    x-axis and take atan2 of its image)."""
    w, x, y, z = q
    # rotated x-axis components
    vx = 1.0 - 2.0 * (y * y + z * z)
    vy = 2.0 * (x * y + z * w)
    return float(np.arctan2(vy, vx))


def _quat_rot(q: Sequence[float]) -> np.ndarray:
    w, x, y, z = q
    return np.asarray(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


def nusc_sample_annotations(
    tables: Dict[str, Dict],
    sample_token: str,
    class_map: Optional[Dict[str, int]] = None,
) -> NuscFrame:
    """Ground-truth boxes of one keyframe in the GLOBAL frame -> NuscFrame
    (x, y, z, dx, dy, dz, yaw). nuScenes stores size as (w, l, h); the
    eval frame wants (dx=l, dy=w, dz=h)."""
    class_map = class_map or NUSC_CLASS_MAP
    boxes, labels, vels = [], [], []
    for ann in tables["sample_annotation"].values():
        if ann["sample_token"] != sample_token:
            continue
        cat = ann.get("category_name")
        if cat not in class_map:
            continue
        x, y, z = ann["translation"]
        w, l, h = ann["size"]
        yaw = quaternion_yaw(ann["rotation"])
        boxes.append([x, y, z, l, w, h, yaw])
        labels.append(class_map[cat])
        vels.append(ann.get("velocity", [0.0, 0.0])[:2])
    return NuscFrame(
        boxes=np.asarray(boxes, np.float64).reshape(-1, 7),
        labels=np.asarray(labels, np.int64),
        velocities=np.asarray(vels, np.float64).reshape(-1, 2),
    )


def nusc_global_to_lidar(
    tables: Dict[str, Dict], sample_data_token: str, frame: NuscFrame
) -> NuscFrame:
    """Global-frame boxes -> the lidar sensor frame of one sample_data:
    undo ego_pose, then calibrated_sensor (devkit Box.translate/rotate
    chain in nuscenes_dataset get_sample_data)."""
    sd = tables["sample_data"][sample_data_token]
    ego = tables["ego_pose"][sd["ego_pose_token"]]
    cal = tables["calibrated_sensor"][sd["calibrated_sensor_token"]]
    boxes = frame.boxes.copy()
    if len(boxes):
        for trans, rot in (
            (ego["translation"], ego["rotation"]),
            (cal["translation"], cal["rotation"]),
        ):
            r = _quat_rot(rot)
            boxes[:, :3] = (boxes[:, :3] - np.asarray(trans)) @ r
            boxes[:, 6] -= quaternion_yaw(rot)
    return NuscFrame(
        boxes=boxes, labels=frame.labels, scores=frame.scores,
        velocities=frame.velocities,
    )


def read_nusc_lidar(path: str) -> np.ndarray:
    """nuScenes .pcd.bin: float32 rows (x, y, z, intensity, ring) ->
    [N, 5]."""
    return np.fromfile(path, np.float32).reshape(-1, 5)


# ---------------------------------------------------------------------------
# Waymo (pcdet preprocessed layout)
# ---------------------------------------------------------------------------

WAYMO_CLASS_MAP = {"Vehicle": 0, "Pedestrian": 1, "Cyclist": 2}


def read_waymo_points(path: str) -> np.ndarray:
    """Per-frame ``{sequence}/{frame:04d}.npy``: [N, 6]
    (x, y, z, intensity, elongation, NLZ flag)."""
    pts = np.load(path)
    if pts.ndim != 2 or pts.shape[1] < 3:
        raise ValueError(f"bad waymo point array {pts.shape} in {path}")
    return pts


def load_waymo_infos(path: str) -> List[Dict]:
    """The ``*.pkl`` info list written by the one-time preprocessor
    (waymo_dataset.get_infos): each info has ``point_cloud`` (lidar
    sequence + sample idx) and ``annos``."""
    with open(path, "rb") as f:
        infos = pickle.load(f)
    if not isinstance(infos, list):
        raise ValueError("waymo info file must hold a list of frame infos")
    return infos


def waymo_info_to_frame(
    info: Dict, class_map: Optional[Dict[str, int]] = None
) -> WaymoFrame:
    """info["annos"] {name, gt_boxes_lidar [N, 7], num_points_in_gt} ->
    WaymoFrame for the native evaluator."""
    class_map = class_map or WAYMO_CLASS_MAP
    annos = info["annos"]
    names = np.asarray(annos["name"])
    keep = np.asarray([n in class_map for n in names], bool)
    boxes = np.asarray(annos["gt_boxes_lidar"], np.float64).reshape(-1, 7)[keep]
    labels = np.asarray([class_map[n] for n in names[keep]], np.int64)
    npts = annos.get("num_points_in_gt")
    return WaymoFrame(
        boxes=boxes,
        labels=labels,
        num_points=(np.asarray(npts)[keep] if npts is not None else None),
    )


# ---------------------------------------------------------------------------
# ONCE
# ---------------------------------------------------------------------------

ONCE_CLASS_MAP = {"Car": 0, "Truck": 0, "Bus": 0, "Pedestrian": 1,
                  "Cyclist": 2}  # superclass collapse (once eval)


def read_once_lidar(path: str) -> np.ndarray:
    """ONCE lidar_roof ``.bin``: float32 (x, y, z, intensity) rows."""
    return np.fromfile(path, np.float32).reshape(-1, 4)


def load_once_sequence(path: str) -> List[Dict]:
    """``{seq_id}.json`` -> frame dicts (frame_id, pose, annos?)."""
    with open(path) as f:
        seq = json.load(f)
    return seq["frames"]


def once_frame_annotations(
    frame: Dict, class_map: Optional[Dict[str, int]] = None
) -> WaymoFrame:
    """frame["annos"] {names, boxes_3d [N, 7]} -> eval frame (the ONCE
    evaluator shares the WaymoFrame record)."""
    class_map = class_map or ONCE_CLASS_MAP
    annos = frame.get("annos") or {"names": [], "boxes_3d": []}
    names = np.asarray(annos["names"])
    boxes = np.asarray(annos["boxes_3d"], np.float64).reshape(-1, 7)
    keep = np.asarray([n in class_map for n in names], bool)
    return WaymoFrame(
        boxes=boxes[keep],
        labels=np.asarray([class_map[n] for n in names[keep]], np.int64),
    )


# ---------------------------------------------------------------------------
# Lyft (nuScenes-schema SDK; pcdet reads preprocessed info pickles)
# ---------------------------------------------------------------------------

# lyft_dataset.kitti_eval map_name_to_kitti — everything else collapses
# to an ignore bucket the evaluator never scores
LYFT_TO_KITTI = {
    "car": "Car",
    "pedestrian": "Pedestrian",
    "truck": "Truck",
    "bicycle": "Cyclist",
    "motorcycle": "Cyclist",
}


def read_lyft_lidar(path: str, remove_ego: bool = True) -> np.ndarray:
    """Lyft ``.bin``: float32 (x, y, z, intensity, ring) rows -> [N, 4].

    Some released files are truncated mid-row; drop the ragged tail like
    lyft_dataset.get_lidar_with_sweeps does, then strip ego returns
    (|x| < 1.5, |y| < 1.0)."""
    raw = np.fromfile(path, np.float32)
    raw = raw[: raw.size - raw.size % 5].reshape(-1, 5)[:, :4]
    return remove_ego_points(raw) if remove_ego else raw


def remove_ego_points(points: np.ndarray, center_radius: float = 1.0
                      ) -> np.ndarray:
    """Drop returns off the ego vehicle body (lyft_dataset.remove_ego_points)."""
    keep = ~((np.abs(points[:, 0]) < center_radius * 1.5)
             & (np.abs(points[:, 1]) < center_radius))
    return points[keep]


def load_lyft_infos(path: str) -> List[Dict]:
    """Info pickle list: each record has ``lidar_path``, ``token``,
    ``sweeps`` [{lidar_path, transform_matrix, time_lag}], and (train)
    ``gt_boxes`` [G, 7] lidar + ``gt_names``."""
    with open(path, "rb") as f:
        infos = pickle.load(f)
    if not isinstance(infos, list):
        raise ValueError("lyft info file must hold a list of frame infos")
    return infos


def lyft_points_with_sweeps(
    root: str, info: Dict, max_sweeps: int = 1
) -> np.ndarray:
    """Key-frame points + up to ``max_sweeps - 1`` motion-compensated
    sweeps, each tagged with its time lag -> [N, 5] (x, y, z, i, dt).

    Deterministic (first sweeps in info order) where the reference
    random-samples — reproducibility over shuffle-in-the-loader."""
    pts = read_lyft_lidar(os.path.join(root, info["lidar_path"]))
    chunks = [np.concatenate([pts, np.zeros((len(pts), 1), np.float32)], 1)]
    for sweep in info.get("sweeps", [])[: max(0, max_sweeps - 1)]:
        sp = read_lyft_lidar(os.path.join(root, sweep["lidar_path"]))
        tm = sweep.get("transform_matrix")
        if tm is not None:
            tm = np.asarray(tm, np.float64)
            sp[:, :3] = (sp[:, :3] @ tm[:3, :3].T + tm[:3, 3]).astype(np.float32)
        dt = np.full((len(sp), 1), sweep.get("time_lag", 0.0), np.float32)
        chunks.append(np.concatenate([sp, dt], 1))
    return np.concatenate(chunks, 0)


def lyft_info_to_kitti_annotation(info: Dict) -> "kitti_eval.KittiAnnotation":
    """gt_boxes (lidar [G, 7+]) + gt_names -> the native KITTI evaluator's
    record with the lyft->kitti class collapse. Unmapped names keep a
    sentinel class the evaluator never scores (reference uses
    'Person_sitting' for the same effect)."""
    from metatransformer_tpu_torch.data import kitti_eval

    boxes = np.asarray(info.get("gt_boxes", np.zeros((0, 7))), np.float64)
    boxes = boxes[:, :7].reshape(-1, 7)
    names = [LYFT_TO_KITTI.get(str(n), "DontCare")
             for n in np.asarray(info.get("gt_names", []))]
    return kitti_eval.KittiAnnotation(boxes=boxes, names=np.asarray(names))


# ---------------------------------------------------------------------------
# PandaSet
# ---------------------------------------------------------------------------


def _pose_rt(pose: Dict) -> Tuple[np.ndarray, np.ndarray]:
    """pose {'position': {x,y,z}, 'heading': {w,x,y,z}} -> (R, t) of the
    ego->world transform (the SDK pose convention)."""
    p, h = pose["position"], pose["heading"]
    r = _quat_rot([h["w"], h["x"], h["y"], h["z"]])
    t = np.asarray([p["x"], p["y"], p["z"]], np.float64)
    return r, t


def pandaset_world_to_ego(points: np.ndarray, pose: Dict) -> np.ndarray:
    """World xyz -> ego frame: R^T (p - t) (SDK lidar_points_to_ego)."""
    r, t = _pose_rt(pose)
    return (np.asarray(points, np.float64) - t) @ r


def pandaset_ego_to_world(points: np.ndarray, pose: Dict) -> np.ndarray:
    r, t = _pose_rt(pose)
    return np.asarray(points, np.float64) @ r.T + t


def pandaset_zrot_world_to_ego(pose: Dict) -> float:
    """Yaw of the world y-axis in the ego frame; added to cuboid world
    yaws to express them in ego coordinates (pandaset_dataset
    _get_annotations, small-pitch assumption)."""
    pts = pandaset_world_to_ego(np.asarray([[0.0, 0, 0], [0, 1.0, 0]]), pose)
    yaxis = pts[1] - pts[0]
    return float(np.arctan2(-yaxis[0], yaxis[1]))


def _table_columns(obj, cols: Sequence[str]) -> List[np.ndarray]:
    """Pull named columns from a pickled table: pandas DataFrame or a
    plain dict of arrays (our fixture format; no pandas required)."""
    if hasattr(obj, "columns"):  # DataFrame duck-type
        return [np.asarray(obj[c]) for c in cols]
    return [np.asarray(obj[c]) for c in cols]


def read_pandaset_lidar(path: str, pose: Dict, device: int = 0) -> np.ndarray:
    """Pickled lidar table (world frame; columns x, y, z, i, d) ->
    normative ego [N, 4]: world->ego, swap to x-forward / y-left,
    intensity / 255."""
    with open(path, "rb") as f:
        table = pickle.load(f)
    x, y, z, i, d = _table_columns(table, ["x", "y", "z", "i", "d"])
    if device != -1:
        keep = d == device
        x, y, z, i = x[keep], y[keep], z[keep], i[keep]
    ego = pandaset_world_to_ego(np.stack([x, y, z], 1), pose)
    ego = ego[:, [1, 0, 2]]
    ego[:, 1] = -ego[:, 1]
    out = np.concatenate([ego, (i / 255.0)[:, None]], 1)
    return out.astype(np.float32)


def read_pandaset_cuboids(
    path: str, pose: Dict, device: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Pickled cuboid table -> (boxes [G, 7] normative ego, labels [G]).

    Columns follow the SDK: position.{x,y,z}, dimensions.{x,y,z}, yaw
    (world), label, cuboids.sensor_id. dims swap x<->y with the axis
    swap; yaw gets zrot_world_to_ego added."""
    with open(path, "rb") as f:
        table = pickle.load(f)
    cols = ["position.x", "position.y", "position.z", "dimensions.x",
            "dimensions.y", "dimensions.z", "yaw"]
    xs, ys, zs, dxs, dys, dzs, yaws = _table_columns(table, cols)
    labels = _table_columns(table, ["label"])[0]
    if device != -1 and ("cuboids.sensor_id" in getattr(table, "columns", table)):
        sid = _table_columns(table, ["cuboids.sensor_id"])[0]
        keep = sid != (1 - device)
        xs, ys, zs = xs[keep], ys[keep], zs[keep]
        dxs, dys, dzs = dxs[keep], dys[keep], dzs[keep]
        yaws, labels = yaws[keep], labels[keep]
    centers = pandaset_world_to_ego(np.stack([xs, ys, zs], 1), pose)
    zrot = pandaset_zrot_world_to_ego(pose)
    boxes = np.stack(
        [centers[:, 1], -centers[:, 0], centers[:, 2],
         dys, dxs, dzs, yaws + zrot], 1)
    return boxes.astype(np.float32), np.asarray(labels)
