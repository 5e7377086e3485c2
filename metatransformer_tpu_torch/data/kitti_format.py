"""KITTI raw-format readers: calib, label_2, velodyne bins + the camera
<-> lidar transform chain.

Port of ``metatransformer_tpu/data/kitti_format.py``, line for line: host numpy, kept
as a copy of its own since importing anything of the reference's
package imports JAX.

Reference: ``AutonomousDriving/pcdet/datasets/kitti/kitti_dataset.py``
(get_calib/get_label/get_lidar), ``kitti/kitti_utils.py`` and pcdet's
calibration object (P2 / R0_rect / Tr_velo_to_cam chain;
``kitti_dataset.py`` boxes3d_kitti_camera_to_lidar conversion).

Host-side numpy (IO + light math, SURVEY.md §3.5's worker boundary); the
output feeds the detectors and the native ``kitti_eval`` metrics
directly:

    frame = read_frame(root, "000123")
    preds = detector.predict(...)            # lidar-frame boxes
    kitti_eval.evaluate([preds], [frame.annotation()])
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np

from metatransformer_tpu_torch.data import kitti_eval

# label_2 columns (readme of the KITTI object devkit):
# type truncated occluded alpha bbox(4) dimensions(h w l) location(x y z) ry
LABEL_FIELDS = (
    "name", "truncated", "occluded", "alpha", "bbox", "dimensions",
    "location", "rotation_y",
)


@dataclasses.dataclass
class KittiCalib:
    """P2 (rect cam 2 projection), R0_rect, Tr_velo_to_cam."""

    P2: np.ndarray  # [3, 4]
    R0: np.ndarray  # [3, 3]
    V2C: np.ndarray  # [3, 4] velodyne -> cam reference

    # -- transform chain (pcdet calibration_kitti semantics) --------------

    @property
    def C2V(self) -> np.ndarray:
        """cam reference -> velodyne [3, 4] (rigid inverse)."""
        r, t = self.V2C[:, :3], self.V2C[:, 3]
        return np.hstack([r.T, (-r.T @ t)[:, None]])

    def lidar_to_rect(self, pts: np.ndarray) -> np.ndarray:
        """[N, 3] velodyne -> rectified camera coords."""
        hom = np.hstack([pts, np.ones((len(pts), 1), pts.dtype)])
        return (self.R0 @ (self.V2C @ hom.T)).T

    def rect_to_lidar(self, pts: np.ndarray) -> np.ndarray:
        """[N, 3] rectified camera -> velodyne coords."""
        ref = (np.linalg.inv(self.R0) @ pts.T).T
        hom = np.hstack([ref, np.ones((len(ref), 1), ref.dtype)])
        return (self.C2V @ hom.T).T

    def rect_to_img(self, pts: np.ndarray) -> np.ndarray:
        """[N, 3] rect -> [N, 2] pixel coords (+ depth column dropped)."""
        hom = np.hstack([pts, np.ones((len(pts), 1), pts.dtype)])
        uvw = (self.P2 @ hom.T).T
        return uvw[:, :2] / np.maximum(uvw[:, 2:3], 1e-6)

    def lidar_to_img(self, pts: np.ndarray) -> np.ndarray:
        return self.rect_to_img(self.lidar_to_rect(pts))


def parse_calib(text: str) -> KittiCalib:
    """Parse a KITTI calib file body (``P2: <12>``, ``R0_rect: <9>``,
    ``Tr_velo_to_cam: <12>``)."""
    vals: Dict[str, np.ndarray] = {}
    for line in text.splitlines():
        if ":" not in line:
            continue
        key, rest = line.split(":", 1)
        try:
            vals[key.strip()] = np.asarray(
                [float(x) for x in rest.split()], np.float64
            )
        except ValueError:
            continue
    return KittiCalib(
        P2=vals["P2"].reshape(3, 4),
        R0=vals["R0_rect"].reshape(3, 3),
        V2C=vals["Tr_velo_to_cam"].reshape(3, 4),
    )


def read_calib(path: str) -> KittiCalib:
    with open(path) as f:
        return parse_calib(f.read())


def parse_label(text: str) -> Dict[str, np.ndarray]:
    """Parse a label_2 file body -> dict of per-object arrays.

    dimensions are (h, w, l), location is the BOTTOM-center in rect camera
    coords, rotation_y is the camera-frame yaw (devkit layout; pcdet
    ``object3d_kitti``)."""
    rows = [l.split() for l in text.splitlines() if l.strip()]
    names = np.asarray([r[0] for r in rows])
    f = lambda i: np.asarray([float(r[i]) for r in rows], np.float64)
    return {
        "name": names,
        "truncated": f(1),
        "occluded": np.asarray([int(float(r[2])) for r in rows], np.int64),
        "alpha": f(3),
        "bbox": np.stack([f(4), f(5), f(6), f(7)], 1) if rows else np.zeros((0, 4)),
        "dimensions": np.stack([f(8), f(9), f(10)], 1) if rows else np.zeros((0, 3)),
        "location": np.stack([f(11), f(12), f(13)], 1) if rows else np.zeros((0, 3)),
        "rotation_y": f(14) if rows else np.zeros((0,)),
    }


def read_label(path: str) -> Dict[str, np.ndarray]:
    with open(path) as f:
        return parse_label(f.read())


def read_velodyne(path: str) -> np.ndarray:
    """.bin -> [N, 4] (x, y, z, intensity)."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)


def boxes_camera_to_lidar(
    label: Dict[str, np.ndarray], calib: KittiCalib
) -> np.ndarray:
    """label (rect-camera, bottom-center, hwl, ry) -> lidar boxes
    [G, 7] (x, y, z CENTER, l, w, h, heading); heading = -(ry + pi/2)
    (pcdet boxes3d_kitti_camera_to_lidar)."""
    h = label["dimensions"][:, 0]
    w = label["dimensions"][:, 1]
    l = label["dimensions"][:, 2]
    loc = label["location"]
    if len(loc) == 0:
        return np.zeros((0, 7))
    xyz = calib.rect_to_lidar(loc)
    xyz[:, 2] += h / 2.0  # bottom-center -> geometric center
    heading = -(label["rotation_y"] + np.pi / 2.0)
    # wrap to (-pi, pi]
    heading = np.arctan2(np.sin(heading), np.cos(heading))
    return np.stack(
        [xyz[:, 0], xyz[:, 1], xyz[:, 2], l, w, h, heading], 1
    )


def boxes_lidar_to_camera(
    boxes: np.ndarray, calib: KittiCalib
) -> Dict[str, np.ndarray]:
    """lidar [G, 7] center boxes -> rect-camera label fields (the inverse
    path, used when writing KITTI-format results)."""
    if len(boxes) == 0:
        return {
            "location": np.zeros((0, 3)),
            "dimensions": np.zeros((0, 3)),
            "rotation_y": np.zeros((0,)),
        }
    xyz = boxes[:, :3].copy()
    l, w, h = boxes[:, 3], boxes[:, 4], boxes[:, 5]
    xyz[:, 2] -= h / 2.0  # center -> bottom-center
    loc = calib.lidar_to_rect(xyz)
    ry = -boxes[:, 6] - np.pi / 2.0
    ry = np.arctan2(np.sin(ry), np.cos(ry))
    return {
        "location": loc,
        "dimensions": np.stack([h, w, l], 1),
        "rotation_y": ry,
    }


@dataclasses.dataclass
class KittiFrame:
    frame_id: str
    points: np.ndarray  # [N, 4] lidar
    calib: KittiCalib
    label: Optional[Dict[str, np.ndarray]] = None  # raw camera-frame fields

    def gt_boxes_lidar(self) -> np.ndarray:
        return boxes_camera_to_lidar(self.label, self.calib)

    def annotation(self) -> kitti_eval.KittiAnnotation:
        """-> the native evaluator's annotation record (kitti_eval)."""
        lab = self.label
        bbox_h = lab["bbox"][:, 3] - lab["bbox"][:, 1]
        return kitti_eval.KittiAnnotation(
            boxes=self.gt_boxes_lidar().astype(np.float32),
            names=lab["name"],
            truncated=lab["truncated"],
            occluded=lab["occluded"],
            bbox_height=bbox_h,
        )


def read_frame(root: str, frame_id: str, split: str = "training") -> KittiFrame:
    """Standard KITTI object layout:
    ``{root}/{split}/{velodyne,calib,label_2}/{frame_id}.{bin,txt}``."""
    base = os.path.join(root, split)
    calib = read_calib(os.path.join(base, "calib", f"{frame_id}.txt"))
    pts = read_velodyne(os.path.join(base, "velodyne", f"{frame_id}.bin"))
    label_path = os.path.join(base, "label_2", f"{frame_id}.txt")
    label = read_label(label_path) if os.path.exists(label_path) else None
    return KittiFrame(frame_id, pts, calib, label)
