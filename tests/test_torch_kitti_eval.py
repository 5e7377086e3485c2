"""The port's KITTI readers and evaluator (data/kitti_format.py,
data/kitti_eval.py) against the JAX package on the CPU.

Both packages read the same calib, label_2 and velodyne files, which the
test writes (cars, pedestrians and cyclists at the three difficulties,
plus DontCare): every field equal, the camera -> lidar boxes and back
equal. The rotated IoU matrices (BEV and 3D) within DET3D_IOU_TOL of the
reference's (the port's polygon clip rounds in another order). The AP_R40
table equal to the reference's where no IoU lies within DET3D_IOU_TOL of a
class threshold, and equal on predictions placed at the thresholds when
the reference's IoU matrix is handed to the port's matching.
"""

import os

import numpy as np
import pytest
import torch

from metatransformer_tpu.data import kitti_eval as jke
from metatransformer_tpu.data import kitti_format as jkf
from metatransformer_tpu_torch.data import kitti_eval as ke
from metatransformer_tpu_torch.data import kitti_format as kf

DET3D_IOU_TOL = 1e-4  # chip_smoke.py's bound on the rotated IoU between devices
CALIB = """P0: 7.070493e+02 0.0 6.040814e+02 0.0 0.0 7.070493e+02 1.805066e+02 0.0 0.0 0.0 1.0 0.0
P2: 7.070493e+02 0.000000e+00 6.040814e+02 4.575831e+01 0.000000e+00 7.070493e+02 1.805066e+02 -3.454157e-01 0.000000e+00 0.000000e+00 1.000000e+00 4.981016e-03
R0_rect: 9.999128e-01 1.009263e-02 -8.511932e-03 -1.012729e-02 9.999406e-01 -4.037671e-03 8.470675e-03 4.123522e-03 9.999556e-01
Tr_velo_to_cam: 6.927964e-03 -9.999722e-01 -2.757829e-03 -2.457729e-02 -1.162982e-03 2.749836e-03 -9.999955e-01 -6.127237e-02 9.999753e-01 6.931141e-03 -1.143899e-03 -3.321029e-01
Tr_imu_to_velo: 9.999976e-01 7.553071e-04 -2.035826e-03 -8.086759e-01
"""
# (class, truncation, occlusion, 2D box height): every difficulty, DontCare
OBJECTS = [("Car", 0.0, 0, 60.0), ("Car", 0.2, 1, 30.0), ("Car", 0.45, 2, 26.0),
           ("Pedestrian", 0.0, 0, 45.0), ("Pedestrian", 0.25, 1, 28.0),
           ("Cyclist", 0.1, 0, 50.0), ("Cyclist", 0.4, 2, 27.0), ("Car", 0.0, 0, 42.0),
           ("DontCare", -1.0, -1, 20.0)]
SIZES = {"Car": (1.5, 1.6, 3.9), "Pedestrian": (1.7, 0.6, 0.8), "Cyclist": (1.7, 0.6, 1.7),
         "DontCare": (-1.0, -1.0, -1.0)}


PAD = 24  # rows the reference's IoU is run at: more than a frame's boxes


@pytest.fixture(autouse=True)
def jax_iou_once(monkeypatch):
    """The reference's ``_iou_matrix`` at one shape, PAD x PAD: each pair's
    IoU is computed on its own, so rows of far-off unit boxes padded in
    change no entry, and the matrix is sliced back; one compile a metric
    where each class and frame's shape would compile anew."""
    iou = jke._iou_matrix
    far = np.asarray([[1e4, 1e4, 0, 1, 1, 1, 0]], np.float32)

    def padded(p, g, metric):
        n, m = len(p), len(g)
        if n == 0 or m == 0 or max(n, m) > PAD:
            return iou(p, g, metric)
        pp = np.concatenate([p, np.repeat(far, PAD - n, 0).astype(p.dtype)])
        gg = np.concatenate([g, np.repeat(far + 10, PAD - m, 0).astype(g.dtype)])
        return iou(pp, gg, metric)[:n, :m]

    monkeypatch.setattr(jke, "_iou_matrix", padded)


def write_frames(root, n_frames=4, n_points=2048, seed=0):
    """``n_frames`` KITTI frames under ``{root}/training``; -> their ids."""
    rng = np.random.default_rng(seed)
    ids = [f"{i:06d}" for i in range(n_frames)]
    for sub in ("velodyne", "calib", "label_2"):
        os.makedirs(os.path.join(root, "training", sub), exist_ok=True)
    for fid in ids:
        base = os.path.join(root, "training")
        pts = np.concatenate([rng.uniform([0, -40, -3], [70, 40, 1], (n_points, 3)),
                              rng.uniform(0, 1, (n_points, 1))], 1).astype(np.float32)
        pts.tofile(os.path.join(base, "velodyne", f"{fid}.bin"))
        with open(os.path.join(base, "calib", f"{fid}.txt"), "w") as f:
            f.write(CALIB)
        rows = []
        for j, (name, trunc, occ, height) in enumerate(OBJECTS):
            h, w, l = SIZES[name]
            x, y, z = rng.uniform(-15, 15), rng.uniform(1.2, 1.8), 5.0 + 5.0 * j
            if name == "DontCare":
                x = y = z = -1000.0
            top = rng.uniform(150, 200)
            rows.append(f"{name} {trunc:.2f} {occ} {rng.uniform(-3, 3):.2f} "
                        f"{rng.uniform(0, 1000):.2f} {top:.2f} {rng.uniform(0, 1000):.2f} "
                        f"{top + height:.2f} {h:.2f} {w:.2f} {l:.2f} {x:.2f} {y:.2f} {z:.2f} "
                        f"{rng.uniform(-3.1, 3.1):.2f}")
        with open(os.path.join(base, "label_2", f"{fid}.txt"), "w") as f:
            f.write("\n".join(rows) + "\n")
    return ids


def predictions(annotations, seed, jitter=0.15):
    """Per frame: each scored object's box jittered, extra false positives,
    some scores tied."""
    rng = np.random.default_rng(seed)
    out = []
    for ann in annotations:
        keep = ann.names != "DontCare"
        boxes, names = ann.boxes[keep], ann.names[keep]
        noise = rng.normal(0, jitter, boxes.shape) * [1, 1, 1, 0.3, 0.3, 0.3, 0.5]
        fp = boxes[:2] + [4.0, 3.0, 0, 0, 0, 0, 0.5]
        scores = np.round(rng.uniform(0.1, 1.0, len(boxes) + 2), 1)  # ties
        out.append({"boxes": np.concatenate([boxes + noise, fp]).astype(np.float32),
                    "scores": scores.astype(np.float32),
                    "names": np.concatenate([names, names[:2]])})
    return out


def _read(pkg, root, ids):
    return [pkg.read_frame(root, fid) for fid in ids]


def test_readers_and_box_transforms_equal_jax(tmp_path):
    ids = write_frames(str(tmp_path))
    for got, want in zip(_read(kf, str(tmp_path), ids), _read(jkf, str(tmp_path), ids)):
        assert got.frame_id == want.frame_id
        np.testing.assert_array_equal(got.points, want.points)
        assert got.points.dtype == np.float32 and got.points.shape == (2048, 4)
        for k in ("P2", "R0", "V2C", "C2V"):
            np.testing.assert_array_equal(getattr(got.calib, k), getattr(want.calib, k))
        assert got.label.keys() == want.label.keys()
        for k in got.label:
            np.testing.assert_array_equal(got.label[k], want.label[k])
        lidar = got.gt_boxes_lidar()
        assert lidar.dtype == np.float64
        np.testing.assert_array_equal(lidar, want.gt_boxes_lidar())
        back = kf.boxes_lidar_to_camera(lidar, got.calib)
        jback = jkf.boxes_lidar_to_camera(lidar, want.calib)
        for k in back:
            np.testing.assert_array_equal(back[k], jback[k])
        ann, jann = got.annotation(), want.annotation()
        assert isinstance(ann, ke.KittiAnnotation)
        for k in ("boxes", "names", "truncated", "occluded", "bbox_height"):
            np.testing.assert_array_equal(getattr(ann, k), getattr(jann, k))
        pix = got.calib.lidar_to_img(got.points[:16, :3].astype(np.float64))
        np.testing.assert_array_equal(pix, want.calib.lidar_to_img(
            want.points[:16, :3].astype(np.float64)))
    assert kf.parse_label("")["bbox"].shape == (0, 4)


@pytest.mark.parametrize("metric", ["bev", "3d"])
def test_iou_matrices_within_tol_of_jax(tmp_path, metric):
    ids = write_frames(str(tmp_path), n_frames=2)
    anns = [f.annotation() for f in _read(kf, str(tmp_path), ids)]
    for pred, ann in zip(predictions(anns, 1), anns):
        got = ke._iou_matrix(pred["boxes"], ann.boxes, metric, torch.device("cpu"))
        want = jke._iou_matrix(pred["boxes"], ann.boxes, metric)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert (want > 0.3).sum() >= 5
        np.testing.assert_allclose(got, want, rtol=0, atol=DET3D_IOU_TOL)


def _near_threshold(preds, anns):
    """How many IoUs of the reference lie within DET3D_IOU_TOL of their
    class threshold."""
    n = 0
    for pred, ann in zip(preds, anns):
        for metric in ("bev", "3d"):
            iou = jke._iou_matrix(pred["boxes"], ann.boxes, metric)
            thr = np.asarray([jke.CLASS_IOU_THR.get(c, 0.5) for c in pred["names"]])[:, None]
            n += int((np.abs(iou - thr) <= DET3D_IOU_TOL).sum())
    return n


def test_ap_table_equals_jax(tmp_path):
    ids = write_frames(str(tmp_path), n_frames=3)
    anns = [f.annotation() for f in _read(kf, str(tmp_path), ids)]
    preds = predictions(anns, 2)
    assert _near_threshold(preds, anns) == 0
    got = ke.evaluate(preds, anns, device="cpu")
    want = jke.evaluate(preds, anns)
    assert got == want
    assert 0 < min(v for v in want.values() if v > 0) and max(want.values()) > 0.3
    assert ke.ap_r40(preds, anns, "Car", 1, "bev", device="cpu") == want["Car_bev_moderate"]


def test_ap_table_equals_jax_at_the_thresholds_on_its_iou(tmp_path, monkeypatch):
    """Predictions moved along their heading until their BEV IoU with the
    ground truth reaches the class threshold (and just under it): with the
    reference's IoU matrix the port's matching and AP are the reference's."""
    ids = write_frames(str(tmp_path), n_frames=2)
    anns = [f.annotation() for f in _read(kf, str(tmp_path), ids)]
    preds = []
    for fi, ann in enumerate(anns):
        keep = ann.names != "DontCare"
        boxes, names = ann.boxes[keep].copy(), ann.names[keep]
        thr = np.asarray([jke.CLASS_IOU_THR[c] for c in names], np.float32)
        # an aligned box shifted by s of its length overlaps by (1 - s) / (1 + s)
        shift = (1 - thr) / (1 + thr) * boxes[:, 3] * (1.0 + 2e-5 * (fi - 0.5))
        boxes[:, 0] += shift * np.cos(boxes[:, 6])
        boxes[:, 1] += shift * np.sin(boxes[:, 6])
        preds.append({"boxes": boxes.astype(np.float32),
                      "scores": np.linspace(1, 0.2, len(boxes)).astype(np.float32),
                      "names": names})
    assert _near_threshold(preds, anns) > 0
    monkeypatch.setattr(ke, "_iou_matrix", lambda p, g, m, d: jke._iou_matrix(p, g, m))
    got = ke.evaluate(preds, anns, device="cpu")
    assert got == jke.evaluate(preds, anns)


def test_evaluate_takes_the_card_or_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ann = ke.KittiAnnotation(boxes=np.zeros((1, 7), np.float32), names=np.asarray(["Car"]))
    pred = {"boxes": np.zeros((1, 7), np.float32), "scores": np.ones(1, np.float32),
            "names": np.asarray(["Car"])}
    with pytest.raises(RuntimeError, match="CUDA"):
        ke.evaluate([pred], [ann])
