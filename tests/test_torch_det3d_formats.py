"""The port's 3D dataset readers (data/det3d_formats.py) against the JAX
package's on fixtures that the test writes: nuScenes table JSONs and a
lidar file, Waymo point arrays and an info pickle, an ONCE sequence JSON
and lidar file, Lyft bins (one cut mid-row) with sweeps and an info
pickle, a PandaSet lidar and cuboid table pickled as a dict of arrays (no
pandas). Host numpy on both sides: every result exactly the reference's.
"""

import json
import os
import pickle

import numpy as np

from metatransformer_tpu.data import det3d_formats as jfmt
from metatransformer_tpu_torch.data import det3d_formats as fmt
from metatransformer_tpu_torch.data import kitti_eval, nuscenes_eval, waymo_eval


def _quat(rng):
    q = rng.standard_normal(4)
    return (q / np.linalg.norm(q)).tolist()


def _same(a, b):
    """Two frame records (or arrays) equal field by field."""
    if isinstance(a, np.ndarray) or np.isscalar(a):
        np.testing.assert_array_equal(a, b)
        return
    for k in vars(b):
        x, y = getattr(a, k), getattr(b, k)
        assert (x is None) == (y is None), k
        if y is not None:
            assert np.asarray(x).dtype == np.asarray(y).dtype, k
            np.testing.assert_array_equal(x, y, err_msg=k)


def test_nuscenes_tables_equal_jax(tmp_path):
    rng = np.random.default_rng(0)
    base = os.path.join(tmp_path, "v1.0-mini")
    os.makedirs(base)
    cats = list(fmt.NUSC_CLASS_MAP) + ["movable_object.barrier"]
    tables = {
        "sample": [{"token": f"s{i}"} for i in range(2)],
        "ego_pose": [{"token": "e0", "translation": rng.uniform(-50, 50, 3).tolist(),
                      "rotation": _quat(rng)}],
        "calibrated_sensor": [{"token": "c0", "translation": [0.9, 0.0, 1.8],
                               "rotation": _quat(rng)}],
        "sample_data": [{"token": "sd0", "ego_pose_token": "e0",
                         "calibrated_sensor_token": "c0"}],
        "category": [{"token": f"cat{i}", "name": c} for i, c in enumerate(cats)],
        "sample_annotation": [
            {"token": f"a{i}", "sample_token": f"s{i % 2}", "category_name": cats[i % len(cats)],
             "translation": rng.uniform(-40, 40, 3).tolist(),
             "size": rng.uniform(0.5, 5, 3).tolist(), "rotation": _quat(rng),
             **({"velocity": rng.normal(0, 3, 3).tolist()} if i % 3 else {})}
            for i in range(14)],
    }
    for name, rows in tables.items():
        with open(os.path.join(base, f"{name}.json"), "w") as f:
            json.dump(rows, f)
    got, want = fmt.load_nusc_tables(str(tmp_path)), jfmt.load_nusc_tables(str(tmp_path))
    assert got == want
    for token in ("s0", "s1"):
        frame = fmt.nusc_sample_annotations(got, token)
        jframe = jfmt.nusc_sample_annotations(want, token)
        assert isinstance(frame, nuscenes_eval.NuscFrame) and len(frame.labels) > 0
        _same(frame, jframe)
        _same(fmt.nusc_global_to_lidar(got, "sd0", frame),
              jfmt.nusc_global_to_lidar(want, "sd0", jframe))
    for q in ([1, 0, 0, 0], _quat(rng)):
        assert fmt.quaternion_yaw(q) == jfmt.quaternion_yaw(q)
    path = os.path.join(tmp_path, "lidar.pcd.bin")
    rng.standard_normal(5 * 40).astype(np.float32).tofile(path)
    _same(fmt.read_nusc_lidar(path), jfmt.read_nusc_lidar(path))


def test_waymo_and_once_equal_jax(tmp_path):
    rng = np.random.default_rng(1)
    path = os.path.join(tmp_path, "0000.npy")
    np.save(path, rng.standard_normal((64, 6)).astype(np.float32))
    _same(fmt.read_waymo_points(path), jfmt.read_waymo_points(path))
    names = np.asarray(["Vehicle", "Sign", "Pedestrian", "Cyclist", "Vehicle"])
    infos = [{"point_cloud": {"lidar_sequence": "seq", "sample_idx": i},
              "annos": {"name": names, "gt_boxes_lidar": rng.standard_normal((5, 7)),
                        **({"num_points_in_gt": rng.integers(0, 20, 5)} if i else {})}}
             for i in range(2)]
    info_path = os.path.join(tmp_path, "infos.pkl")
    with open(info_path, "wb") as f:
        pickle.dump(infos, f)
    got, want = fmt.load_waymo_infos(info_path), jfmt.load_waymo_infos(info_path)
    for a, b in zip(got, want):
        frame = fmt.waymo_info_to_frame(a)
        assert isinstance(frame, waymo_eval.WaymoFrame)
        _same(frame, jfmt.waymo_info_to_frame(b))

    seq = {"frames": [{"frame_id": "1", "pose": [0] * 7,
                       "annos": {"names": ["Car", "Bus", "Pedestrian", "Cone", "Cyclist"],
                                 "boxes_3d": rng.standard_normal((5, 7)).tolist()}},
                      {"frame_id": "2", "pose": [0] * 7}]}
    seq_path = os.path.join(tmp_path, "000076.json")
    with open(seq_path, "w") as f:
        json.dump(seq, f)
    frames, jframes = fmt.load_once_sequence(seq_path), jfmt.load_once_sequence(seq_path)
    assert frames == jframes
    for a, b in zip(frames, jframes):
        _same(fmt.once_frame_annotations(a), jfmt.once_frame_annotations(b))
    lidar = os.path.join(tmp_path, "1.bin")
    rng.standard_normal(4 * 32).astype(np.float32).tofile(lidar)
    _same(fmt.read_once_lidar(lidar), jfmt.read_once_lidar(lidar))


def test_lyft_equals_jax(tmp_path):
    rng = np.random.default_rng(2)
    for name, n in (("key.bin", 5 * 60 + 3), ("sweep1.bin", 5 * 40), ("sweep2.bin", 5 * 30)):
        pts = rng.uniform(-4, 4, n).astype(np.float32)  # key.bin cut mid-row; ego returns
        pts.tofile(os.path.join(tmp_path, name))
    info = {"lidar_path": "key.bin", "token": "t0",
            "sweeps": [{"lidar_path": "sweep1.bin", "time_lag": 0.05,
                        "transform_matrix": np.eye(4) + np.pad(rng.normal(0, 0.1, (3, 4)),
                                                               ((0, 1), (0, 0)))},
                       {"lidar_path": "sweep2.bin", "time_lag": 0.1}],
            "gt_boxes": rng.standard_normal((4, 9)),
            "gt_names": np.asarray(["car", "bicycle", "emergency_vehicle", "pedestrian"])}
    info_path = os.path.join(tmp_path, "lyft.pkl")
    with open(info_path, "wb") as f:
        pickle.dump([info], f)
    got, want = fmt.load_lyft_infos(info_path)[0], jfmt.load_lyft_infos(info_path)[0]
    key = os.path.join(tmp_path, "key.bin")
    for ego in (True, False):
        _same(fmt.read_lyft_lidar(key, ego), jfmt.read_lyft_lidar(key, ego))
    assert len(fmt.read_lyft_lidar(key)) < len(fmt.read_lyft_lidar(key, False))
    for sweeps in (1, 2, 3):
        _same(fmt.lyft_points_with_sweeps(str(tmp_path), got, sweeps),
              jfmt.lyft_points_with_sweeps(str(tmp_path), want, sweeps))
    ann = fmt.lyft_info_to_kitti_annotation(got)
    assert isinstance(ann, kitti_eval.KittiAnnotation)
    _same(ann, jfmt.lyft_info_to_kitti_annotation(want))


def test_pandaset_equals_jax(tmp_path):
    rng = np.random.default_rng(3)
    h = _quat(rng)
    pose = {"position": dict(zip("xyz", rng.uniform(-100, 100, 3))),
            "heading": dict(zip("wxyz", h))}
    n = 80
    lidar = {k: rng.uniform(-30, 30, n) for k in "xyz"}
    lidar.update(i=rng.uniform(0, 255, n), d=rng.integers(0, 2, n))
    cuboids = {**{f"position.{k}": rng.uniform(-30, 30, 6) for k in "xyz"},
               **{f"dimensions.{k}": rng.uniform(0.5, 5, 6) for k in "xyz"},
               "yaw": rng.uniform(-3, 3, 6), "label": np.asarray(["Car", "Bus"] * 3),
               "cuboids.sensor_id": np.asarray([0, 1, -1, 0, 1, -1])}
    paths = {}
    for name, table in (("lidar", lidar), ("cuboids", cuboids)):
        paths[name] = os.path.join(tmp_path, f"{name}.pkl")
        with open(paths[name], "wb") as f:
            pickle.dump(table, f)
    pts = rng.standard_normal((10, 3))
    _same(fmt.pandaset_world_to_ego(pts, pose), jfmt.pandaset_world_to_ego(pts, pose))
    _same(fmt.pandaset_ego_to_world(pts, pose), jfmt.pandaset_ego_to_world(pts, pose))
    assert fmt.pandaset_zrot_world_to_ego(pose) == jfmt.pandaset_zrot_world_to_ego(pose)
    for device in (0, 1, -1):
        _same(fmt.read_pandaset_lidar(paths["lidar"], pose, device),
              jfmt.read_pandaset_lidar(paths["lidar"], pose, device))
        for a, b in zip(fmt.read_pandaset_cuboids(paths["cuboids"], pose, device),
                        jfmt.read_pandaset_cuboids(paths["cuboids"], pose, device)):
            _same(a, b)
