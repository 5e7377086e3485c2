"""The port's 3D augmentor (data/augmentor3d.py) against the JAX
package's: host numpy on a ``np.random.Generator`` on both sides, so the
same generator state gives the same arrays, bit for bit, and leaves the
generators in the same state.
"""

import numpy as np
import pytest

from metatransformer_tpu.data import augmentor3d as jaug
from metatransformer_tpu_torch.data import augmentor3d as aug


def scene(rng, n_points=600, classes=("Car", "Pedestrian", "Cyclist")):
    boxes, names = [], []
    for i, cls in enumerate(classes * 2):
        size = {"Car": (3.9, 1.6, 1.5), "Pedestrian": (0.8, 0.6, 1.7),
                "Cyclist": (1.7, 0.6, 1.7)}[cls]
        boxes.append([6.0 * i - 15, rng.uniform(-10, 10), -1.0, *size, rng.uniform(-3, 3)])
        names.append(cls)
    boxes = np.asarray(boxes, np.float32)
    pts = [np.concatenate([rng.uniform(-20, 20, (n_points, 2)), rng.uniform(-2, 0, (n_points, 1)),
                           rng.uniform(0, 1, (n_points, 1))], 1)]
    for b in boxes:  # points inside every box
        local = rng.uniform(-0.4, 0.4, (20, 3)) * b[3:6]
        pts.append(np.concatenate([local + b[:3], rng.uniform(0, 1, (20, 1))], 1))
    return {"points": np.concatenate(pts).astype(np.float32), "gt_boxes": boxes,
            "gt_names": np.asarray(names)}


def _equal(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_geometry_helpers_equal_jax():
    rng = np.random.default_rng(0)
    s = scene(rng)
    _equal([aug.rotate_points_z(s["points"], 0.3)], [jaug.rotate_points_z(s["points"], 0.3)])
    for box in s["gt_boxes"]:
        _equal([aug.points_in_box(s["points"], box)], [jaug.points_in_box(s["points"], box)])
    _equal([aug.boxes_bev_overlap(s["gt_boxes"], s["gt_boxes"])],
           [jaug.boxes_bev_overlap(s["gt_boxes"], s["gt_boxes"])])


@pytest.mark.parametrize("seed", [0, 1])
def test_augment_scene_equals_jax_on_one_generator_state(seed):
    rng = np.random.default_rng(100)
    scenes = [scene(rng) for _ in range(3)]
    db, jdb = aug.build_gt_database(scenes), jaug.build_gt_database(scenes)
    assert db.keys() == jdb.keys()
    for cls in db:
        for e, je in zip(db[cls], jdb[cls]):
            _equal([e["points"], e["box"]], [je["points"], je["box"]])
    target = scene(np.random.default_rng(7), classes=("Car",))
    cfg = aug.Augmentor3DConfig(gt_sampling=aug.GTSamplerConfig(
        sample_groups={"Car": 6, "Pedestrian": 4, "Cyclist": 4}, min_points=5))
    jcfg = jaug.Augmentor3DConfig(gt_sampling=jaug.GTSamplerConfig(
        sample_groups={"Car": 6, "Pedestrian": 4, "Cyclist": 4}, min_points=5))
    g, jg = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(3):
        got = aug.augment_scene(target["points"], target["gt_boxes"], target["gt_names"], cfg,
                                g, db)
        want = jaug.augment_scene(target["points"], target["gt_boxes"], target["gt_names"], jcfg,
                                  jg, jdb)
        _equal(got, want)
        assert len(want[1]) > len(target["gt_boxes"])  # boxes were pasted
    assert g.random() == jg.random()
    for fn, jfn in ((aug.random_world_flip, jaug.random_world_flip),
                    (aug.random_world_rotation, jaug.random_world_rotation),
                    (aug.random_world_scaling, jaug.random_world_scaling)):
        _equal(fn(target["points"], target["gt_boxes"], g),
               jfn(target["points"], target["gt_boxes"], jg))
    _equal(aug.random_world_flip(target["points"], target["gt_boxes"], g, "y"),
           jaug.random_world_flip(target["points"], target["gt_boxes"], jg, "y"))
