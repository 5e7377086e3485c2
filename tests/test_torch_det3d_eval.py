"""The port's Waymo, nuScenes and ONCE metrics and its weighted box fusion
(data/waymo_eval.py, data/nuscenes_eval.py, data/once_eval.py,
ops/box_fusion.py) against the JAX package's on the same frames: host
numpy on both sides, so every result is exactly the reference's.
"""

import numpy as np
import pytest

from metatransformer_tpu.data import nuscenes_eval as jnusc
from metatransformer_tpu.data import once_eval as jonce
from metatransformer_tpu.data import waymo_eval as jwaymo
from metatransformer_tpu.ops import box_fusion as jfusion
from metatransformer_tpu_torch.data import nuscenes_eval as nusc
from metatransformer_tpu_torch.data import once_eval as once
from metatransformer_tpu_torch.data import waymo_eval as waymo
from metatransformer_tpu_torch.ops import box_fusion as fusion


def scenes(seed, n_frames=3, n_gt=10, far=60.0):
    """(gt boxes, labels, points-in-gt), (predicted boxes, labels, scores)
    a frame: predictions jittered from the ground truth (headings too),
    some missed, some false, some scores tied."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_frames):
        labels = rng.integers(0, 3, n_gt)
        size = np.asarray([[4.2, 1.9, 1.6], [0.8, 0.7, 1.7], [1.8, 0.7, 1.7]])[labels]
        ctr = rng.uniform([-far, -far, -1], [far, far, 1], (n_gt, 3))
        gt = np.concatenate([ctr, size, rng.uniform(-np.pi, np.pi, (n_gt, 1))], 1)
        keep = rng.random(n_gt) < 0.8
        pred = gt[keep] + rng.normal(0, 0.15, (int(keep.sum()), 7)) * [1, 1, 0.3, 0.1, 0.1, 0.1,
                                                                       2.0]
        false = np.concatenate([rng.uniform(-far, far, (3, 3)), size[:3],
                                rng.uniform(-3, 3, (3, 1))], 1)
        pred = np.concatenate([pred, false])
        plabels = np.concatenate([labels[keep], labels[:3]])
        scores = np.round(rng.uniform(0.05, 1.0, len(pred)), 2)
        out.append(((gt, labels, rng.integers(0, 12, n_gt)), (pred, plabels, scores)))
    return out


def _waymo_frames(pkg, data):
    gts = [pkg.WaymoFrame(boxes=g, labels=l, num_points=n) for (g, l, n), _ in data]
    preds = [pkg.WaymoFrame(boxes=p, labels=l, scores=s) for _, (p, l, s) in data]
    return preds, gts


@pytest.mark.parametrize("level", [1, 2])
def test_waymo_ap_and_aph_equal_jax(level):
    data = scenes(0)
    got = waymo.evaluate(*_waymo_frames(waymo, data), level=level)
    want = jwaymo.evaluate(*_waymo_frames(jwaymo, data), level=level)
    assert got == want and want["mAP"] > 0 and want["mAPH"] < want["mAP"]
    (g, _, _), (p, _, _) = data[0]
    for i in range(4):
        assert waymo.iou3d(p[i], g[i]) == jwaymo.iou3d(p[i], g[i])


def test_once_ap_by_range_equals_jax():
    data = scenes(1, far=70.0)
    got = once.evaluate(*_waymo_frames(once, data))
    want = jonce.evaluate(*_waymo_frames(jonce, data))
    assert got == want and want["mAP"] > 0
    assert any(want[f"AP_class{c}_30-50m"] > 0 for c in range(3))


@pytest.mark.parametrize("velocity", [False, True])
def test_nuscenes_map_and_nds_equal_jax(velocity):
    data = scenes(2, far=30.0)
    rng = np.random.default_rng(3)
    frames = {}
    for name, pkg in (("port", nusc), ("jax", jnusc)):
        vel = np.random.default_rng(4)
        gts = [pkg.NuscFrame(boxes=g, labels=l,
                             velocities=vel.normal(0, 2, (len(g), 2)) if velocity else None)
               for (g, l, _), _ in data]
        preds = [pkg.NuscFrame(boxes=p, labels=l, scores=s,
                               velocities=vel.normal(0, 2, (len(p), 2)) if velocity else None)
                 for _, (p, l, s) in data]
        frames[name] = (preds, gts)
    got = nusc.evaluate(*frames["port"], classes=(0, 1, 2))
    want = jnusc.evaluate(*frames["jax"], classes=(0, 1, 2))
    assert got == want and want["NDS"] > 0 and ("mAVE" in want) == velocity
    sweeps = [(rng.standard_normal((50 + 10 * i, 4)).astype(np.float32),
               np.eye(4) + np.pad(rng.normal(0, 0.1, (3, 4)), ((0, 1), (0, 0))), 0.05 * i)
              for i in range(3)]
    for max_points in (100, 400):
        for a, b in zip(nusc.accumulate_sweeps(sweeps, max_points),
                        jnusc.accumulate_sweeps(sweeps, max_points)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_weighted_box_fusion_equals_jax():
    data = scenes(5, n_frames=3, n_gt=8, far=20.0)
    boxes = [p.astype(np.float32) for _, (p, _, _) in data]
    scores = [s.astype(np.float32) for _, (_, _, s) in data]
    labels = [l for _, (_, l, _) in data]
    # the three sources see one scene: every source's boxes near the first's
    boxes = [boxes[0] + np.float32(0.05) * i for i in range(3)]
    scores = [scores[0][::-1].copy(), scores[0], scores[0] * np.float32(0.9)]
    labels = [labels[0]] * 3
    got = fusion.weighted_box_fusion(boxes, scores, labels)
    want = jfusion.weighted_box_fusion(boxes, scores, labels)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert len(want[0]) < sum(len(b) for b in boxes)
    empty = fusion.weighted_box_fusion([np.zeros((0, 7), np.float32)], [np.zeros(0)],
                                       [np.zeros(0, np.int32)])
    assert [e.shape for e in empty] == [(0, 7), (0,), (0,)]
