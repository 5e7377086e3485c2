"""The port's rotated 3D IoU, NMS and RoI point pooling (ops/iou3d.py,
ops/roi_pool3d.py) against the JAX package on the CPU, FP32.

Overlaps and IoUs are held at 1e-5; the NMS keep sets, indices and flags
exactly, with tied scores, with fewer and with more kept boxes than
``max_out``, batched and one sample at a time. The reference's NMS loop
steps over all n candidates; the port's takes ``max_out`` greedy steps
and must give the same output (``ROADMAP.md`` queue 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metatransformer_tpu.ops import iou3d as jiou3d
from metatransformer_tpu.ops import roi_pool3d as jroi
from metatransformer_tpu_torch.ops import iou3d, roi_pool3d

torch.set_num_threads(1)
TOL = 1e-5


def _t(a):
    return torch.tensor(np.asarray(a))


def boxes3d(rng, shape, spread=6.0):
    """Random rotated boxes (x, y, z, dx, dy, dz, heading), car-sized,
    crowded enough to overlap."""
    ctr = rng.uniform(-spread, spread, shape + (3,))
    ctr[..., 2] *= 0.1
    size = rng.uniform(0.8, 4.0, shape + (3,))
    yaw = rng.uniform(-np.pi, np.pi, shape + (1,))
    return np.concatenate([ctr, size, yaw], -1).astype(np.float32)


def test_corners_overlap_and_iou_match_jax():
    rng = np.random.default_rng(0)
    a, b = boxes3d(rng, (12,)), boxes3d(rng, (9,))
    np.testing.assert_allclose(iou3d.box_corners_bev(_t(a)).numpy(),
                               np.asarray(jiou3d.box_corners_bev(jnp.asarray(a))), atol=TOL)
    want = np.asarray(jiou3d.rotated_overlap_bev(jnp.asarray(a), jnp.asarray(b)))
    got = iou3d.rotated_overlap_bev(_t(a), _t(b)).numpy()
    assert (want > 0).sum() > 5  # the boxes do overlap
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(iou3d.boxes_iou3d(_t(a), _t(b)).numpy(),
                               np.asarray(jiou3d.boxes_iou3d(jnp.asarray(a), jnp.asarray(b))),
                               atol=TOL, rtol=TOL)


def test_iou_of_a_box_with_itself_and_a_disjoint_one():
    box = np.asarray([[1.0, 2.0, 0.0, 4.0, 2.0, 1.5, 0.7]], np.float32)
    far = box + np.asarray([[20.0, 0, 0, 0, 0, 0, 0]], np.float32)
    np.testing.assert_allclose(iou3d.boxes_iou3d(_t(box), _t(box)).numpy(), [[1.0]], atol=1e-5)
    assert iou3d.boxes_iou3d(_t(box), _t(far)).item() == 0.0


def test_batched_iou_equals_each_sample():
    rng = np.random.default_rng(1)
    a, b = boxes3d(rng, (3, 7)), boxes3d(rng, (3, 5))
    batched = iou3d.boxes_iou3d(_t(a), _t(b))
    for i in range(3):
        torch.testing.assert_close(batched[i], iou3d.boxes_iou3d(_t(a[i]), _t(b[i])),
                                   rtol=0, atol=0)


def _jax_nms(boxes, scores, thr, max_out):
    idx, valid = jiou3d.nms_bev(jnp.asarray(boxes), jnp.asarray(scores), thr, max_out)
    return np.asarray(idx), np.asarray(valid)


@pytest.mark.parametrize("n, max_out, thr, spread", [
    (64, 16, 0.1, 6.0),   # more kept than max_out
    (64, 48, 0.1, 3.0),   # fewer kept than max_out: the suppressed fill the tail
    (40, 40, 0.3, 4.0),   # max_out = n
    (128, 32, 0.7, 5.0),
])
def test_nms_equals_jax(n, max_out, thr, spread):
    rng = np.random.default_rng(n + max_out)
    boxes = boxes3d(rng, (n,), spread)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    want_idx, want_valid = _jax_nms(boxes, scores, thr, max_out)
    idx, valid = iou3d.nms_bev(_t(boxes), _t(scores), thr, max_out)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(valid.numpy(), want_valid)
    assert 0 < want_valid.sum()


def test_nms_case_mix_is_covered():
    """Both regimes above really occur: fewer and more kept than max_out."""
    kept = []
    for n, max_out, thr, spread in [(64, 16, 0.1, 6.0), (64, 48, 0.1, 3.0)]:
        rng = np.random.default_rng(n + max_out)
        boxes = boxes3d(rng, (n,), spread)
        scores = rng.uniform(0, 1, n).astype(np.float32)
        kept.append(int(_jax_nms(boxes, scores, thr, n)[1].sum()))
    assert kept[0] > 16 and kept[1] < 48


def test_nms_with_tied_scores_keeps_the_input_order():
    """Quantised scores: many ties, broken by the input order (a stable
    sort, as ``jnp.argsort``)."""
    rng = np.random.default_rng(5)
    boxes = boxes3d(rng, (60,), 3.0)
    scores = (rng.integers(0, 4, 60) / 4).astype(np.float32)
    want = _jax_nms(boxes, scores, 0.2, 30)
    idx, valid = iou3d.nms_bev(_t(boxes), _t(scores), 0.2, 30)
    np.testing.assert_array_equal(idx.numpy(), want[0])
    np.testing.assert_array_equal(valid.numpy(), want[1])


def test_nms_batched_equals_each_sample():
    rng = np.random.default_rng(6)
    boxes = boxes3d(rng, (3, 50), 4.0)
    scores = rng.uniform(0, 1, (3, 50)).astype(np.float32)
    idx, valid = iou3d.nms_bev(_t(boxes), _t(scores), 0.3, 20)
    for i in range(3):
        want = _jax_nms(boxes[i], scores[i], 0.3, 20)
        np.testing.assert_array_equal(idx[i].numpy(), want[0])
        np.testing.assert_array_equal(valid[i].numpy(), want[1])


# --------------------------------------------------------------------------
# RoI point pooling
# --------------------------------------------------------------------------


def _pool_inputs(seed=7):
    rng = np.random.default_rng(seed)
    points = rng.uniform(-4, 4, (2, 200, 3)).astype(np.float32)
    feats = rng.standard_normal((2, 200, 5)).astype(np.float32)
    boxes = boxes3d(rng, (2, 6), 2.0)
    boxes[..., 5] = 3.0  # tall enough to hold points
    boxes[1, 5] = [30.0, 30.0, 0.0, 1.0, 1.0, 1.0, 0.0]  # an empty RoI
    return points, feats, boxes


def test_points_in_boxes_and_pools_match_jax():
    points, feats, boxes = _pool_inputs()
    jp, jf, jb = map(jnp.asarray, (points, feats, boxes))
    mask = roi_pool3d.points_in_boxes(_t(points), _t(boxes))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jroi.points_in_boxes(jp, jb)))
    assert mask.sum() > 20 and not mask[1, 5].any()
    np.testing.assert_allclose(roi_pool3d.roi_max_pool(_t(points), _t(feats), _t(boxes)).numpy(),
                               np.asarray(jroi.roi_max_pool(jp, jf, jb)), atol=1e-6)
    np.testing.assert_allclose(roi_pool3d.roi_avg_pool(_t(points), _t(feats), _t(boxes)).numpy(),
                               np.asarray(jroi.roi_avg_pool(jp, jf, jb)), atol=1e-6)


def test_roi_max_pool_splits_a_tie_gradient_as_jax():
    """Features with equal maxima in a box: the gradient is split among the
    tied points as ``jnp.max`` splits it (``amax``)."""
    points, feats, boxes = _pool_inputs(8)
    feats = np.round(np.abs(feats) * 2) / 2  # many exact ties
    jp, jb = jnp.asarray(points), jnp.asarray(boxes)
    want = np.asarray(jax.grad(lambda f: jnp.sum(jroi.roi_max_pool(jp, f, jb) ** 2))(
        jnp.asarray(feats)))
    f = _t(feats).requires_grad_(True)
    (roi_pool3d.roi_max_pool(_t(points), f, _t(boxes)) ** 2).sum().backward()
    np.testing.assert_allclose(f.grad.numpy(), want, atol=1e-6)
    assert ((want > 0) & (want < want.max())).any()  # some gradient was split
