"""The port's numpy metric helpers (utils/metrics.py, utils/seg_eval.py)
against the JAX package's on seeded inputs: exact, or 1e-6 where a float
mean is taken."""

import numpy as np
import pytest

from metatransformer_tpu.utils import metrics as jmetrics
from metatransformer_tpu.utils import seg_eval as jseg
from metatransformer_tpu_torch.utils import metrics, seg_eval


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=1e-6, atol=1e-6)


def test_average_meter_and_cumulative_ensemble():
    rng = np.random.default_rng(0)
    m, jm = metrics.AverageMeter(), jmetrics.AverageMeter()
    for v, n in zip(rng.standard_normal(7), rng.integers(1, 5, 7)):
        m.update(v, int(n))
        jm.update(v, int(n))
    assert m.avg == jm.avg and m.count == jm.count
    m.reset()
    assert m.avg == 0.0
    e, je = metrics.CumulativeEnsemble(), jmetrics.CumulativeEnsemble()
    for _ in range(3):
        p = rng.standard_normal((5, 4))
        np.testing.assert_array_equal(e.update(p), je.update(p))


def test_confusion_matrix():
    rng = np.random.default_rng(1)
    cm, jcm = metrics.ConfusionMatrix(6), jmetrics.ConfusionMatrix(6)
    for _ in range(3):
        pred = rng.integers(0, 6, 200)
        target = rng.integers(-1, 7, 200)  # ignore labels outside [0, 6)
        cm.update(pred, target)
        jcm.update(pred, target)
    np.testing.assert_array_equal(cm.matrix, jcm.matrix)
    for name in ("overall_accuracy", "mean_accuracy", "miou", "kappa"):
        assert getattr(cm, name) == getattr(jcm, name), name
    for name in ("class_accuracy", "iou"):
        np.testing.assert_array_equal(getattr(cm, name), getattr(jcm, name))
    assert metrics.ConfusionMatrix(3).kappa == 0.0


def test_ap_auc_audio_and_regression_stats():
    rng = np.random.default_rng(2)
    scores = rng.standard_normal((40, 5))
    targets = (rng.random((40, 5)) > 0.6).astype(np.float32)
    targets[:, 4] = 0  # a class without positives: nan AP and AUC
    for c in range(5):
        a, b = metrics.average_precision(scores[:, c], targets[:, c]), \
            jmetrics.average_precision(scores[:, c], targets[:, c])
        assert (np.isnan(a) and np.isnan(b)) or a == b
        a, b = metrics.auc_roc(scores[:, c], targets[:, c]), jmetrics.auc_roc(scores[:, c], targets[:, c])
        assert (np.isnan(a) and np.isnan(b)) or a == b
    assert metrics.audio_stats(scores, targets) == jmetrics.audio_stats(scores, targets)
    pred, true = rng.standard_normal((8, 6)), rng.standard_normal((8, 6))
    true[0, 0] = 0.0  # the 1e-8 denominator guard
    got, want = metrics.regression_metrics(pred, true), jmetrics.regression_metrics(pred, true)
    assert got.keys() == want.keys()
    for k in got:
        _close(got[k], want[k])


def test_voxel_parts_and_scene_inference():
    rng = np.random.default_rng(3)
    coord = rng.random((300, 3)).astype(np.float32) * 2
    feat = rng.standard_normal((300, 3)).astype(np.float32)
    parts, jparts = seg_eval.voxel_parts(coord, 0.25), jseg.voxel_parts(coord, 0.25)
    assert len(parts) == len(jparts)
    for a, b in zip(parts, jparts):
        np.testing.assert_array_equal(a, b)
    assert sorted(np.concatenate(parts).tolist()) == list(range(300))
    w = rng.standard_normal((6, 4)).astype(np.float32)
    fwd = lambda pts: pts @ w  # [1, P, 6] -> [1, P, 4]
    np.testing.assert_array_equal(seg_eval.scene_inference(fwd, coord, feat, 0.25, 4),
                                  jseg.scene_inference(fwd, coord, feat, 0.25, 4))
    pts = rng.standard_normal((2, 10, 3)).astype(np.float32)
    fwd = lambda x: x.sum(-1)
    np.testing.assert_array_equal(seg_eval.vote_logits(fwd, pts, 4, seed=1),
                                  jseg.vote_logits(fwd, pts, 4, seed=1))


def test_shapenetpart_mious_refinement_and_six_fold():
    rng = np.random.default_rng(4)
    assert seg_eval.SHAPENETPART_CLS2PARTS == jseg.SHAPENETPART_CLS2PARTS
    cls = rng.integers(0, 16, 12)
    target = np.stack([rng.choice(seg_eval.SHAPENETPART_CLS2PARTS[c], 64) for c in cls])
    pred = np.where(rng.random((12, 64)) < 0.7, target, rng.integers(0, 50, (12, 64)))
    ious = seg_eval.instance_mious(pred, target, cls)
    np.testing.assert_array_equal(ious, jseg.instance_mious(pred, target, cls))
    got, want = seg_eval.aggregate_part_mious(ious, cls), jseg.aggregate_part_mious(ious, cls)
    assert got["ins_miou"] == want["ins_miou"] and got["cls_miou"] == want["cls_miou"]
    np.testing.assert_array_equal(got["per_cls_miou"], want["per_cls_miou"])
    coord = rng.standard_normal((12, 64, 3)).astype(np.float32)
    np.testing.assert_array_equal(seg_eval.part_seg_refinement(pred, coord, cls, n=5),
                                  jseg.part_seg_refinement(pred, coord, cls, n=5))
    cms, jcms = [], []
    for area in range(3):
        p, t = rng.integers(0, 5, 100), rng.integers(0, 5, 100)
        cm, jcm = metrics.ConfusionMatrix(5), jmetrics.ConfusionMatrix(5)
        cm.update(p, t)
        jcm.update(p, t)
        cms.append(cm)
        jcms.append(jcm)
    got, want = seg_eval.six_fold_aggregate(cms), jseg.six_fold_aggregate(jcms)
    for k in ("oa", "macc", "miou", "per_area_miou"):
        assert got[k] == want[k], k
    np.testing.assert_array_equal(got["ious"], want["ious"])


@pytest.mark.parametrize("module", ["metrics", "seg_eval"])
def test_the_copies_import_nothing_of_the_reference(module):
    import importlib
    import inspect

    src = inspect.getsource(importlib.import_module(f"metatransformer_tpu_torch.utils.{module}"))
    assert "import jax" not in src and "metatransformer_tpu." not in src
