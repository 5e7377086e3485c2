"""The port's DETR head (heads/detr.py) against the JAX package on the CPU,
FP32, with perturbed JAX weights carried across: class logits and boxes at
1e-4 (the decoder's parity bound), GIoU and the box conversion at 1e-6, and
tests/test_detr.py's matching pipeline (costs at 1e-5, the same
assignment).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metatransformer_tpu.heads import detr as jdetr
from metatransformer_tpu.models.time_series import DecoderConfig as JDecoderConfig
from metatransformer_tpu.ops import matching as jmatching
from metatransformer_tpu_torch.core import convert
from metatransformer_tpu_torch.core.tree import leaves_with_path
from metatransformer_tpu_torch.heads import detr
from metatransformer_tpu_torch.models.time_series import DecoderConfig
from metatransformer_tpu_torch.ops import matching
from tests.test_torch_vit_adapter import close, perturb

torch.set_num_threads(1)
TOL = 1e-4


def cfgs(in_dim=32, queries=8, classes=5, dim=16, depth=2):
    dec = dict(dim=dim, d_ff=32, num_heads=2, depth=depth)
    kw = dict(in_dim=in_dim, num_queries=queries, num_classes=classes)
    return (jdetr.DETRHeadConfig(decoder=JDecoderConfig(**dec), **kw),
            detr.DETRHeadConfig(decoder=DecoderConfig(**dec), **kw))


def _run(jcfg, cfg, feats, seed):
    params = perturb(jdetr.init(jcfg, jax.random.PRNGKey(seed)), seed=seed)
    want = jdetr.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(feats), jcfg)
    got = detr.apply(convert.from_numpy(params, "cpu"), torch.tensor(feats), cfg)
    return got, want


@pytest.mark.parametrize("depth", [1, 2])
def test_detr_head_matches_jax(depth):
    jcfg, cfg = cfgs(depth=depth)
    feats = np.random.default_rng(0).standard_normal((2, 8, 8, 32)).astype(np.float32)
    (cls, boxes), (jcls, jboxes) = _run(jcfg, cfg, feats, depth)
    assert tuple(cls.shape) == (2, 8, 6) and tuple(boxes.shape) == (2, 8, 4)
    close(cls, jcls, TOL)
    close(boxes, jboxes, TOL)
    assert ((boxes >= 0) & (boxes <= 1)).all()


def test_fresh_tree_has_jax_keys_and_shapes():
    jcfg, cfg = cfgs()
    want = jax.eval_shape(lambda k: jdetr.init(jcfg, k), jax.random.PRNGKey(0))
    got = detr.init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert [(p, tuple(v.shape)) for p, v in leaves_with_path(got)] == [
        (p, tuple(v.shape)) for p, v in leaves_with_path(want)]


def test_giou_and_box_conversion_match_jax():
    rng = np.random.default_rng(1)
    a = np.abs(rng.standard_normal((6, 4))).astype(np.float32) * 0.3 + 0.2
    b = np.abs(rng.standard_normal((5, 4))).astype(np.float32) * 0.3 + 0.2
    xa, xb = detr.box_cxcywh_to_xyxy(torch.tensor(a)), detr.box_cxcywh_to_xyxy(torch.tensor(b))
    close(xa, jdetr.box_cxcywh_to_xyxy(jnp.asarray(a)), 1e-6)
    got = detr.generalized_iou(xa, xb)
    close(got, jdetr.generalized_iou(jnp.asarray(xa.numpy()), jnp.asarray(xb.numpy())), 1e-6)
    assert (got <= 1).all() and (got >= -1).all()


def test_giou_cases():
    """tests/test_detr.py's three: itself 1, half overlap in (0, 0.5),
    disjoint negative."""
    a = torch.tensor([[0.0, 0, 1, 1]])
    assert abs(detr.generalized_iou(a, a).item() - 1.0) < 1e-6
    assert 0.0 < detr.generalized_iou(a, torch.tensor([[0.5, 0.0, 1.5, 1.0]])).item() < 0.5
    assert detr.generalized_iou(a, torch.tensor([[2.0, 2, 3, 3]])).item() < 0.0


def test_detr_matching_pipeline_matches_jax():
    """tests/test_detr.py's pipeline: class + L1 - GIoU costs, then the
    Hungarian assignment, on both packages' outputs."""
    jcfg, cfg = cfgs(in_dim=16, queries=6, classes=3, depth=1)
    feats = np.random.default_rng(1).standard_normal((1, 4, 4, 16)).astype(np.float32)
    (cls, boxes), (jcls, jboxes) = _run(jcfg, cfg, feats, 1)
    gt_boxes = np.array([[0.3, 0.3, 0.2, 0.2], [0.7, 0.7, 0.1, 0.1]], np.float32)
    gt_labels = np.array([0, 2])
    want = (jmatching.classification_cost(jcls[0], jnp.asarray(gt_labels))
            + jmatching.bbox_l1_cost(jboxes[0], jnp.asarray(gt_boxes))
            - jdetr.generalized_iou(jdetr.box_cxcywh_to_xyxy(jboxes[0]),
                                    jdetr.box_cxcywh_to_xyxy(jnp.asarray(gt_boxes))))
    gb = torch.tensor(gt_boxes)
    cost = (matching.classification_cost(cls[0], torch.tensor(gt_labels))
            + matching.bbox_l1_cost(boxes[0], gb)
            - detr.generalized_iou(detr.box_cxcywh_to_xyxy(boxes[0]), detr.box_cxcywh_to_xyxy(gb)))
    close(cost, want, 1e-5)
    rows, cols = matching.hungarian_assign(cost)
    jrows, jcols = jmatching.hungarian_assign(np.asarray(want))
    assert len(rows) == 2 and len(set(rows.tolist())) == 2
    np.testing.assert_array_equal(rows, jrows)
    np.testing.assert_array_equal(cols, jcols)
