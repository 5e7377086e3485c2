"""The port's 2D detection heads (heads/detection2d.py) against the JAX
package on the CPU, FP32, at the JAX tests' small geometry
(tests/test_detection2d.py: 64 px, FPN 32, RPN nms_pre 64 and 16
proposals), every parameter tree perturbed with seeded noise before it is
carried across; the models end to end are in tests/test_torch_mask_rcnn.py.

The discrete choices are held exactly: the anchors, the top-k indices of
each level, the NMS keeps, the RoI levels and the assignments. The
continuous parts are held at 1e-5 (box coder, FPN, RPN, RoIAlign) and at
the adapter's feature bound, 1e-4 (the heads); the losses at rtol 1e-5.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metatransformer_tpu.heads import detection2d as jd2
from metatransformer_tpu.models import mask_rcnn as jmrcnn
from metatransformer_tpu_torch.core import convert
from metatransformer_tpu_torch.core.tree import leaves_with_path
from metatransformer_tpu_torch.heads import detection2d as d2
from metatransformer_tpu_torch.models import mask_rcnn
from tests.test_torch_vit_adapter import close, perturb, smoke_adapter

torch.set_num_threads(1)
TOL = 1e-4
LOSS_RTOL = 1e-5
CLASSES = 5


def small_cfg(jax_side: bool, stages=1, with_mask=True, bbox_head="2fc",
              stage_ious=(0.5, 0.6, 0.7)):
    """tests/test_detection2d.py's geometry, in either package."""
    d, mod = (jd2, jmrcnn) if jax_side else (d2, mask_rcnn)
    return mod.MaskRCNNConfig(
        backbone=smoke_adapter(jax_side),
        fpn=d.FPNConfig(in_channels=(32,) * 4, out_channels=32),
        rpn=d.RPNConfig(channels=32, nms_pre=64, max_proposals=16),
        rcnn=d.RCNNConfig(num_classes=CLASSES, channels=32, fc_dim=64, num_stages=stages,
                          stage_ious=stage_ious, with_mask=with_mask, mask_size=7,
                          bbox_head=bbox_head),
        img_size=64,
    )


def _t(a):
    return torch.tensor(np.asarray(a))


def _boxes(rng, shape, img=64.0, min_side=2.0):
    """xyxy boxes inside the image with sides of at least ``min_side``."""
    x0y0 = rng.uniform(0, img - 2 * min_side, shape + (2,))
    wh = rng.uniform(min_side, img / 2, shape + (2,))
    return np.concatenate([x0y0, np.minimum(x0y0 + wh, img)], -1).astype(np.float32)


# --------------------------------------------------------------------------
# boxes, anchors, NMS
# --------------------------------------------------------------------------


@pytest.mark.parametrize("max_hw", [None, (64, 48)])
def test_box_coder_and_iou_match_jax(max_hw):
    rng = np.random.default_rng(0)
    rois, gt = _boxes(rng, (12,)), _boxes(rng, (12,))
    deltas = (rng.standard_normal((12, 4)) * 2).astype(np.float32)  # some dw, dh clip at 4
    close(d2.delta2bbox(_t(rois), _t(deltas), max_hw),
          jd2.delta2bbox(jnp.asarray(rois), jnp.asarray(deltas), max_hw), 1e-5)
    close(d2.bbox2delta(_t(rois), _t(gt)), jd2.bbox2delta(jnp.asarray(rois), jnp.asarray(gt)),
          1e-5)
    close(d2.bbox_iou_xyxy(_t(rois), _t(gt[:5])),
          jd2.bbox_iou_xyxy(jnp.asarray(rois), jnp.asarray(gt[:5])), 1e-6)
    # batched leading axes, as the port calls it
    want = np.stack([np.asarray(jd2.bbox_iou_xyxy(jnp.asarray(rois[:6]), jnp.asarray(g)))
                     for g in (gt[:4], gt[4:8])])
    close(d2.bbox_iou_xyxy(_t(rois[:6])[None], _t(np.stack([gt[:4], gt[4:8]]))), want, 1e-6)


@pytest.mark.parametrize("hw,stride", [((16, 16), 4), ((8, 8), 8), ((1, 1), 64), ((3, 5), 16)])
def test_level_anchors_equal_the_reference_loops(hw, stride):
    cfg = d2.RPNConfig(anchor_scales=(8.0, 4.0))
    jcfg = jd2.RPNConfig(anchor_scales=(8.0, 4.0))
    got, want = d2.level_anchors(hw, stride, cfg), jd2.level_anchors(hw, stride, jcfg)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _jax_nms(boxes, scores, thr, max_out):
    return jax.vmap(lambda b, s: jd2.nms_xyxy(b, s, thr, max_out))(
        jnp.asarray(boxes), jnp.asarray(scores))


@pytest.mark.parametrize("n,max_out,thr", [(40, 16, 0.7), (40, 16, 0.3), (10, 16, 0.5),
                                           (64, 8, 0.7)])
def test_nms_keeps_equal_jax(n, max_out, thr):
    """Index for index, over a batch of 3, clustered boxes so that boxes
    suppress each other; with 10 boxes and 16 steps NMS runs dry."""
    rng = np.random.default_rng(n + max_out)
    centres = rng.uniform(8, 56, (3, 4, 2))[:, rng.integers(0, 4, n)]
    half = rng.uniform(3, 10, (3, n, 2))
    jitter = rng.normal(0, 1.5, (3, n, 2))
    boxes = np.concatenate([centres + jitter - half, centres + jitter + half], -1).astype(
        np.float32)
    scores = rng.permutation(n * 3).reshape(3, n).astype(np.float32) / (3 * n)
    idx, valid = d2.nms_xyxy(_t(boxes), _t(scores), thr, max_out)
    want_idx, want_valid = _jax_nms(boxes, scores, thr, max_out)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    assert valid.any(1).all() and (n > max_out or not valid[:, -1].any())


def test_nms_of_one_pair_suppresses():
    """tests/test_detection2d.py's case: of two overlapping boxes the
    better survives."""
    boxes = torch.tensor([[[0, 0, 10, 10], [1, 1, 11, 11], [30, 30, 40, 40]]], dtype=torch.float32)
    idx, valid = d2.nms_xyxy(boxes, torch.tensor([[0.9, 0.8, 0.7]]), 0.5, 3)
    assert set(idx[valid].tolist()) == {0, 2}


def test_scatter_keeps_the_last_update_as_xla():
    """Duplicate indices in ``.at[].set``: XLA on the CPU keeps the last."""
    target = torch.zeros(2, 6, dtype=torch.long)
    idx = torch.tensor([[1, 1, 3], [2, 4, 2]])
    values = torch.tensor([[7, 9, 4], [5, 6, 8]])
    want = jax.vmap(lambda t, i, v: t.at[i].set(v))(
        jnp.zeros((2, 6), jnp.int32), jnp.asarray(idx.numpy()), jnp.asarray(values.numpy()))
    np.testing.assert_array_equal(d2._scatter_last(target, idx, values).numpy(), np.asarray(want))


# --------------------------------------------------------------------------
# FPN, RPN, RoIAlign, heads
# --------------------------------------------------------------------------


def _pyramid(seed=3, b=2, c=32, s=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s >> i, s >> i, c)).astype(np.float32) for i in range(4)]


def fresh(init, cfg, seed, scale):
    """A perturbed numpy tree from the port's seeded init (its keys and
    shapes are JAX's: test_fresh_trees_have_jax_keys_and_shapes)."""
    tree = init(cfg, torch.Generator().manual_seed(seed), "cpu")
    return perturb(convert.to_numpy(tree), seed=seed, scale=scale)


@functools.lru_cache(maxsize=None)
def _head_params():
    """Perturbed FPN, RPN and R-CNN trees of the small geometry (numpy)."""
    cfg = small_cfg(False, stages=1)
    return (fresh(d2.fpn_init, cfg.fpn, 5, 0.1), fresh(d2.rpn_init, cfg.rpn, 6, 0.02),
            {head: fresh(d2.rcnn_init, dataclasses.replace(cfg.rcnn, bbox_head=head), 7, 0.02)
             for head in ("2fc", "4conv1fc")})


def test_fpn_matches_jax():
    fpn, _, _ = _head_params()
    cfg, jcfg = small_cfg(False).fpn, small_cfg(True).fpn
    feats = _pyramid()
    want = jd2.fpn_apply(jax.tree.map(jnp.asarray, fpn), [jnp.asarray(f) for f in feats], jcfg)
    got = d2.fpn_apply(convert.from_numpy(fpn, "cpu"), [_t(f) for f in feats], cfg)
    assert [tuple(g.shape[1:3]) for g in got] == [(16, 16), (8, 8), (4, 4), (2, 2), (1, 1)]
    for i, (g, w) in enumerate(zip(got, want)):
        close(g, w, 1e-5, f"level {i}")


def _rpn_run():
    """The RPN on the FPN of a random pyramid, in both packages."""
    fpn, rpn, _ = _head_params()
    cfg, jcfg = small_cfg(False), small_cfg(True)
    feats = _pyramid(seed=8)
    jfeats = jd2.fpn_apply(jax.tree.map(jnp.asarray, fpn), [jnp.asarray(f) for f in feats],
                           jcfg.fpn)
    want = jd2.rpn_apply(jax.tree.map(jnp.asarray, rpn), jfeats, jcfg.rpn)
    got = d2.rpn_apply(convert.from_numpy(rpn, "cpu"), [_t(f) for f in jfeats], cfg.rpn)
    return cfg, jcfg, got, want


def test_rpn_outputs_match_jax():
    _, _, got, want = _rpn_run()
    for (c, r), (jc, jr) in zip(got, want):
        close(c, jc, 1e-5)
        close(r, jr, 1e-5)


def jax_proposal_indices(rpn_outs, anchors, rpn_cfg, img_hw=(64, 64)):
    """JAX's choices on its RPN outputs: each level's top-k indices, then
    the NMS keeps (idx, valid) of the decoded boxes."""
    topk, boxes, scores = [], [], []
    for (c, r), a in zip(rpn_outs, anchors):
        top, idx = jax.lax.top_k(c, min(rpn_cfg.nms_pre, c.shape[1]))
        topk.append(np.asarray(idx))
        boxes.append(jax.vmap(lambda d, i: jd2.delta2bbox(jnp.asarray(a)[i], d[i], img_hw))(r, idx))
        scores.append(jax.nn.sigmoid(top))
    nms = _jax_nms(jnp.concatenate(boxes, 1), jnp.concatenate(scores, 1), rpn_cfg.nms_thr,
                   rpn_cfg.max_proposals)
    return topk, [np.asarray(a) for a in nms]


def assert_same_choices(seen, want_topk, want_nms):
    for got, want in zip(seen["level_topk"], want_topk, strict=True):
        np.testing.assert_array_equal(got.numpy(), want)
    for got, want in zip(seen["nms_xyxy"][0], want_nms):
        np.testing.assert_array_equal(got.numpy(), want)


def recording(monkeypatch, *names):
    """The outputs of each named function of the port's detection2d, kept
    in call order."""
    seen = {n: [] for n in names}
    for name in names:
        orig = getattr(d2, name)
        monkeypatch.setattr(d2, name, lambda *a, _o=orig, _n=name: seen[_n].append(_o(*a))
                            or seen[_n][-1])
    return seen


def test_rpn_proposal_indices_equal_jax(monkeypatch):
    """The top-k of every level and the NMS keeps are JAX's index for
    index; proposals and their scores within 1e-5."""
    cfg, jcfg, got, want = _rpn_run()
    anchors = [np.asarray(a) for a in jmrcnn._anchors(jcfg)]
    seen = recording(monkeypatch, "level_topk", "nms_xyxy")
    props, scores = d2.rpn_proposals(got, [_t(a) for a in anchors], cfg.rpn, (64, 64))
    jprops, jscores = jd2.rpn_proposals(want, [jnp.asarray(a) for a in anchors], jcfg.rpn,
                                        (64, 64))
    assert_same_choices(seen, *jax_proposal_indices(want, anchors, jcfg.rpn))
    close(props, jprops, 1e-5)
    close(scores, jscores, 1e-5)


@pytest.mark.parametrize("out_size", [1, 7, 14])
def test_roi_align_matches_jax(out_size):
    """Boxes of every scale, so that each of the 4 levels is taken."""
    feats = _pyramid(seed=9, s=32)
    rng = np.random.default_rng(out_size)
    sides = np.array([20.0, 60.0, 120.0, 240.0, 500.0, 12.0])[rng.permutation(6)]
    x0y0 = rng.uniform(0, 40, (2, 6, 2))
    rois = np.concatenate([x0y0, x0y0 + sides[None, :, None] * rng.uniform(0.8, 1.2, (2, 6, 2))],
                          -1).astype(np.float32)
    lv = d2.roi_levels(_t(rois), 4)
    assert set(lv.flatten().tolist()) == {0, 1, 2, 3}
    want = jd2.roi_align([jnp.asarray(f) for f in feats], jnp.asarray(rois), out_size)
    got = d2.roi_align([_t(f) for f in feats], _t(rois), out_size)
    close(got, want, 1e-5)


@pytest.mark.parametrize("head", ["2fc", "4conv1fc"])
def test_box_heads_match_jax(head):
    _, _, rcnn = _head_params()
    roi = np.random.default_rng(10).standard_normal((2, 6, 7, 7, 32)).astype(np.float32)
    stage = rcnn[head]["stages"][0]
    want = jd2.bbox_head_apply(jax.tree.map(jnp.asarray, stage), jnp.asarray(roi),
                               jax.lax.Precision.HIGHEST)
    got = d2.bbox_head_apply(convert.from_numpy(stage, "cpu"), _t(roi), "highest")
    for g, w in zip(got, want):
        close(g, w, TOL)


def test_mask_head_matches_jax():
    _, _, rcnn = _head_params()
    roi = np.random.default_rng(11).standard_normal((2, 3, 7, 7, 32)).astype(np.float32)
    want = jd2.mask_head_apply(jax.tree.map(jnp.asarray, rcnn["2fc"]), jnp.asarray(roi),
                               jax.lax.Precision.HIGHEST)
    got = d2.mask_head_apply(convert.from_numpy(rcnn["2fc"], "cpu"), _t(roi))
    assert tuple(got.shape) == (2, 3, 14, 14, CLASSES)
    close(got, want, TOL)


@pytest.mark.parametrize("stages,head", [(1, "2fc"), (3, "2fc"), (1, "4conv1fc")])
def test_fresh_trees_have_jax_keys_and_shapes(stages, head):
    """(The reference's R-CNN init runs out of keys for a 4conv1fc cascade,
    which no recipe builds.)"""
    want = jax.eval_shape(lambda k: jmrcnn.init(small_cfg(True, stages, bbox_head=head), k),
                          jax.random.PRNGKey(0))
    got = mask_rcnn.init(small_cfg(False, stages, bbox_head=head),
                         torch.Generator().manual_seed(0), "cpu")
    assert [(p, tuple(v.shape)) for p, v in leaves_with_path(got)] == [
        (p, tuple(v.shape)) for p, v in leaves_with_path(want)]


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------


def _gt(seed, b=2, g=3, img=64):
    """Ground truths drawn apart (no two share their best anchor), the last
    of the second image invalid."""
    rng = np.random.default_rng(seed)
    boxes = np.stack([np.stack([_boxes(rng, (), img * 0.45, 6.0) + off
                                for off in (0.0, img * 0.5)] + [_boxes(rng, (), img, 6.0)])
                      for _ in range(b)])[:, :g]
    labels = rng.integers(0, CLASSES, (b, g)).astype(np.int32)
    valid = np.ones((b, g), bool)
    valid[1, -1] = False
    return boxes.astype(np.float32), labels, valid


def test_rpn_loss_matches_jax():
    cfg, jcfg, got, want = _rpn_run()
    anchors = [np.asarray(a) for a in jmrcnn._anchors(jcfg)]
    gt_boxes, _, gt_valid = _gt(12)
    jl, jlogs = jd2.rpn_loss(want, [jnp.asarray(a) for a in anchors], jnp.asarray(gt_boxes),
                             jnp.asarray(gt_valid))
    loss, logs = d2.rpn_loss(got, [_t(a) for a in anchors], _t(gt_boxes), _t(gt_valid))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=LOSS_RTOL)
    for k in ("rpn_cls", "rpn_reg"):
        np.testing.assert_allclose(logs[k].item(), float(jlogs[k]), rtol=LOSS_RTOL)
    labels, _ = d2.rpn_assign(torch.cat([_t(a) for a in anchors]), _t(gt_boxes), _t(gt_valid))
    assert (labels == 1).sum(1).min() >= 2  # every valid gt has its anchor


@pytest.mark.parametrize("pos_iou", [0.1, 0.5])
def test_rcnn_stage_loss_matches_jax(pos_iou):
    rng = np.random.default_rng(13)
    gt_boxes, gt_labels, gt_valid = _gt(14)
    props = np.concatenate([gt_boxes + rng.normal(0, 3, gt_boxes.shape).astype(np.float32),
                            _boxes(rng, (2, 5))], 1)
    cls = rng.standard_normal((2, 8, CLASSES + 1)).astype(np.float32)
    deltas = (rng.standard_normal((2, 8, 4)) * 0.1).astype(np.float32)
    jl, jpos, jbest = jd2.rcnn_stage_loss(*map(jnp.asarray, (cls, deltas, props, gt_boxes,
                                                             gt_labels, gt_valid)),
                                          CLASSES, pos_iou)
    loss, pos, best = d2.rcnn_stage_loss(*map(_t, (cls, deltas, props, gt_boxes, gt_labels,
                                                   gt_valid)), CLASSES, pos_iou)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=LOSS_RTOL)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(best.numpy(), np.asarray(jbest))
    assert pos.any()


def _entry_points():
    from metatransformer_tpu_torch import recipes
    from metatransformer_tpu_torch.configs import CONFIG_DIR, load_config
    from metatransformer_tpu_torch.heads import detr
    from metatransformer_tpu_torch.models import htc
    from metatransformer_tpu_torch.models.time_series import DecoderConfig

    cfg = small_cfg(False)
    coco = load_config(f"{CONFIG_DIR}/coco_htcpp_metatransformer.yaml")
    dcfg = detr.DETRHeadConfig(in_dim=16, num_queries=4, num_classes=3,
                               decoder=DecoderConfig(dim=16, d_ff=32, num_heads=2, depth=1))
    return {
        "fpn_init": lambda g, **k: d2.fpn_init(cfg.fpn, g, **k),
        "rpn_init": lambda g, **k: d2.rpn_init(cfg.rpn, g, **k),
        "rcnn_init": lambda g, **k: d2.rcnn_init(cfg.rcnn, g, **k),
        "mask_rcnn.init": lambda g, **k: mask_rcnn.init(cfg, g, **k),
        "htc.init": lambda g, **k: htc.init(recipes.htc_config(coco, smoke=True), g, **k),
        "detr.init": lambda g, **k: detr.init(dcfg, g, **k),
        "recipes.build": lambda g, **k: recipes.build(coco, g, smoke=True, **k),
    }


@pytest.mark.parametrize("name", ["fpn_init", "rpn_init", "rcnn_init", "mask_rcnn.init",
                                  "htc.init", "detr.init", "recipes.build"])
def test_entry_points_run_on_the_card_or_raise(name, monkeypatch):
    """With no card, an entry point given no device raises; given "cpu",
    its parameters land there."""
    entry = _entry_points()[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        entry(torch.Generator().manual_seed(0))
    built = entry(torch.Generator().manual_seed(0), device="cpu")
    tree = built.params if hasattr(built, "params") else built
    assert {leaf.device.type for _, leaf in leaves_with_path(tree)} == {"cpu"}
