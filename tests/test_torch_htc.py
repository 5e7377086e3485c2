"""The port's HTC++ (models/htc.py) against the JAX package on the CPU, FP32,
at tests/test_htc.py's geometry (64 px, dim 32, depth 2, FPN 32, 8
proposals, 3 stages at near-zero gates so that every stage's mask and
info-flow paths carry gradient, 12 semantic classes, 2 semantic convs),
with perturbed weights carried across.

Tolerances as tests/test_torch_mask_rcnn.py: ``forward_test`` at 1e-4
(boxes in units of the image, masks of their largest), with the proposal
indices equal; ``forward_train``'s losses at rtol 1e-5 and every gradient
leaf at 1e-4 of its own largest against the reference in float64. Also
``vit_adapter.resize``'s ``"nearest"``, the semantic labels' resize.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metatransformer_tpu.core import encoder as jenc
from metatransformer_tpu.heads import detection2d as jd2
from metatransformer_tpu.models import htc as jhtc
from metatransformer_tpu.models import mask_rcnn as jmrcnn
from metatransformer_tpu_torch.core import convert
from metatransformer_tpu_torch.core.tree import leaves_with_path
from metatransformer_tpu_torch.heads import detection2d as d2
from metatransformer_tpu_torch.models import htc
from metatransformer_tpu_torch.models import vit_adapter as va
from tests.test_torch_detection2d import (
    TOL,
    _t,
    assert_same_choices,
    fresh,
    jax_proposal_indices,
    recording,
)
from tests.test_torch_mask_rcnn import check_train, jax_value_and_grad_f64, port_loss_and_grads
from tests.test_torch_vit_adapter import close, images, smoke_adapter

torch.set_num_threads(1)


def small_cfg(jax_side: bool):
    d, mod = (jd2, jhtc) if jax_side else (d2, htc)
    return mod.HTCConfig(
        backbone=smoke_adapter(jax_side),
        fpn=d.FPNConfig(in_channels=(32,) * 4, out_channels=32),
        rpn=d.RPNConfig(channels=32, nms_pre=64, max_proposals=8),
        rcnn=d.RCNNConfig(num_classes=5, channels=32, fc_dim=64, num_stages=3,
                          stage_ious=(0.02, 0.02, 0.02), with_mask=True, mask_size=7),
        img_size=64, semantic_classes=12, semantic_convs=2,
    )


@functools.lru_cache(maxsize=None)
def _model():
    cfg = small_cfg(False)
    return cfg, small_cfg(True), fresh(htc.init, cfg, 21, 0.02)


def _batch(seed=0, g=2, img=64):
    """tests/test_htc.py's batch at b = 2: boxes, their masks, semantic
    labels inside them and 255 elsewhere."""
    rng = np.random.default_rng(seed)
    x0y0 = rng.uniform(0, img // 2, (2, g, 2))
    wh = rng.uniform(img // 8, img // 2, (2, g, 2))
    boxes = np.concatenate([x0y0, np.minimum(x0y0 + wh, img - 1)], -1).astype(np.float32)
    masks = np.zeros((2, g, img, img), np.float32)
    sem = np.full((2, img, img), 255, np.int32)
    for b in range(2):
        for gi in range(g):
            x0, y0, x1, y1 = boxes[b, gi].astype(int)
            masks[b, gi, y0:y1, x0:x1] = 1.0
            sem[b, y0:y1, x0:x1] = gi + 1
    labels = rng.integers(0, 5, (2, g)).astype(np.int32)
    return images(seed=seed + 1), boxes, labels, np.ones((2, g), bool), masks, sem


def test_fresh_tree_has_jax_keys_and_shapes():
    want = jax.eval_shape(lambda k: jhtc.init(small_cfg(True), k), jax.random.PRNGKey(0))
    got = htc.init(small_cfg(False), torch.Generator().manual_seed(0), "cpu")
    assert [(p, tuple(v.shape)) for p, v in leaves_with_path(got)] == [
        (p, tuple(v.shape)) for p, v in leaves_with_path(want)]
    assert "info" not in got["mask_stages"][0] and "info" in got["mask_stages"][2]


@pytest.mark.parametrize("hin,hout", [(16, 2), (64, 8), (8, 16), (6, 4), (5, 7)])
def test_nearest_resize_is_jax_nearest(hin, hout):
    """``jax.image.resize(..., "nearest")`` is torch's "nearest-exact", on
    both sides of 1 and at scales that do not divide."""
    x = np.arange(2 * hin * hin * 3, dtype=np.float32).reshape(2, hin, hin, 3)
    want = jax.image.resize(jnp.asarray(x), (2, hout, hout, 3), "nearest")
    np.testing.assert_array_equal(va.resize(_t(x), (hout, hout), "nearest").numpy(),
                                  np.asarray(want))


def test_semantic_branch_and_loss_match_jax():
    cfg, jcfg, params = _model()
    rng = np.random.default_rng(3)
    fpn = [rng.standard_normal((2, s, s, 32)).astype(np.float32) for s in (16, 8, 4, 2, 1)]
    jp = jax.tree.map(jnp.asarray, params)
    jfeat, jlogits = jhtc.semantic_branch(jp, [jnp.asarray(f) for f in fpn], jcfg)
    feat, logits = htc.semantic_branch(convert.from_numpy(params, "cpu"),
                                       [_t(f) for f in fpn], cfg)
    assert tuple(logits.shape) == (2, 8, 8, 12)
    close(feat, jfeat, TOL)
    close(logits, jlogits, TOL)
    sem = _batch()[-1]
    # the reference computes the CE inside forward_train: its lines, here
    lab = jax.image.resize(jnp.asarray(sem, jnp.float32)[..., None], (2, 8, 8, 1),
                           "nearest")[..., 0].astype(jnp.int32)
    valid = lab != 255
    import optax

    ce = optax.softmax_cross_entropy_with_integer_labels(jlogits, jnp.where(valid, lab, 0))
    want = jnp.sum(ce * valid) / jnp.maximum(jnp.sum(valid), 1)
    np.testing.assert_allclose(htc.semantic_loss(logits, _t(sem)).item(), float(want), rtol=1e-5)
    # with every pixel ignored the term is 0, not 0 / 0
    assert htc.semantic_loss(logits, torch.full((2, 64, 64), 255)).item() == 0.0


def test_forward_test_matches_jax(monkeypatch):
    cfg, jcfg, params = _model()
    x = images(seed=5)
    jcfg_m = jmrcnn.MaskRCNNConfig(backbone=jcfg.backbone, fpn=jcfg.fpn, rpn=jcfg.rpn,
                                   rcnn=jcfg.rcnn, img_size=jcfg.img_size)
    want, rpn_outs = jax.jit(lambda p, x: (
        jhtc.forward_test(p, x, jcfg), jmrcnn._forward_common(p, x, jcfg_m, jenc.FP32)[1]))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    seen = recording(monkeypatch, "level_topk", "nms_xyxy")
    got = htc.forward_test(convert.from_numpy(params, "cpu"), _t(x), cfg)
    anchors = [np.asarray(a) for a in jmrcnn._anchors(jcfg_m)]
    assert_same_choices(seen, *jax_proposal_indices(rpn_outs, anchors, jcfg.rpn))
    assert set(got) == set(want) == {"boxes", "scores", "labels", "semantic", "masks"}
    assert tuple(got["masks"].shape) == (2, 8, 14, 14, 5)
    close(got["boxes"] / 64, np.asarray(want["boxes"]) / 64, TOL, "boxes")
    np.testing.assert_array_equal(got["labels"].numpy(), np.asarray(want["labels"]))
    close(got["scores"], want["scores"], TOL, "scores")
    close(got["semantic"], want["semantic"], TOL, "semantic")
    top = np.abs(np.asarray(want["masks"])).max()
    close(got["masks"] / top, np.asarray(want["masks"]) / top, TOL, "masks")


def _jax_loss(p, *a):
    return jhtc.forward_train(p, *a[:4], _model()[1], gt_masks=a[4], semantic_labels=a[5])


def _train(sem_override=None):
    cfg, _, params = _model()
    x, boxes, labels, valid, masks, sem = _batch()
    if sem_override is not None:
        sem = sem_override
    want = jax_value_and_grad_f64(_jax_loss, params, x, boxes, labels, valid, masks, sem)
    args = [_t(a) for a in (x, boxes, labels, valid)]
    port = port_loss_and_grads(lambda p: htc.forward_train(
        p, *args, cfg, gt_masks=_t(masks), semantic_labels=_t(sem)), params)
    return port, want


KEYS = {"rpn_cls", "rpn_reg", "semantic"} | {f"stage{i}_{k}" for i in range(3)
                                            for k in ("bbox", "mask")}


def test_forward_train_losses_logs_and_grads_match_jax():
    """Every stage's mask head, the info-flow projections of stages 1 and
    2 and the semantic branch receive gradient, as in the reference."""
    port, want = _train()
    check_train(port, want, KEYS)
    grads = port[2]
    for si in range(3):
        assert np.abs(grads["mask_stages"][si]["convs"][0]["w"]).max() > 0
    for si in (1, 2):
        assert np.abs(grads["mask_stages"][si]["info"]["w"]).max() > 0
    assert np.abs(grads["sem_convs"][0]["w"]).max() > 0


def test_all_ignore_semantic_labels_give_a_zero_term():
    port, want = _train(np.full((2, 64, 64), 255, np.int32))
    check_train(port, want, KEYS)
    assert port[1]["semantic"].item() == 0.0 and want[1]["semantic"] == 0.0
