"""The port's Mask R-CNN and Cascade R-CNN (models/mask_rcnn.py) end to end
against the JAX package on the CPU, FP32, at tests/test_detection2d.py's
geometry (64 px, dim 32, depth 2, FPN 32, RPN nms_pre 64 and 16
proposals), perturbed weights carried across.

``forward_test``: the proposal indices (each level's top-k, the NMS keeps)
equal to JAX's; boxes (in units of the image side), scores and masks (of
their largest magnitude) at 1e-4, labels equal. ``forward_train``: losses
and logs at rtol 1e-5 and every gradient leaf at 1e-4 of its own largest
(tests/test_torch_segmentor.py), against the reference run in float64
(``jax_value_and_grad_f64``).
"""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metatransformer_tpu.core import encoder as jenc
from metatransformer_tpu.models import mask_rcnn as jmrcnn
from metatransformer_tpu_torch.core import convert
from metatransformer_tpu_torch.core.tree import leaves_with_path, unflatten_like
from metatransformer_tpu_torch.models import mask_rcnn
from tests.test_torch_detection2d import (
    CLASSES,
    TOL,
    _boxes,
    _gt,
    _t,
    assert_same_choices,
    fresh,
    jax_proposal_indices,
    recording,
    small_cfg,
)
from tests.test_torch_vit_adapter import close, images

torch.set_num_threads(1)
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4  # of each leaf's own largest gradient


# --------------------------------------------------------------------------
# Mask R-CNN and Cascade R-CNN end to end
# --------------------------------------------------------------------------

# name: (stages, stage IoUs). An untrained RPN rarely clears the real
# 0.5 / 0.6 / 0.7 ladder; relaxed gates give every stage positives, so
# that the mask loss and its gradients are live (tests/test_detection2d.py)
MODELS = {"mask_rcnn": (1, (0.1,)), "cascade": (3, (0.1, 0.1, 0.1))}


@functools.lru_cache(maxsize=None)
def _model(name):
    """(port config, JAX config, perturbed numpy params)."""
    stages, ious = MODELS[name]
    cfg = small_cfg(False, stages=stages, stage_ious=ious)
    return cfg, small_cfg(True, stages=stages, stage_ious=ious), fresh(mask_rcnn.init, cfg, 15,
                                                                        0.02)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_forward_test_matches_jax(name, monkeypatch):
    """Proposal indices (top-k, NMS) equal to JAX's; boxes, scores, labels
    and masks at 1e-4."""
    cfg, jcfg, params = _model(name)
    x = images()
    want, rpn_outs = jax.jit(lambda p, x: (jmrcnn.forward_test(p, x, jcfg), jmrcnn._forward_common(
        p, x, jcfg, jenc.FP32)[1]))(jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    seen = recording(monkeypatch, "level_topk", "nms_xyxy")
    got = mask_rcnn.forward_test(convert.from_numpy(params, "cpu"), _t(x), cfg)
    anchors = [np.asarray(a) for a in jmrcnn._anchors(jcfg)]
    assert_same_choices(seen, *jax_proposal_indices(rpn_outs, anchors, jcfg.rpn))
    assert seen["nms_xyxy"][0][1].all(), "the RPN ran dry: too few proposals to hold"

    assert set(got) == set(want) == {"boxes", "scores", "labels", "masks"}
    p = cfg.rpn.max_proposals
    assert tuple(got["masks"].shape) == (2, p, 14, 14, CLASSES)
    # boxes in units of the image side: a feature's 1e-5 moves a box's
    # delta, which the box's side (up to the image's) scales
    close(got["boxes"] / cfg.img_size, np.asarray(want["boxes"]) / cfg.img_size, TOL, "boxes")
    close(got["scores"], want["scores"], TOL, "scores")
    # masks at 1e-4 of their largest magnitude: the cascade's boxes move by
    # those rounding steps three times before the masks sample the maps
    top = np.abs(np.asarray(want["masks"])).max()
    close(got["masks"] / top, np.asarray(want["masks"]) / top, TOL, "masks")
    np.testing.assert_array_equal(got["labels"].numpy(), np.asarray(want["labels"]))


def _train_inputs(seed=16):
    gt_boxes, gt_labels, gt_valid = _gt(seed)
    masks = np.zeros((2, 3, 64, 64), np.float32)
    for b in range(2):
        for g in range(3):
            x0, y0, x1, y1 = gt_boxes[b, g].astype(int)
            masks[b, g, y0:y1, x0:x1] = 1.0
    return images(seed=seed), gt_boxes, gt_labels, gt_valid, masks


@functools.lru_cache(maxsize=None)
def _jitted_value_and_grad(loss_fn):
    """One compiled program a loss function (pass the same function object
    to reuse it)."""
    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def jax_value_and_grad_f64(loss_fn, params, *arrays):
    """JAX's (loss, logs) and gradient tree of ``loss_fn(params, *arrays)``
    computed in float64, as numpy. The reference in fp32 is the less exact
    side here: its gradient of the mask head's first conv lies 5.5e-3 of
    that leaf's largest from its own float64 value (XLA on the CPU), where
    the port's fp32 lies within 2e-6."""
    def f64(a):
        a = np.asarray(a)
        return jnp.asarray(a, jnp.float64 if a.dtype == np.float32 else a.dtype)

    with jax.enable_x64(True), warnings.catch_warnings():
        # the reference scatters int64 iota into int32 labels under x64
        warnings.simplefilter("ignore", FutureWarning)
        (loss, logs), grads = _jitted_value_and_grad(loss_fn)(
            jax.tree.map(f64, params), *map(f64, arrays))
        return float(loss), {k: float(v) for k, v in logs.items()}, jax.tree.map(np.asarray, grads)


def check_grads(grads, want):
    """Every leaf's gradient within GRAD_TOL of that leaf's largest JAX
    gradient; a leaf whose JAX gradient is zero but for rounding (below
    1e-6 of the tree's largest: a conv bias that a GroupNorm cancels) is so
    in the port too."""
    flat, jflat = leaves_with_path(grads), leaves_with_path(want)
    assert [p for p, _ in flat] == [p for p, _ in jflat]
    largest = max(np.abs(g).max() for _, g in jflat)
    for (path, g), (_, w) in zip(flat, jflat):
        top = np.abs(w).max()
        if top < 1e-6 * largest:
            assert np.abs(g).max() < 1e-6 * largest, path
            continue
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_TOL * top, err_msg=str(path))


def port_loss_and_grads(loss_fn, params):
    """(loss, logs, numpy gradient tree) of ``loss_fn(tree)`` at ``params``."""
    tree = convert.from_numpy(params, "cpu")
    leaves = [leaf for _, leaf in leaves_with_path(tree)]
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss, logs = loss_fn(tree)
    loss.backward()
    return loss, logs, convert.to_numpy(unflatten_like(tree, [leaf.grad for leaf in leaves]))


def check_train(port, want, keys):
    """The port's (loss, logs, grads) against JAX's float64 ones."""
    loss, logs, grads = port
    jl, jlogs, jgrads = want
    np.testing.assert_allclose(loss.item(), jl, rtol=LOSS_RTOL)
    assert set(logs) == set(jlogs) == set(keys)
    for k in logs:
        np.testing.assert_allclose(logs[k].item(), jlogs[k], rtol=LOSS_RTOL, atol=1e-7,
                                   err_msg=k)
    check_grads(grads, jgrads)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_forward_train_losses_logs_and_grads_match_jax(name):
    cfg, jcfg, params = _model(name)
    x, gt_boxes, gt_labels, gt_valid, masks = _train_inputs()
    want = jax_value_and_grad_f64(
        lambda p, *a: jmrcnn.forward_train(p, *a[:4], jcfg, gt_masks=a[4]), params,
        x, gt_boxes, gt_labels, gt_valid, masks)
    args = [_t(a) for a in (x, gt_boxes, gt_labels, gt_valid)]
    port = port_loss_and_grads(
        lambda p: mask_rcnn.forward_train(p, *args, cfg, gt_masks=_t(masks)), params)
    check_train(port, want, {"rpn_cls", "rpn_reg", "mask"} | {
        f"stage{i}" for i in range(cfg.rcnn.num_stages)})
    assert port[1]["mask"].item() > 0  # positives reach the mask head


def test_mask_targets_equal_the_gathered_crops():
    """The crops sampled from every mask and selected after equal the
    reference's gather-then-sample."""
    from metatransformer_tpu.ops.ms_deform_attn import bilinear_sample as jbilinear

    _, gt_boxes, _, _, masks = _train_inputs(seed=17)
    rng = np.random.default_rng(18)
    boxes = _boxes(rng, (2, 5))
    best = rng.integers(0, 3, (2, 5))
    got = mask_rcnn.mask_targets(_t(masks), _t(boxes), _t(best), 14, 64)
    g = (np.arange(14) + 0.5) / 14
    gy, gx = np.meshgrid(g, g, indexing="ij")
    w, h = boxes[..., 2] - boxes[..., 0], boxes[..., 3] - boxes[..., 1]
    px = (boxes[..., 0:1] + gx.reshape(-1) * w[..., None]) / 64
    py = (boxes[..., 1:2] + gy.reshape(-1) * h[..., None]) / 64
    gm = np.take_along_axis(masks, best[..., None, None], 1).reshape(10, 64, 64, 1)
    want = jbilinear(jnp.asarray(gm), jnp.asarray(np.stack([px, py], -1).reshape(10, -1, 2),
                                                  jnp.float32))
    close(got, np.asarray(want).reshape(2, 5, 14, 14), 1e-5)
