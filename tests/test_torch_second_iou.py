"""The port's SECOND-IoU (models/second_iou.py) against the JAX package on
the CPU, FP32, at the recipe's smoke geometry (8 RoIs from 64 proposals, a
3 x 3 rotated window), with the port's seeded weights, perturbed, carried
across.

The rotated window at 1e-5 (``tests/test_second_iou.py``), also on RoIs
that run over the map's edge, where both packages keep the unclipped
corner's weights (``ROADMAP.md`` queue 3); the IoU logits, losses and
predictions at TOL and every gradient leaf within GRAD_TOL of its largest
JAX value (tests/test_torch_detector3d.py); the proposals, sampled RoIs and
NMS keeps exactly. JAX's whole step is one jitted call.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metatransformer_tpu.models import second_iou as jsi
from metatransformer_tpu_torch import recipes
from metatransformer_tpu_torch.configs import load_config
from metatransformer_tpu_torch.core import convert
from metatransformer_tpu_torch.models import second, second_iou as si, voxel_rcnn as vr
from tests.test_torch_detector3d import (TOL, _t, check_predictions, check_train, close,
                                         det3d_batch, port_loss_and_grads)
from tests.test_torch_vit_adapter import perturb
from tests.test_torch_voxel_rcnn import jax_cfg, on_proposals

torch.set_num_threads(1)
WINDOW_TOL = 1e-5


def smoke_cfg():
    return recipes.two_stage_config(
        "second_iou", load_config("metatransformer_tpu/configs/kitti_second_iou.yaml"), True)


def to_jax_cfg(cfg):
    return jsi.SECONDIoUConfig(**jax_cfg(cfg))


@pytest.mark.parametrize("edge", [False, True])
def test_rotated_window_matches_jax(edge):
    """Bilinear samples of a random BEV map at rotated RoI windows; with
    ``edge`` the RoIs reach past the map, where the clipped far corner keeps
    the unclipped weights (they do not sum to 1) in both packages."""
    cfg = smoke_cfg()
    rng = np.random.default_rng(int(edge))
    feat = rng.standard_normal((2, 8, 8, 5)).astype(np.float32)
    lo, hi = ([-1.0, -4.5], [7.5, 4.5]) if edge else ([1.0, -2.0], [5.0, 2.0])
    rois = np.concatenate([rng.uniform(lo, hi, (2, 6, 2)), rng.uniform(-2, 0, (2, 6, 1)),
                           rng.uniform(1, 4, (2, 6, 3)), rng.uniform(-3, 3, (2, 6, 1))],
                          -1).astype(np.float32)
    got = si.rotated_roi_grid_sample(_t(feat), _t(rois), cfg)
    want = jsi.rotated_roi_grid_sample(jnp.asarray(feat), jnp.asarray(rois), to_jax_cfg(cfg))
    close(got, want, WINDOW_TOL)
    if edge:  # on a constant map the border's weights sum to other than 1
        ones = si.rotated_roi_grid_sample(torch.ones(2, 8, 8, 1), _t(rois), cfg)
        assert (ones - 1).abs().max() > 0.05


@functools.lru_cache(maxsize=None)
def _setup():
    cfg = smoke_cfg()
    tree = perturb(convert.to_numpy(si.init(cfg, torch.Generator().manual_seed(0), "cpu")), 4)
    anchors = second.generate_anchors(cfg.stage1)
    batch = det3d_batch(6)
    preds = vr.forward_stage1(convert.from_numpy(tree, "cpu"), _t(batch["points"]),
                              si.as_voxel_rcnn(cfg))[0]
    rois = vr.propose(preds, _t(anchors), si.as_voxel_rcnn(cfg))[0].numpy()
    return to_jax_cfg(cfg), cfg, tree, on_proposals(batch, rois), anchors


@functools.lru_cache(maxsize=None)
def _jax_run():
    """JAX's training loss, logs and gradients with the sampled RoIs and
    their IoU logits, in one jitted call."""
    jcfg, _, tree, batch, anchors = _setup()
    args = [jnp.asarray(batch[k]) for k in ("points", "gt_boxes", "gt_valid")]
    vcfg = jsi._as_vr(jcfg)

    def loss(p):
        total, logs = jsi.training_loss(p, args[0], args[1], args[2], jnp.asarray(anchors), jcfg)
        preds, bev = jax.lax.stop_gradient(
            jsi.vr.forward_stage1(p, args[0], vcfg)[::2])
        rois, _, valid = jsi.vr.propose(preds, jnp.asarray(anchors), vcfg)
        targets = jax.vmap(lambda r, rv, g, gv: jsi.vr.sample_rois_for_rcnn(r, rv, g, gv, vcfg))(
            rois, valid, args[1], args[2])
        logits = jsi.iou_head(p, jsi.rotated_roi_grid_sample(bev, targets["rois"], jcfg), jcfg)
        return total, (logs, targets["rois"], logits)

    (total, aux), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree.map(jnp.asarray, tree))
    return total, aux, grads


def test_iou_head_on_the_sampled_rois_matches_jax():
    _, cfg, tree, batch, anchors = _setup()
    _, (_, jrois, jlogits), _ = _jax_run()
    params = convert.from_numpy(tree, "cpu")
    vcfg = si.as_voxel_rcnn(cfg)
    preds, _, bev = vr.forward_stage1(params, _t(batch["points"]), vcfg)
    rois, _, valid = vr.propose(preds, _t(anchors), vcfg)
    targets = vr.sample_rois_for_rcnn(rois, valid, _t(batch["gt_boxes"]), _t(batch["gt_valid"]),
                                      vcfg)
    close(targets["rois"], jrois, TOL, "sampled rois")
    close(si.iou_head(params, si.rotated_roi_grid_sample(bev, targets["rois"], cfg), cfg),
          jlogits, TOL, "iou logits")


def test_training_loss_and_gradients_match_jax():
    _, cfg, tree, batch, anchors = _setup()
    total, (logs, *_), grads = _jax_run()
    args = [_t(batch[k]) for k in ("points", "gt_boxes", "gt_valid")]
    port = port_loss_and_grads(lambda p: si.training_loss(p, *args, _t(anchors), cfg), tree)
    check_train(port, (total, logs, grads))
    assert port[1]["iou"] > 0


def test_the_rcnn_targets_take_this_configs_fg_per():
    """Unlike PV-RCNN's, SECOND-IoU's proposals and targets take its own
    ``fg_per``, as the reference builds them."""
    cfg = smoke_cfg()
    assert si.as_voxel_rcnn(cfg).fg_per == jsi._as_vr(to_jax_cfg(cfg)).fg_per == cfg.fg_per


def test_predict_equals_jax():
    jcfg, cfg, tree, batch, anchors = _setup()
    want = jsi.predict(jax.tree.map(jnp.asarray, tree), jnp.asarray(batch["points"]),
                       jnp.asarray(anchors), jcfg, score_thr=0.0, max_out=8)
    got = si.predict(convert.from_numpy(tree, "cpu"), _t(batch["points"]), _t(anchors), cfg,
                     score_thr=0.0, max_out=8)
    check_predictions(got, want)


def test_init_tree_has_jax_keys_and_shapes():
    jcfg, _, tree, _, _ = _setup()
    want = jax.eval_shape(lambda k: jsi.init(jcfg, k), jax.random.PRNGKey(0))
    assert jax.tree.map(np.shape, tree) == jax.tree.map(lambda s: s.shape, want)


def test_init_takes_the_card_or_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        si.init(smoke_cfg(), torch.Generator().manual_seed(0))
