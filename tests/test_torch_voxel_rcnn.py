"""The port's Voxel R-CNN (models/voxel_rcnn.py) against the JAX package on
the CPU, FP32, at the recipe's smoke geometry (the KITTI-like 6.4 m range,
128 points a cloud, a 3^3 grid over 16 RoIs from 64 proposals), with
seeded weights carried across.

The discrete choices are held exactly: the proposals' top-k and NMS keeps,
the rank-based RoI sampling (not random, as in the reference: ``ROADMAP.md``
queue 3). The RoI grid points at 1e-5 (``tests/test_voxel_rcnn.py``), the
pooled features, losses and refined boxes at 1e-5, every gradient leaf
within GRAD_TOL of its largest JAX value. JAX's whole step (forward, loss,
gradient and the intermediate products) is one jitted call.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metatransformer_tpu.models import second as jsecond
from metatransformer_tpu.models import voxel_rcnn as jvr
from metatransformer_tpu_torch import recipes
from metatransformer_tpu_torch.configs import load_config
from metatransformer_tpu_torch.core import convert
from metatransformer_tpu_torch.models import second, voxel_rcnn as vr
from tests.test_torch_detector3d import (TOL, _t, check_predictions, check_train, close,
                                         det3d_batch, port_loss_and_grads)
from tests.test_torch_vit_adapter import perturb

torch.set_num_threads(1)
GRID_TOL = 1e-5


def jax_cfg(cfg):
    """The JAX twin of a port config (nested frozen dataclasses of the same
    fields)."""
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["stage1"] = jsecond.SECONDConfig(**fields["stage1"].__dict__)
    if "pool_layers" in fields:
        fields["pool_layers"] = tuple((s, jvr.PoolLayerConfig(**p.__dict__))
                                      for s, p in fields["pool_layers"])
    return fields


def smoke_cfg():
    return recipes.two_stage_config(
        "voxel_rcnn", load_config("metatransformer_tpu/configs/kitti_voxel_rcnn.yaml"), True)


def on_proposals(batch, rois):
    """The batch with each sample's ground truth moved onto one of the
    model's own proposals (shifted 5 cm), so that the foreground branch
    (the canonical transform, the box and corner losses) runs: seeded
    weights propose nothing near the synthetic boxes."""
    batch = dict(batch, gt_boxes=batch["gt_boxes"].copy())
    batch["gt_boxes"][:, 0] = rois[:, 1] + np.asarray([0.05, 0, 0, 0, 0, 0, 0], np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def _setup():
    """(JAX cfg, port cfg, numpy params, batch, anchors): the port's seeded
    weights, perturbed, are both packages' weights."""
    cfg = smoke_cfg()
    jcfg = jvr.VoxelRCNNConfig(**jax_cfg(cfg))
    tree = perturb(convert.to_numpy(vr.init(cfg, torch.Generator().manual_seed(0), "cpu")), 4)
    anchors = second.generate_anchors(cfg.stage1)
    batch = det3d_batch(6)
    preds = vr.forward_stage1(convert.from_numpy(tree, "cpu"), _t(batch["points"]), cfg)[0]
    rois = vr.propose(preds, _t(anchors), cfg)[0].numpy()
    return jcfg, cfg, tree, on_proposals(batch, rois), anchors


@functools.lru_cache(maxsize=None)
def _jax_run():
    """JAX's training loss, logs and gradients, with the products of each
    stage along the way, in one jitted call."""
    jcfg, _, tree, batch, anchors = _setup()
    args = [jnp.asarray(batch[k]) for k in ("points", "gt_boxes", "gt_valid")]

    def loss(p):
        total, logs = jvr.training_loss(p, args[0], args[1], args[2], jnp.asarray(anchors), jcfg)
        preds, ms, _ = jvr.forward_stage1(p, args[0], jcfg)
        preds = jax.tree.map(jax.lax.stop_gradient, preds)
        rois, scores, valid = jvr.propose(preds, jnp.asarray(anchors), jcfg)
        targets = jax.vmap(lambda r, rv, g, gv: jvr.sample_rois_for_rcnn(r, rv, g, gv, jcfg))(
            rois, valid, args[1], args[2])
        pooled = jvr.roi_grid_pool(p, ms, targets["rois"], jcfg)
        return total, (logs, preds, (rois, scores, valid), targets, pooled)

    (total, aux), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree.map(jnp.asarray, tree))
    return total, aux, grads


def test_grid_points_and_offset_template_match_jax():
    rng = np.random.default_rng(0)
    rois = np.concatenate([rng.uniform(-3, 3, (5, 3)), rng.uniform(1, 4, (5, 3)),
                           rng.uniform(-3, 3, (5, 1))], -1).astype(np.float32)
    close(vr.roi_grid_points(_t(rois), 3), jvr.roi_grid_points(jnp.asarray(rois), 3), GRID_TOL)
    for radius, nsample in ((4.0, 16), (1.0, 64), (2.5, 8)):
        np.testing.assert_array_equal(vr._offset_template(radius, nsample),
                                      jvr._offset_template(radius, nsample))


def test_decode_refined_and_corner_loss_match_jax():
    rng = np.random.default_rng(1)
    rois = np.concatenate([rng.uniform(-3, 3, (6, 3)), rng.uniform(1, 4, (6, 3)),
                           rng.uniform(-3, 3, (6, 1))], -1).astype(np.float32)
    reg = rng.normal(0, 0.3, (6, 7)).astype(np.float32)
    refined = vr.decode_refined(_t(rois), _t(reg))
    close(refined, jvr.decode_refined(jnp.asarray(rois), jnp.asarray(reg)), TOL)
    gt = rois + rng.normal(0, 0.2, rois.shape).astype(np.float32)
    close(vr.corner_loss(refined, _t(gt)),
          jvr.corner_loss(jnp.asarray(np.asarray(refined)), jnp.asarray(gt)), TOL)


def test_stage1_matches_jax():
    _, cfg, tree, batch, _ = _setup()
    preds, _, _ = vr.forward_stage1(convert.from_numpy(tree, "cpu"), _t(batch["points"]), cfg)
    want = _jax_run()[1][1]
    for k in preds:
        close(preds[k], want[k], TOL, k)


def test_proposals_equal_jax():
    """On JAX's stage-1 outputs: the same top-k, NMS keeps and boxes."""
    _, cfg, _, _, anchors = _setup()
    _, (_, preds, want, _, _), _ = _jax_run()
    got = vr.propose({k: _t(v) for k, v in preds.items()}, _t(anchors), cfg)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    close(got[0], want[0], TOL, "rois")
    close(got[1], want[1], TOL, "scores")
    assert got[2].all()


def test_roi_sampling_equals_jax():
    """On JAX's proposals: the same sampled RoIs (rank-based: the top
    foregrounds by IoU, then hard before easy backgrounds) and targets."""
    _, cfg, _, batch, _ = _setup()
    _, (_, _, (rois, _, valid), want, _), _ = _jax_run()
    got = vr.sample_rois_for_rcnn(_t(rois), _t(valid), _t(batch["gt_boxes"]),
                                  _t(batch["gt_valid"]), cfg)
    assert set(got) == set(want)
    for k in got:
        if got[k].dtype == torch.bool:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
        else:
            close(got[k], want[k], TOL, k)
    assert got["reg_valid"].any() and not got["reg_valid"].all()


def test_roi_sampling_is_rank_based():
    """tests/test_voxel_rcnn.py's case: a near-perfect foreground first with
    soft label 1, easy backgrounds last with label 0; the same in JAX."""
    cfg = dataclasses.replace(smoke_cfg(), num_rois=4, fg_per=2)
    jcfg = jvr.VoxelRCNNConfig(**jax_cfg(cfg))
    gt = np.asarray([[[3.0, 0.0, -1.0, 3.9, 1.6, 1.5, 0.0], [0.0] * 7]], np.float32)
    gv = np.asarray([[True, False]])
    rois = np.asarray([[[3.05, 0.05, -1.0, 3.9, 1.6, 1.5, 0.0],
                        [3.5, 0.6, -1.0, 3.9, 1.6, 1.5, 0.2],
                        [10.0, 5.0, -1.0, 3.9, 1.6, 1.5, 0.0],
                        [11.0, -5.0, -1.0, 3.9, 1.6, 1.5, 0.0],
                        [12.0, 4.0, -1.0, 3.9, 1.6, 1.5, 0.0]]], np.float32)
    rv = np.ones((1, 5), bool)
    got = vr.sample_rois_for_rcnn(_t(rois), _t(rv), _t(gt), _t(gv), cfg)
    want = jvr.sample_rois_for_rcnn(*map(jnp.asarray, (rois[0], rv[0], gt[0], gv[0])), jcfg)
    for k in got:
        close(got[k][0].float(), np.asarray(want[k], np.float32), TOL, k)
    close(got["rois"][0, 0], rois[0, 0], 0, "first")
    assert got["cls_labels"][0, 0] == 1.0 and got["cls_labels"][0, -1] == 0.0


def test_grid_pool_matches_jax():
    """The pooled RoI grid over the port's own sparse features, on JAX's
    sampled RoIs."""
    _, cfg, tree, batch, _ = _setup()
    params = convert.from_numpy(tree, "cpu")
    _, ms, _ = vr.forward_stage1(params, _t(batch["points"]), cfg)
    _, (_, _, _, targets, want), _ = _jax_run()
    got = vr.roi_grid_pool(params, ms, _t(targets["rois"]), cfg)
    close(got, want, TOL)
    assert (got != 0).float().mean() > 0.05  # RoIs do reach voxels


def test_training_loss_and_gradients_match_jax():
    _, cfg, tree, batch, anchors = _setup()
    total, (logs, *_), grads = _jax_run()
    args = [_t(batch[k]) for k in ("points", "gt_boxes", "gt_valid")]
    port = port_loss_and_grads(lambda p: vr.training_loss(p, *args, _t(anchors), cfg), tree)
    check_train(port, (total, logs, grads))
    assert port[1]["rcnn_reg"] > 0  # foreground RoIs reach the box loss


def test_predict_equals_jax():
    jcfg, cfg, tree, batch, anchors = _setup()
    want = jvr.predict(jax.tree.map(jnp.asarray, tree), jnp.asarray(batch["points"]),
                       jnp.asarray(anchors), jcfg, score_thr=0.0, max_out=8)
    got = vr.predict(convert.from_numpy(tree, "cpu"), _t(batch["points"]), _t(anchors), cfg,
                     score_thr=0.0, max_out=8)
    check_predictions(got, want)


def test_init_tree_has_jax_keys_and_shapes():
    jcfg, cfg, tree, _, _ = _setup()
    want = jax.eval_shape(lambda k: jvr.init(jcfg, k), jax.random.PRNGKey(0))
    assert jax.tree.map(np.shape, tree) == jax.tree.map(lambda s: s.shape, want)


def test_init_takes_the_card_or_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        vr.init(smoke_cfg(), torch.Generator().manual_seed(0))
