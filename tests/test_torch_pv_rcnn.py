"""The port's PV-RCNN (models/pv_rcnn.py) against the JAX package on the
CPU, FP32, at the recipe's smoke geometry (32 keypoints from 128 points a
cloud, three set-abstraction sources, 8 RoIs), with seeded weights carried
across.

Index outputs are held exactly: the FPS keypoints (also with more samples
than points, where every point is taken and the plain version then repeats
index 0), the ball-group members, the proposals and sampled RoIs. The
chunked ball group at 1e-5 (``tests/test_pv_rcnn.py``), on points that lie
well inside or outside each radius: the in-radius test is on the expanded
``|c|^2 - 2 c.p + |p|^2``, so a point within rounding of the radius may
fall either side in either package (``ROADMAP.md`` queue 3). Losses,
predictions and every gradient leaf as in tests/test_torch_voxel_rcnn.py.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metatransformer_tpu.models import pv_rcnn as jpv
from metatransformer_tpu.models import voxel_rcnn as jvr
from metatransformer_tpu.ops import point_ops as jpo
from metatransformer_tpu_torch import recipes
from metatransformer_tpu_torch.configs import load_config
from metatransformer_tpu_torch.core import convert
from metatransformer_tpu_torch.models import pv_rcnn as pv, second, voxel_rcnn as vr
from metatransformer_tpu_torch.ops import point_ops
from tests.test_torch_detector3d import (TOL, _t, check_predictions, check_train, close,
                                         det3d_batch, port_loss_and_grads)
from tests.test_torch_vit_adapter import perturb
from tests.test_torch_voxel_rcnn import jax_cfg, on_proposals

torch.set_num_threads(1)
BALL_TOL = 1e-5


def to_jax_cfg(cfg):
    fields = jax_cfg(cfg)
    fields["sa_layers"] = tuple((s, jpv.SALayerConfig(**c.__dict__)) for s, c in cfg.sa_layers)
    return jpv.PVRCNNConfig(**fields)


def smoke_cfg():
    return recipes.two_stage_config(
        "pv_rcnn", load_config("metatransformer_tpu/configs/kitti_pv_rcnn.yaml"), True)


# --------------------------------------------------------------------------
# grouping, BEV sampling, keypoints
# --------------------------------------------------------------------------


def _mlp(rng, cin, cout):
    return {"w": rng.standard_normal((cin, cout)).astype(np.float32),
            "b": rng.standard_normal(cout).astype(np.float32) * 0.1}


def clear_of_radius(centers, points, radius, margin=1e-3):
    """A valid mask of the points no centre of the same sample has within
    ``margin`` of ``radius``."""
    d = np.linalg.norm(centers[:, :, None].astype(np.float64) - points[:, None], axis=-1)
    return ~(np.abs(d - radius) < margin).any(1)


@pytest.mark.parametrize("chunk, flat", [(32, False), (1024, False), (16, True)])
def test_ball_group_max_matches_jax(chunk, flat):
    rng = np.random.default_rng(0)
    centers = rng.uniform(-1, 1, (2, 70, 3)).astype(np.float32)
    points = rng.uniform(-1, 1, (2, 40, 3)).astype(np.float32)
    feats = rng.standard_normal((2, 40, 5)).astype(np.float32)
    if flat:  # one voxel list for the batch, a sample mask each
        points, feats = points[0], feats[0]
        clear = clear_of_radius(centers, np.broadcast_to(points, (2, 40, 3)), 0.7)
        valid = np.stack([np.arange(40) < 25, np.arange(40) >= 15]) & clear
    else:
        valid = clear = clear_of_radius(centers, points, 0.7)
    assert (~clear).sum() < 20
    mlp_a, mlp_b = _mlp(rng, 8, 6), _mlp(rng, 6, 6)
    want = jpv.ball_group_max(*map(jnp.asarray, (centers, points, feats, valid)), 0.7, 4,
                              jax.tree.map(jnp.asarray, mlp_a), jax.tree.map(jnp.asarray, mlp_b),
                              chunk=chunk)
    got = pv.ball_group_max(*map(_t, (centers, points, feats, valid)), 0.7, 4,
                            convert.from_numpy(mlp_a, "cpu"), convert.from_numpy(mlp_b, "cpu"),
                            chunk=chunk)
    close(got, want, BALL_TOL)
    assert (got == 0).all(-1).sum() > 0 and (got != 0).any(-1).sum() > 20  # empty and full balls


def test_ball_members_are_the_first_in_radius():
    centers = np.asarray([[[0.0, 0.0, 0.0], [10.0, 10.0, 10.0]]], np.float32)
    points = np.asarray([[[5.0, 5.0, 5.0], [0.1, 0.0, 0.0], [0.0, 0.2, 0.0],
                          [0.0, 0.0, 0.3]]], np.float32)
    idx, keep = pv.ball_members(_t(centers), _t(points), torch.ones(1, 4, dtype=torch.bool),
                                0.5, 2)
    assert idx[0, 0].tolist() == [1, 2] and keep[0, 0].all() and not keep[0, 1].any()


def test_bev_interpolate_matches_jax():
    cfg = smoke_cfg()
    rng = np.random.default_rng(1)
    feat = rng.standard_normal((2, 8, 8, 6)).astype(np.float32)
    kp = np.concatenate([rng.uniform([0, -3.2], [6.4, 3.2], (2, 30, 2)),
                         rng.uniform(-3, 2, (2, 30, 1))], -1).astype(np.float32)
    close(pv.bev_interpolate(_t(feat), _t(kp), cfg),
          jpv.bev_interpolate(jnp.asarray(feat), jnp.asarray(kp), to_jax_cfg(cfg)), TOL)


@pytest.mark.parametrize("b, n, g", [(2, 100, 32), (2, 100, 160), (1, 1024, 2048)])
def test_keypoints_equal_jax_with_more_samples_than_points(b, n, g):
    """masked_fps (the FPS kernel's plain version on the CPU) index for
    index against the reference's, with ragged masks; past n samples every
    point is taken, the running minimum is 0 everywhere and both repeat
    index 0."""
    rng = np.random.default_rng(n + g)
    pts = rng.uniform(-5, 5, (b, n, 3)).astype(np.float32)
    mask = np.ones((b, n), bool)
    mask[-1, n // 2:] = False
    got = point_ops.masked_fps(_t(pts), _t(mask), g)
    want = np.asarray(jpo.masked_fps(jnp.asarray(pts), jnp.asarray(mask), g))
    np.testing.assert_array_equal(got.numpy(), want)
    if g > n:
        assert (got[:, n:] == 0).all() and len(np.unique(got[0].numpy())) == mask[0].sum()


def test_point_head_targets_equal_jax():
    rng = np.random.default_rng(2)
    kp = rng.uniform(-4, 4, (2, 60, 3)).astype(np.float32)
    gt = np.asarray([[[0, 0, 0, 3.9, 1.6, 1.5, 0.3], [2, 2, 0, 2, 2, 2, 0]],
                     [[1, -1, 0, 3.0, 2.0, 3.0, -0.5], [0] * 7]], np.float32)
    gv = np.asarray([[True, True], [True, False]])
    got = pv.point_head_targets(_t(kp), _t(gt), _t(gv), 0.2)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jpv.point_head_targets(*map(jnp.asarray, (kp, gt, gv)), 0.2)))
    assert 0 < got.sum() < got.numel()


def test_moe_refine_matches_jax():
    """PVRCNNHeadMoE's gate, on source 1 of 2."""
    cfg = dataclasses.replace(smoke_cfg(), moe_sources=2)
    tree = perturb(convert.to_numpy(pv.init(cfg, torch.Generator().manual_seed(1), "cpu")), 5)
    pooled = np.random.default_rng(3).standard_normal(
        (2, cfg.num_rois, cfg.grid_size**3 * cfg.roi_mlp)).astype(np.float32)
    got = pv.refine(convert.from_numpy(tree, "cpu"), _t(pooled), cfg, source_id=1)
    want = jpv.refine(jax.tree.map(jnp.asarray, tree), jnp.asarray(pooled), to_jax_cfg(cfg),
                      source_id=1)
    close(got[0], want[0], TOL, "cls")
    close(got[1], want[1], TOL, "reg")


# --------------------------------------------------------------------------
# the whole model
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _setup():
    cfg = smoke_cfg()
    tree = perturb(convert.to_numpy(pv.init(cfg, torch.Generator().manual_seed(0), "cpu")), 6)
    anchors = second.generate_anchors(cfg.stage1)
    batch = det3d_batch(7)
    preds = pv.forward(convert.from_numpy(tree, "cpu"), _t(batch["points"]), cfg)[0]
    rois = vr.propose(preds, _t(anchors), pv.as_voxel_rcnn(cfg))[0].numpy()
    return to_jax_cfg(cfg), cfg, tree, on_proposals(batch, rois), anchors


@functools.lru_cache(maxsize=None)
def _jax_run():
    """JAX's training loss, logs and gradients, with its forward's outputs,
    in one jitted call."""
    jcfg, _, tree, batch, anchors = _setup()
    args = [jnp.asarray(batch[k]) for k in ("points", "gt_boxes", "gt_valid")]

    def loss(p):
        total, logs = jpv.training_loss(p, args[0], args[1], args[2], jnp.asarray(anchors), jcfg)
        preds, keypoints, weighted, pt_logits = jpv.forward(p, args[0], jcfg)
        return total, (logs, preds, keypoints, weighted, pt_logits)

    (total, aux), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree.map(jnp.asarray, tree))
    return total, aux, grads


def test_forward_matches_jax():
    """Stage 1, the FPS keypoints (equal), their weighted VSA features and
    the point head's logits."""
    _, cfg, tree, batch, _ = _setup()
    preds, keypoints, weighted, pt_logits = pv.forward(convert.from_numpy(tree, "cpu"),
                                                       _t(batch["points"]), cfg)
    _, (_, jpreds, jkeypoints, jweighted, jpt), _ = _jax_run()
    for k in preds:
        close(preds[k], jpreds[k], TOL, k)
    np.testing.assert_array_equal(keypoints.numpy(), np.asarray(jkeypoints))
    close(weighted, jweighted, TOL, "weighted")
    close(pt_logits, jpt, TOL, "point logits")
    assert (weighted != 0).any(-1).float().mean() > 0.5


def test_training_loss_and_gradients_match_jax():
    _, cfg, tree, batch, anchors = _setup()
    total, (logs, *_), grads = _jax_run()
    args = [_t(batch[k]) for k in ("points", "gt_boxes", "gt_valid")]
    port = port_loss_and_grads(lambda p: pv.training_loss(p, *args, _t(anchors), cfg), tree)
    check_train(port, (total, logs, grads))
    assert port[1]["rcnn_reg"] > 0 and port[1]["point_cls"] > 0


def test_the_rcnn_targets_take_voxel_rcnn_defaults():
    """As in the reference, the proposals and RoI targets run under Voxel
    R-CNN's config: PV-RCNN's own ``fg_per`` is not read."""
    cfg = smoke_cfg()
    vcfg = pv.as_voxel_rcnn(cfg)
    jvcfg = jpv._as_vr(to_jax_cfg(cfg))
    assert vcfg.fg_per == jvcfg.fg_per == jvr.VoxelRCNNConfig().fg_per != cfg.fg_per
    assert (vcfg.num_rois, vcfg.proposal_pre) == (jvcfg.num_rois, jvcfg.proposal_pre)


def test_predict_equals_jax():
    jcfg, cfg, tree, batch, anchors = _setup()
    want = jpv.predict(jax.tree.map(jnp.asarray, tree), jnp.asarray(batch["points"]),
                       jnp.asarray(anchors), jcfg, score_thr=0.0, max_out=8)
    got = pv.predict(convert.from_numpy(tree, "cpu"), _t(batch["points"]), _t(anchors), cfg,
                     score_thr=0.0, max_out=8)
    check_predictions(got, want)


def test_init_tree_has_jax_keys_and_shapes():
    jcfg, _, tree, _, _ = _setup()
    want = jax.eval_shape(lambda k: jpv.init(jcfg, k), jax.random.PRNGKey(0))
    assert jax.tree.map(np.shape, tree) == jax.tree.map(lambda s: s.shape, want)


def test_init_takes_the_card_or_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pv.init(smoke_cfg(), torch.Generator().manual_seed(0))
