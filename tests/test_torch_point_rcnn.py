"""The port's PointRCNN (models/point_rcnn.py) against the JAX package on the
CPU, FP32, at the recipe's smoke geometry (128 points a cloud, two MSG
stages of 32 and 8 centres, 8 RoIs from 64 proposals, 16 pooled points a
RoI), with the port's seeded weights, perturbed, carried across.

The point coder round-trips and matches at 1e-4 (``CODER_TOL``, as the
anchor coder's); the ball group at ``BALL_TOL`` on points clear of each
radius (the in-radius test is on ``aa + bb - 2 ab``: a point within
rounding of the radius may fall either side in either package); the
discrete choices exactly: the point targets, the proposals' top-k and NMS
keeps, the pooled points of each RoI. The forward, pooled features, losses
and predictions at 1e-5, every gradient leaf within GRAD_TOL of its largest
reference value (tests/test_torch_detector3d.py's ``check_train``). The
reference's whole step is one jitted call.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metatransformer_tpu.models import point_rcnn as jprc
from metatransformer_tpu_torch import recipes
from metatransformer_tpu_torch.configs import load_config
from metatransformer_tpu_torch.core import convert
from metatransformer_tpu_torch.models import point_rcnn as prc
from metatransformer_tpu_torch.models import pv_rcnn as pv
from tests.test_torch_detector3d import (CODER_TOL, TOL, _t, check_predictions, check_train,
                                         close, det3d_batch, port_loss_and_grads)
from tests.test_torch_pv_rcnn import BALL_TOL, _mlp, clear_of_radius
from tests.test_torch_vit_adapter import perturb
from tests.test_torch_voxel_rcnn import on_proposals

torch.set_num_threads(1)


def smoke_cfg():
    return recipes.point_rcnn_config(
        load_config("metatransformer_tpu/configs/kitti_point_rcnn.yaml"), True)


def to_jax_cfg(cfg):
    fields = {k: getattr(cfg, k) for k in cfg.__dataclass_fields__}
    for k in ("sa_stages", "roi_sa_stages"):
        fields[k] = tuple(jprc.SAStage(**s.__dict__) for s in fields[k])
    return jprc.PointRCNNConfig(**fields)


def random_boxes(rng, n):
    return np.concatenate([rng.uniform(-3, 3, (n, 3)), rng.uniform(0.5, 4, (n, 3)),
                           rng.uniform(-3, 3, (n, 1))], -1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _setup():
    """(JAX cfg, port cfg, numpy weights, batch with its ground truth on
    the model's own proposals)."""
    cfg = smoke_cfg()
    tree = perturb(convert.to_numpy(prc.init(cfg, torch.Generator().manual_seed(0), "cpu")), 4)
    batch = det3d_batch(6, num_classes=3)
    pts = _t(batch["points"])
    with torch.no_grad():
        _, cls, box = prc.forward(convert.from_numpy(tree, "cpu"), pts, cfg)
        rois = prc.propose(pts[..., :3], cls, box, torch.ones(pts.shape[:2], dtype=torch.bool),
                           cfg)[0].numpy()
    return to_jax_cfg(cfg), cfg, tree, on_proposals(batch, rois)


_KEYS = ("points", "gt_boxes", "gt_labels", "gt_valid")


@functools.lru_cache(maxsize=None)
def _jax_run():
    """The reference's loss, logs, gradients and forward products, one
    jitted call."""
    jcfg, _, tree, batch = _setup()
    args = [jnp.asarray(batch[k]) for k in _KEYS]

    def loss(p):
        total, logs = jprc.training_loss(p, *args, jcfg)
        pf, cls, box = jprc.forward(p, args[0], jcfg)
        xyz = args[0][..., :3]
        mask = jnp.ones(xyz.shape[:2], bool)
        sg = jax.lax.stop_gradient
        props = jprc.propose(xyz, sg(cls), sg(box), mask, jcfg)
        targets = jax.vmap(lambda r, rv, g, gv: jprc.vr.sample_rois_for_rcnn(
            r, rv, g, gv, jprc._as_vr(jcfg)))(props[0], props[2], args[1], args[3])
        scores = jnp.max(jax.nn.sigmoid(cls), -1)
        pooled = jprc.roi_point_pool(xyz, jnp.concatenate([scores[..., None], pf], -1), mask,
                                     targets["rois"], jcfg.num_sampled_points)
        return total, (logs, (pf, cls, box), props, targets, pooled)

    (total, aux), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree.map(jnp.asarray, tree))
    return total, aux, grads


def test_point_coder_round_trips_and_matches_jax():
    rng = np.random.default_rng(0)
    gt = random_boxes(rng, 30)
    points = gt[:, :3] + rng.normal(0, 0.5, (30, 3)).astype(np.float32)
    classes = rng.integers(0, 4, 30)  # 3 past the last class takes the last
    enc = prc.point_encode_boxes(_t(gt), _t(points), _t(classes), prc.KITTI_MEAN_SIZES)
    close(enc, jprc.point_encode_boxes(*map(jnp.asarray, (gt, points, classes)),
                                       prc.KITTI_MEAN_SIZES), CODER_TOL)
    dec = prc.point_decode_boxes(enc, _t(points), _t(classes), prc.KITTI_MEAN_SIZES)
    close(dec[:, :6], gt[:, :6], CODER_TOL, "round trip")
    close(torch.remainder(dec[:, 6] - _t(gt[:, 6]) + np.pi, 2 * np.pi) - np.pi,
          np.zeros(30, np.float32), CODER_TOL, "heading")
    close(dec, jprc.point_decode_boxes(jnp.asarray(np.asarray(enc)), jnp.asarray(points),
                                       jnp.asarray(classes), prc.KITTI_MEAN_SIZES), CODER_TOL)


def test_ball_group_matches_jax_and_takes_the_first_in_radius():
    rng = np.random.default_rng(1)
    centers = rng.uniform(-1, 1, (2, 70, 3)).astype(np.float32)
    points = rng.uniform(-1, 1, (2, 40, 3)).astype(np.float32)
    feats = rng.standard_normal((2, 40, 5)).astype(np.float32)
    valid = clear_of_radius(centers, points, 0.7)
    valid[1, :6] = False
    stack = [_mlp(rng, 8, 6), _mlp(rng, 6, 6)]
    want = jprc.ball_group_mlp(*map(jnp.asarray, (centers, points, feats, valid)), 0.7, 4,
                               jax.tree.map(jnp.asarray, stack))
    for chunk in (16, 512):
        got = prc.ball_group_mlp(*map(_t, (centers, points, feats, valid)), 0.7, 4,
                                 convert.from_numpy(stack, "cpu"), chunk=chunk)
        close(got, want, BALL_TOL)
    assert (got == 0).all(-1).sum() > 0 and (got != 0).any(-1).sum() > 20
    idx, keep = pv.ball_members(_t(np.zeros((1, 1, 3), np.float32)),
                                _t(np.asarray([[[5, 5, 5], [0.1, 0, 0], [0, 0.2, 0], [0, 0, 0.3]]],
                                              np.float32)),
                                torch.tensor([[True, True, False, True]]), 0.5, 3)
    assert idx[0, 0, :2].tolist() == [1, 3] and keep[0, 0].tolist() == [True, True, False]


def test_forward_matches_jax():
    _, cfg, tree, batch = _setup()
    _, (_, want, *_), _ = _jax_run()
    with torch.no_grad():
        got = prc.forward(convert.from_numpy(tree, "cpu"), _t(batch["points"]), cfg)
    for g, w, what in zip(got, want, ("point features", "class logits", "box codes")):
        close(g, w, TOL, what)


def test_point_targets_equal_jax():
    jcfg, cfg, _, batch = _setup()
    rng = np.random.default_rng(2)
    xyz = np.concatenate([batch["gt_boxes"][:, :1, :3] + rng.uniform(-2.5, 2.5, (2, 300, 3)),
                          batch["points"][..., :3]], 1).astype(np.float32)
    args = (xyz, batch["gt_boxes"], batch["gt_labels"], batch["gt_valid"])
    got = prc.assign_point_targets(*map(_t, args), cfg)
    want = jprc.assign_point_targets(*map(jnp.asarray, args), jcfg)
    for g, w in zip(got, want):
        close(g, np.asarray(w), 0)
    assert {-1, 0} < set(got[0].unique().tolist())


def test_proposals_equal_jax():
    """On the reference's point-head outputs: the same top-k, NMS keeps and
    boxes."""
    _, cfg, _, batch = _setup()
    _, (_, (_, cls, box), want, _, _), _ = _jax_run()
    pts = _t(batch["points"])
    got = prc.propose(pts[..., :3], _t(cls), _t(box), torch.ones(pts.shape[:2], dtype=torch.bool),
                      cfg)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    close(got[0], want[0], TOL, "rois")
    close(got[1], want[1], TOL, "scores")
    assert got[2].all()


def test_roi_point_pool_matches_jax():
    """The pooled points of the reference's sampled RoIs: the same members,
    canonical coordinates and features."""
    _, cfg, _, batch = _setup()
    _, (_, (pf, cls, _), _, targets, want), _ = _jax_run()
    xyz = _t(batch["points"])[..., :3]
    feats = torch.cat([torch.sigmoid(_t(cls)).amax(-1, keepdim=True), _t(pf)], -1)
    got = prc.roi_point_pool(xyz, feats, torch.ones(xyz.shape[:2], dtype=torch.bool),
                             _t(targets["rois"]), cfg.num_sampled_points)
    close(got[0], want[0], TOL, "local xyz")
    close(got[1], want[1], TOL, "features")
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert not got[2].all() and (got[0] != 0).any()


def test_training_loss_and_gradients_match_jax():
    _, cfg, tree, batch = _setup()
    total, (logs, *_), grads = _jax_run()
    args = [_t(batch[k]) for k in _KEYS]
    port = port_loss_and_grads(lambda p: prc.training_loss(p, *args, cfg), tree)
    check_train(port, (total, logs, grads))
    assert port[1]["rcnn_reg"] > 0 and port[1]["point_box"] > 0  # foregrounds reach both heads


def test_predict_equals_jax():
    jcfg, cfg, tree, batch = _setup()
    want = jprc.predict(jax.tree.map(jnp.asarray, tree), jnp.asarray(batch["points"]), jcfg,
                        score_thr=0.0, max_out=8)
    got = prc.predict(convert.from_numpy(tree, "cpu"), _t(batch["points"]), cfg, score_thr=0.0,
                      max_out=8)
    check_predictions(got, want)


def test_init_tree_has_jax_keys_and_shapes():
    jcfg, _, tree, _ = _setup()
    want = jax.eval_shape(lambda k: jprc.init(jcfg, k), jax.random.PRNGKey(0))
    assert jax.tree.map(np.shape, tree) == jax.tree.map(lambda s: s.shape, want)


def test_init_takes_the_card_or_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        prc.init(smoke_cfg(), torch.Generator().manual_seed(0))
