"""The port's PV-RCNN++ (models/pv_rcnn_pp.py) against the JAX package on
the CPU, FP32, at the recipe's smoke geometry (24 keypoints in 4 sectors
from 128 points a cloud, two VectorPool sources, 8 RoIs), with the port's
seeded weights, perturbed, carried across.

The sectorized proposal-centric keypoints are held exactly (FPS's plain
version on the CPU against the reference's, index for index), the
VectorPool at 1e-5 (``tests/test_pv_rcnn_pp.py``) on points clear of each
cube's faces, chunked and whole, batched and flat; the losses,
predictions and every gradient leaf as in tests/test_torch_pv_rcnn.py.
JAX's whole step is one jitted call.

The keypoints' fused features and point logits are held against the
reference's float64 run, on the keypoints of the fp32 run (the reference's
FPS does not run under x64): the port's float64 at 1e-5, and the port's
fp32 too, the logits at 1e-5 and the fused features at ``FUSED_F32_TOL``.
The fused features sit at the end of a chain of some twenty convolutions
and norms, and either package's fp32 stands near 1e-5 from float64 there.
Over ten seeds of weights and points (0-9, this test's among them, the
``close`` measure, on a CPU), the reference's own fp32 fused features came
up to 1.98e-5 from its float64 and the port's up to 2.33e-5; the logits
1.36e-6 and 1.94e-6. So no fp32 pair holds at 1e-5 on every CPU, and the
fp32 gate is 1.5 x the reference's own furthest. The two float64 runs stand
up to 8e-6 apart: the reference's sparse convs accumulate in fp32 even under
x64 (``preferred_element_type``).
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metatransformer_tpu.models import pv_rcnn_pp as jpp
from metatransformer_tpu_torch import recipes
from metatransformer_tpu_torch.configs import load_config
from metatransformer_tpu_torch.core import convert
from metatransformer_tpu_torch.models import pv_rcnn_pp as pp, second, voxel_rcnn as vr
from tests.test_torch_detector3d import (TOL, _t, check_predictions, check_train, close,
                                         det3d_batch, port_loss_and_grads)
from tests.test_torch_vit_adapter import perturb
from tests.test_torch_voxel_rcnn import jax_cfg, on_proposals

torch.set_num_threads(1)
POOL_TOL = 1e-5
FUSED_F32_TOL = 3e-5  # 1.5 x the reference's fp32 fused features' furthest from float64


def smoke_cfg():
    return recipes.two_stage_config(
        "pv_rcnn_pp", load_config("metatransformer_tpu/configs/kitti_pv_rcnn_pp.yaml"), True)


def to_jax_vp(vp):
    return jpp.VectorPoolConfig(**vp.__dict__)


def to_jax_cfg(cfg):
    fields = jax_cfg(cfg)
    fields["vp_layers"] = tuple((s, to_jax_vp(v)) for s, v in cfg.vp_layers)
    fields["roi_vp"] = to_jax_vp(cfg.roi_vp)
    return jpp.PVRCNNPPConfig(**fields)


def clear_of_faces(centers, points, radius, margin=1e-5):
    """A valid mask of the points whose offset from no centre of the same
    sample lies within ``margin`` of a cube face or a sub-voxel wall."""
    rel = points[:, None].astype(np.float64) - centers[:, :, None]
    near = (np.abs(np.abs(rel) - radius) < margin) | (np.abs(rel) < margin)
    return ~near.any(-1).any(1)


@pytest.mark.parametrize("chunk, flat", [(16, False), (1024, False), (8, True)])
def test_vector_pool_matches_jax(chunk, flat):
    rng = np.random.default_rng(chunk)
    vp = pp.VectorPoolConfig(2, 0.7, 6, 4, 8)
    centers = rng.uniform(-1, 1, (2, 40, 3)).astype(np.float32)
    points = rng.uniform(-1, 1, (2, 30, 3)).astype(np.float32)
    feats = rng.standard_normal((2, 30, 5)).astype(np.float32)
    if flat:  # one point list for the batch, a sample mask each
        points, feats = points[0], feats[0]
        clear = clear_of_faces(centers, np.broadcast_to(points, (2, 30, 3)), vp.radius)
        valid = np.stack([np.arange(30) < 20, np.arange(30) >= 10]) & clear
    else:
        valid = clear = clear_of_faces(centers, points, vp.radius)
    assert (~clear).sum() < 10
    params = {"local_w": rng.standard_normal((8, 8, 4)).astype(np.float32),
              "post": {"w": rng.standard_normal((32, 8)).astype(np.float32),
                       "b": rng.standard_normal(8).astype(np.float32) * 0.1}}
    want = jpp.vector_pool(*map(jnp.asarray, (centers, points, feats, valid)), to_jax_vp(vp),
                           jax.tree.map(jnp.asarray, params), chunk=chunk)
    got = pp.vector_pool(*map(_t, (centers, points, feats, valid)), vp,
                         convert.from_numpy(params, "cpu"), chunk=chunk)
    close(got, want, POOL_TOL)
    assert (got != 0).any(-1).float().mean() > 0.5


def test_vector_pool_members_take_the_first_in_the_cube():
    ctr = torch.zeros(1, 1, 3)
    points = torch.tensor([[[5.0, 5.0, 5.0], [0.5, 0.5, 0.5], [-0.5, 0.1, 0.2],
                            [0.2, -0.9, 0.1]]])
    vp = pp.VectorPoolConfig(2, 1.0, 2, 4, 8)
    idx, keep, sid = pp.vector_pool_members(ctr, points, torch.ones(1, 4, dtype=torch.bool), vp)
    assert idx[0, 0].tolist() == [1, 2] and keep.all()
    assert sid[0, 0].tolist() == [7, 3]  # octants (+,+,+) and (-,+,+): (x * 2 + y) * 2 + z


@functools.lru_cache(maxsize=None)
def _setup():
    cfg = smoke_cfg()
    tree = perturb(convert.to_numpy(pp.init(cfg, torch.Generator().manual_seed(0), "cpu")), 6)
    anchors = second.generate_anchors(cfg.stage1)
    batch = det3d_batch(7)
    preds = vr.forward_stage1(convert.from_numpy(tree, "cpu"), _t(batch["points"]),
                              pp.as_voxel_rcnn(cfg))[0]
    rois = vr.propose(preds, _t(anchors), pp.as_voxel_rcnn(cfg))[0].numpy()
    return to_jax_cfg(cfg), cfg, tree, on_proposals(batch, rois), anchors


@functools.lru_cache(maxsize=None)
def _jax_run():
    """JAX's training loss, logs and gradients, with the keypoints and
    point logits of its inference path, in one jitted call."""
    jcfg, _, tree, batch, anchors = _setup()
    args = [jnp.asarray(batch[k]) for k in ("points", "gt_boxes", "gt_valid")]
    mask = jnp.ones(args[0].shape[:2], bool)
    vcfg = jpp._as_vr(jcfg)

    def loss(p):
        total, logs = jpp.training_loss(p, args[0], args[1], args[2], jnp.asarray(anchors), jcfg)
        preds, ms, bev = jpp.vr.forward_stage1(p, args[0], vcfg, mask)
        rois, _, valid = jpp.vr.propose(preds, jnp.asarray(anchors), vcfg)
        keypoints, fused, pre = jpp._vsa(p, args[0], mask, ms, bev, rois, valid, jcfg)
        logits = jpp.pv.point_head(p, pre, jpp._pt_cfg(jcfg))
        return total, (logs, rois, valid, keypoints, fused, logits)

    (total, aux), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree.map(jnp.asarray, tree))
    return total, aux, grads


def _wide(a):
    a = np.asarray(a)
    return a.astype(np.float64) if a.dtype == np.float32 else a


def float64_features(keypoints, rois, valid):
    """(JAX's, the port's) (fused features, point logits) of the VSA in
    float64 on both sides, on the given keypoints, proposals and flags."""
    jcfg, cfg, tree, batch, _ = _setup()
    with jax.enable_x64(True), mock.patch.object(
            jpp, "spc_sampling", lambda *_: jnp.asarray(_wide(keypoints))):
        def features(p, pts, r, v):
            mask = jnp.ones(pts.shape[:2], bool)
            _, ms, bev = jpp.vr.forward_stage1(p, pts, jpp._as_vr(jcfg), mask)
            _, fused, pre = jpp._vsa(p, pts, mask, ms, bev, r, v, jcfg)
            return fused, jpp.pv.point_head(p, pre, jpp._pt_cfg(jcfg))

        want = jax.tree.map(np.asarray, jax.jit(features)(
            jax.tree.map(lambda a: jnp.asarray(_wide(a)), tree),
            *(jnp.asarray(_wide(a)) for a in (batch["points"], rois, valid))))
    params = convert.from_numpy(jax.tree.map(_wide, tree), "cpu")
    pts = torch.tensor(_wide(batch["points"]))
    mask = torch.ones(pts.shape[:2], dtype=torch.bool)
    _, ms, bev = vr.forward_stage1(params, pts, pp.as_voxel_rcnn(cfg), mask)
    with mock.patch.object(pp, "spc_sampling", lambda *_: torch.tensor(_wide(keypoints))):
        _, fused, pre = pp.voxel_set_abstraction(params, pts, mask, ms, bev,
                                                 torch.tensor(_wide(rois)), torch.tensor(valid),
                                                 cfg)
    return want, (fused, pp.pv.point_head(params, pre, pp._pv_like(cfg)))


def test_keypoints_and_their_features_match_jax():
    """Inference's SPC keypoints (equal) on the port's own proposals (equal
    to JAX's), in fp32; their fused features and point logits on those
    keypoints, the port's fp32 and float64 against the reference's
    float64."""
    _, cfg, tree, batch, anchors = _setup()
    _, (_, jrois, jvalid, jkp, _, _), _ = _jax_run()
    params = convert.from_numpy(tree, "cpu")
    pts = _t(batch["points"])
    mask = torch.ones(pts.shape[:2], dtype=torch.bool)
    vcfg = pp.as_voxel_rcnn(cfg)
    preds, ms, bev = vr.forward_stage1(params, pts, vcfg, mask)
    rois, _, valid = vr.propose(preds, _t(anchors), vcfg)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    close(rois, jrois, TOL, "rois")
    kp, fused, pre = pp.voxel_set_abstraction(params, pts, mask, ms, bev, rois, valid, cfg)
    np.testing.assert_array_equal(kp.numpy(), np.asarray(jkp))
    logits = pp.pv.point_head(params, pre, pp._pv_like(cfg))
    assert fused.dtype == logits.dtype == torch.float32
    (jfused, jlogits), (fused64, logits64) = float64_features(kp.numpy(), rois.numpy(),
                                                              valid.numpy())
    assert fused64.dtype == torch.float64 and jfused.dtype == np.float64
    close(fused64, jfused, TOL, "float64 fused")
    close(logits64, jlogits, TOL, "float64 point logits")
    close(fused, jfused, FUSED_F32_TOL, "fp32 fused")
    close(logits, jlogits, TOL, "fp32 point logits")
    assert kp.shape[1] == cfg.num_sectors * (cfg.num_keypoints // cfg.num_sectors)


def test_training_loss_and_gradients_match_jax():
    _, cfg, tree, batch, anchors = _setup()
    total, (logs, *_), grads = _jax_run()
    args = [_t(batch[k]) for k in ("points", "gt_boxes", "gt_valid")]
    port = port_loss_and_grads(lambda p: pp.training_loss(p, *args, _t(anchors), cfg), tree)
    check_train(port, (total, logs, grads))
    assert port[1]["rcnn_reg"] > 0 and port[1]["point_cls"] > 0


def test_predict_equals_jax():
    jcfg, cfg, tree, batch, anchors = _setup()
    want = jpp.predict(jax.tree.map(jnp.asarray, tree), jnp.asarray(batch["points"]),
                       jnp.asarray(anchors), jcfg, score_thr=0.0, max_out=8)
    got = pp.predict(convert.from_numpy(tree, "cpu"), _t(batch["points"]), _t(anchors), cfg,
                     score_thr=0.0, max_out=8)
    check_predictions(got, want)


def test_init_tree_has_jax_keys_and_shapes():
    jcfg, _, tree, _, _ = _setup()
    want = jax.eval_shape(lambda k: jpp.init(jcfg, k), jax.random.PRNGKey(0))
    assert jax.tree.map(np.shape, tree) == jax.tree.map(lambda s: s.shape, want)


def test_init_takes_the_card_or_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pp.init(smoke_cfg(), torch.Generator().manual_seed(0))
