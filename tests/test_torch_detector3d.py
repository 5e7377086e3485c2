"""The port's PointPillars and SECOND (models/detector3d.py,
models/second.py, the pillar VFE of ops/voxelize.py) against the JAX
package on the CPU, FP32, at the recipes' smoke geometry (the KITTI-like
6.4 m range, 128 points a cloud), every parameter tree perturbed with
seeded noise before it is carried across.

The discrete choices are held exactly: anchors, assignments (two ground
truths sharing their best anchor among them), top-k, NMS keeps, labels.
The box coder at 1e-4 (``tests/test_detector3d.py``), the predictions and
losses at 1e-5, every gradient leaf within GRAD_TOL of its largest JAX
value; the pillar max with exact ties, whose gradient ``amax`` splits as
``jax.ops.segment_max`` does.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metatransformer_tpu.models import detector3d as jdet
from metatransformer_tpu.models import second as jsecond
from metatransformer_tpu.ops import voxelize as jvox
from metatransformer_tpu_torch import recipes
from metatransformer_tpu_torch.core import convert
from metatransformer_tpu_torch.core.tree import leaves_with_path, unflatten_like
from metatransformer_tpu_torch.models import detector3d, second
from metatransformer_tpu_torch.ops import voxelize
from tests.test_torch_vit_adapter import close, perturb

torch.set_num_threads(1)
CODER_TOL = 1e-4
TOL = 1e-5
GRAD_TOL = 1e-4
SMOKE_RANGE = recipes._SMOKE_RANGE


def _t(a):
    return torch.tensor(np.asarray(a))


# --------------------------------------------------------------------------
# shared by the two-stage tests
# --------------------------------------------------------------------------


def det3d_batch(seed, b=2, n_points=128, num_classes=1):
    """The recipes' synthetic KITTI batch at smoke geometry (numpy)."""
    return next(iter(recipes._det3d_synth(SMOKE_RANGE, num_classes, n_points)(b, 1, seed)))[
        "input"]


def carried(jparams, seed):
    """JAX parameters perturbed with seeded noise: (numpy tree, port tree)."""
    tree = perturb(jax.tree.map(np.asarray, jparams), seed)
    return tree, convert.from_numpy(tree, "cpu")


def port_loss_and_grads(loss_fn, tree_np):
    """(loss, logs, numpy gradient tree) of ``loss_fn(tree)`` at the numpy
    parameters ``tree_np``."""
    tree = convert.from_numpy(tree_np, "cpu")
    leaves = [leaf for _, leaf in leaves_with_path(tree)]
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss, logs = loss_fn(tree)
    loss.backward()
    grads = [torch.zeros_like(x) if x.grad is None else x.grad for x in leaves]
    return loss, logs, convert.to_numpy(unflatten_like(tree, grads))


def check_train(port, want, loss_tol=TOL):
    """The port's (loss, logs, grads) against JAX's: the losses at
    ``loss_tol``, each gradient leaf within GRAD_TOL of that leaf's largest
    JAX value (a leaf JAX leaves at zero but for rounding, below 1e-6 of
    the tree's largest, is near zero in the port too)."""
    loss, logs, grads = port
    jloss, jlogs, jgrads = want
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=loss_tol, atol=loss_tol)
    assert set(logs) == set(jlogs)
    for k in logs:
        np.testing.assert_allclose(logs[k].item(), float(jlogs[k]), rtol=loss_tol, atol=loss_tol,
                                   err_msg=k)
    flat, jflat = leaves_with_path(grads), leaves_with_path(jax.tree.map(np.asarray, jgrads))
    assert [p for p, _ in flat] == [p for p, _ in jflat]
    largest = max(np.abs(g).max() for _, g in jflat)
    assert largest > 0
    for (path, g), (_, w) in zip(flat, jflat):
        top = np.abs(w).max()
        if top < 1e-6 * largest:
            assert np.abs(g).max() < 1e-5 * largest, path
            continue
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_TOL * top, err_msg=str(path))


def check_predictions(got, want, keys=("boxes", "scores", "valid")):
    """predict's dicts: indices-derived outputs equal, values at TOL."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in keys:
            if k in ("valid", "labels"):
                np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]), err_msg=k)
            else:
                close(g[k], w[k], 1e-4 if k == "boxes" else TOL, k)
        assert g["valid"].any()


# --------------------------------------------------------------------------
# box coder, anchors
# --------------------------------------------------------------------------


def test_box_coder_matches_jax():
    rng = np.random.default_rng(0)
    anchors = np.concatenate([rng.uniform(-5, 5, (20, 3)), rng.uniform(0.5, 4, (20, 3)),
                              rng.uniform(-3, 3, (20, 1))], -1).astype(np.float32)
    boxes = anchors + rng.normal(0, 0.2, anchors.shape).astype(np.float32)
    deltas = detector3d.encode_boxes(_t(boxes), _t(anchors))
    close(deltas, jdet.encode_boxes(jnp.asarray(boxes), jnp.asarray(anchors)), CODER_TOL)
    close(detector3d.decode_boxes(deltas, _t(anchors)), boxes, CODER_TOL, "round trip")
    close(detector3d.decode_boxes(deltas, _t(anchors)),
          jdet.decode_boxes(jnp.asarray(np.asarray(deltas)), jnp.asarray(anchors)), CODER_TOL)


@pytest.mark.parametrize("h, w, stride", [(20, 18, 1), (20, 18, 2), (21, 17, 2), (7, 9, 1)])
def test_patch_gemm_conv_matches_xla_same_conv(h, w, stride):
    """The BEV convs as one GEMM over 3x3 patches, against the reference's
    "SAME" conv (asymmetric padding at stride 2), and the GEMM's own
    backward (patches gathered again for dW, dpatches added back tap by tap
    for dx) against that conv's VJP."""
    from metatransformer_tpu.models import vit_adapter as jva

    rng = np.random.default_rng(h + w + stride)
    x = rng.standard_normal((2, h, w, 5)).astype(np.float32)
    wt = rng.standard_normal((3, 3, 5, 4)).astype(np.float32)
    xt, wtt = _t(x).requires_grad_(True), _t(wt).requires_grad_(True)
    y = detector3d.conv3x3_gemm(xt, wtt, stride)
    want, vjp = jax.vjp(lambda a, b: jva.conv2d(a, b, stride=stride),
                        jnp.asarray(x), jnp.asarray(wt))
    close(y, want, TOL)
    g = rng.standard_normal(tuple(y.shape)).astype(np.float32)
    y.backward(_t(g))
    want_x, want_w = vjp(jnp.asarray(g))
    close(xt.grad, want_x, GRAD_TOL, "dx")
    close(wtt.grad, want_w, GRAD_TOL, "dw")  # sums 2 x h x w products, |dW| up to ~50


def pillar_cfgs(num_classes=3):
    """(JAX, port) Detector3DConfig at the recipe's smoke geometry with the
    KITTI three-class anchors."""
    out = []
    for det, vox in ((jdet, jvox), (detector3d, voxelize)):
        vcfg = vox.VoxelConfig(pc_range=SMOKE_RANGE, voxel_size=(0.4, 0.4, 5.0))
        anchors = det.KITTI_3CLASS if num_classes == 3 else det.AnchorConfig()
        out.append(det.Detector3DConfig(
            vfe=vox.PillarVFEConfig(voxel=vcfg, channels=8), bev_channels=(8, 16),
            bev_strides=(2, 2), up_channels=8, anchors=anchors, num_classes=num_classes))
    return tuple(out)


def second_cfgs():
    return jsecond.SECONDConfig(**recipes._smoke_second_cfg().__dict__), recipes._smoke_second_cfg()


def test_anchors_equal_jax():
    jcfg, cfg = pillar_cfgs()
    np.testing.assert_array_equal(detector3d.generate_anchors(cfg), jdet.generate_anchors(jcfg))
    total = detector3d.generate_anchors(cfg).shape[0]
    np.testing.assert_array_equal(detector3d.anchor_class_ids(cfg.anchors, total),
                                  jdet.anchor_class_ids(jcfg.anchors, total))
    jscfg, scfg = second_cfgs()
    np.testing.assert_array_equal(second.generate_anchors(scfg), jsecond.generate_anchors(jscfg))
    # the KITTI YAMLs' grids
    full = second.SECONDConfig()
    assert second.generate_anchors(full).shape == (200 * 176 * 2, 7)


# --------------------------------------------------------------------------
# the pillar VFE, with tied maxima
# --------------------------------------------------------------------------


def test_pillar_vfe_and_its_tie_gradient_match_jax():
    """Each cloud repeats its points, so every pillar's max is tied between
    two (or more) equal points; ``amax`` splits the gradient as
    ``jax.ops.segment_max`` does."""
    jcfg, cfg = pillar_cfgs()
    batch = det3d_batch(1, n_points=64)
    pts = np.concatenate([batch["points"], batch["points"]], 1)
    mask = np.ones(pts.shape[:2], bool)
    mask[1, -10:] = False
    tree = perturb(jax.tree.map(np.asarray, jvox.pillar_vfe_init(jcfg.vfe, jax.random.PRNGKey(0))),
                   1)

    def jloss(p):
        g = jvox.pillar_vfe_apply(p, jnp.asarray(pts), jcfg.vfe, jnp.asarray(mask))
        return jnp.sum(g * jnp.arange(g.size, dtype=jnp.float32).reshape(g.shape) / g.size), g

    (jl, jgrid), jgrads = jax.value_and_grad(jloss, has_aux=True)(jax.tree.map(jnp.asarray, tree))

    def loss(p):
        g = voxelize.pillar_vfe_apply(p, _t(pts), cfg.vfe, _t(mask))
        return (g * torch.arange(g.numel(), dtype=torch.float32).reshape(g.shape) / g.numel()
                ).sum(), {}

    loss_v, _, grads = port_loss_and_grads(loss, tree)
    close(voxelize.pillar_vfe_apply(convert.from_numpy(tree, "cpu"), _t(pts), cfg.vfe,
                                    _t(mask)), jgrid, TOL, "grid")
    check_train((loss_v, {}, grads), (jl, {}, jgrads))


# --------------------------------------------------------------------------
# assignment
# --------------------------------------------------------------------------


@pytest.mark.parametrize("multiclass", [False, True])
def test_assign_targets_equal_jax(multiclass):
    """Three ground truths a sample, two of them the same box (they share
    their best anchor: the later one wins, as XLA's scatter), one padding.
    Each box is a car near a car anchor, so its best anchor is not a tie
    that rounding decides (anchors that lie whole inside a box, or either
    side of it, tie in exact arithmetic, and then either package may take
    either)."""
    jcfg, cfg = pillar_cfgs()
    anchors = detector3d.generate_anchors(cfg)
    acls = detector3d.anchor_class_ids(cfg.anchors, anchors.shape[0])
    rng = np.random.default_rng(3)
    gt = np.zeros((2, 4, 7), np.float32)
    centre = anchors[rng.choice(np.nonzero(acls == 0)[0], (2, 3))]
    gt[:, :3, :3] = centre[..., :3] + rng.uniform(-0.1, 0.1, (2, 3, 3))
    gt[:, :3, 3:6] = [3.9, 1.6, 1.56]
    gt[:, :3, 6] = rng.uniform(-0.3, 0.3, (2, 3))
    gt[:, 1] = gt[:, 0]
    valid = np.asarray([[True, True, True, False], [True, True, False, False]])
    labels = rng.integers(0, 3, (2, 4)).astype(np.int32)
    labels[:, 1] = labels[:, 0]
    m_thr = np.asarray(cfg.anchors.matched_thrs, np.float32)[acls]
    u_thr = np.asarray(cfg.anchors.unmatched_thrs, np.float32)[acls]
    got = detector3d.assign_targets(_t(anchors), _t(gt), _t(valid), _t(m_thr), _t(u_thr),
                                    _t(labels).long() if multiclass else None,
                                    _t(acls) if multiclass else None)
    for i in range(2):
        want = jdet.assign_targets(jnp.asarray(anchors), jnp.asarray(gt[i]),
                                   jnp.asarray(valid[i]), jnp.asarray(m_thr), jnp.asarray(u_thr),
                                   jnp.asarray(labels[i]) if multiclass else None,
                                   jnp.asarray(acls) if multiclass else None)
        np.testing.assert_array_equal(got[0][i].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1][i].numpy(), np.asarray(want[1]))
        assert (got[0][i] == 1).sum() > 0


# --------------------------------------------------------------------------
# PointPillars and SECOND end to end
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _pillars():
    """(JAX cfg, port cfg, numpy params, port params, batch, anchors)."""
    jcfg, cfg = pillar_cfgs()
    tree, params = carried(jdet.init(jcfg, jax.random.PRNGKey(0)), 2)
    return jcfg, cfg, tree, params, det3d_batch(4, num_classes=3), detector3d.generate_anchors(cfg)


@functools.lru_cache(maxsize=None)
def _second():
    jcfg, cfg = second_cfgs()
    tree, params = carried(jsecond.init(jcfg, jax.random.PRNGKey(0)), 3)
    return jcfg, cfg, tree, params, det3d_batch(5), second.generate_anchors(cfg)


MODELS = {"pointpillars": (_pillars, jdet, detector3d), "second": (_second, jsecond, second)}


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    """JAX's predictions, loss, logs and gradients in one jitted call."""
    make, jmod, _ = MODELS[name]
    jcfg, _, tree, _, batch, anchors = make()
    labels = batch["gt_labels"] if name == "pointpillars" else None

    def jloss(p):
        preds = jmod.forward(p, jnp.asarray(batch["points"]), jcfg)
        loss, logs = jdet.detection_loss(
            preds, jnp.asarray(anchors), jnp.asarray(batch["gt_boxes"]),
            jnp.asarray(batch["gt_valid"]), jcfg,
            gt_labels=None if labels is None else jnp.asarray(labels))
        return loss, (logs, preds)

    (loss, (logs, preds)), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree.map(jnp.asarray, tree))
    return loss, logs, preds, grads


@pytest.mark.parametrize("name", MODELS)
def test_forward_matches_jax(name):
    make, _, mod = MODELS[name]
    _, cfg, _, params, batch, _ = make()
    want = _jax_run(name)[2]
    got = mod.forward(params, _t(batch["points"]), cfg)
    assert set(got) == set(want)
    for k in got:
        close(got[k], want[k], TOL, k)


@pytest.mark.parametrize("name", MODELS)
def test_loss_and_gradients_match_jax(name):
    make, _, mod = MODELS[name]
    _, cfg, tree, _, batch, anchors = make()
    labels = batch["gt_labels"] if name == "pointpillars" else None
    loss, logs, _, grads = _jax_run(name)

    def port_loss(p):
        preds = mod.forward(p, _t(batch["points"]), cfg)
        return detector3d.detection_loss(preds, _t(anchors), _t(batch["gt_boxes"]),
                                         _t(batch["gt_valid"]), cfg,
                                         gt_labels=None if labels is None else _t(labels))

    check_train(port_loss_and_grads(port_loss, tree), (loss, logs, grads))


@pytest.mark.parametrize("name", MODELS)
def test_predict_equals_jax(name):
    make, _, mod = MODELS[name]
    jcfg, cfg, _, params, batch, anchors = make()
    want = jdet.predict(_jax_run(name)[2], jnp.asarray(anchors), jcfg, score_thr=0.02,
                        nms_pre=256)
    got = detector3d.predict(mod.forward(params, _t(batch["points"]), cfg), _t(anchors), cfg,
                             score_thr=0.02, nms_pre=256)
    check_predictions(got, want, ("boxes", "scores", "labels", "valid"))


def test_init_trees_have_jax_keys_and_shapes():
    for make, init, jinit in ((_pillars, detector3d.init, jdet.init),
                              (_second, second.init, jsecond.init)):
        jcfg, cfg = make()[:2]
        got = leaves_with_path(init(cfg, torch.Generator().manual_seed(0), "cpu"))
        want = leaves_with_path(jax.tree.map(np.asarray, jinit(jcfg, jax.random.PRNGKey(0))))
        assert [(p, tuple(v.shape)) for p, v in got] == [(p, v.shape) for p, v in want]


@pytest.mark.parametrize("init", [detector3d.init, second.init])
def test_init_takes_the_card_or_raises(init, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _pillars()[1] if init is detector3d.init else _second()[1]
    with pytest.raises(RuntimeError, match="CUDA"):
        init(cfg, torch.Generator().manual_seed(0))
