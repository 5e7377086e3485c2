"""The port's CaDDN (models/caddn.py) against the JAX package on the CPU,
FP32, at the recipe's smoke geometry (32 x 64 images, 16 LID bins, a
16 x 16 x 6 voxel grid), with the port's seeded weights, perturbed, carried
across.

The LID bins round-trip and equal the reference's; the image backbone, the
frustum features, the voxel sample and the anchor head's predictions at
TOL; the anchors equal; the training loss at TOL and every gradient leaf
within GRAD_TOL of its largest reference value (tests/test_torch_detector3d.py's
``check_train``).

Two choices sit at rounding edges. The frustum sample floors the pixel
coordinates and the depth bins of every voxel centre (``frustum_floors``):
the reference's floors are computed by its own lines (``jax_floors``),
counted against the port's, and replayed into the port's run. The anchor
assignment meets exact ties: at this geometry a 3.2 m ground truth lies
inside the 3.9 m anchors of neighbouring cells, whose IoUs are then equal
but for rounding, so the reference's assignment (``jax_assignments``) is
replayed into the port's loss once ``held_assignments`` has bounded how far
the port's own differs: at most ``LABELS_DIFFER`` of the anchors, each at a
tie within ``IOU_TIE`` (2 of 1,024 labels differ at the smoke geometry).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metatransformer_tpu.models import caddn as jcaddn
from metatransformer_tpu.models import detector3d as jdet
from metatransformer_tpu_torch import recipes
from metatransformer_tpu_torch.configs import load_config
from metatransformer_tpu_torch.core import convert
from metatransformer_tpu_torch.models import caddn, detector3d
from metatransformer_tpu_torch.ops import iou3d
from tests.test_torch_detector3d import TOL, _t, check_train, close, port_loss_and_grads
from tests.test_torch_vit_adapter import perturb

torch.set_num_threads(1)


def smoke_cfg():
    return recipes.caddn_config(load_config("metatransformer_tpu/configs/kitti_caddn.yaml"), True)


def to_jax_cfg(cfg):
    fields = {k: getattr(cfg, k) for k in cfg.__dataclass_fields__}
    fields["anchors"] = jdet.AnchorConfig(**fields["anchors"].__dict__)
    return jcaddn.CaDDNConfig(**fields)


def jax_floors(l2c, c2i, jcfg):
    """The reference's ``frustum_to_voxel`` up to its floors, by its own
    lines: (depth bin, u0, v0, inside), each [B, N]."""
    hf, wf = jcfg.feat_hw
    gx, gy, gz = jcfg.grid_size
    r = jcfg.pc_range
    axes = [r[i] + (jnp.arange(g) + 0.5) * ((r[i + 3] - r[i]) / g)
            for i, g in enumerate((gx, gy, gz))]
    gxx, gyy, gzz = jnp.meshgrid(*axes, indexing="ij")
    pts = jnp.stack([gxx, gyy, gzz, jnp.ones_like(gxx)], -1).reshape(-1, 4)

    def per_sample(l2c, c2i):
        img = (pts @ l2c.T) @ c2i.T
        depth = img[:, 2]
        s = jcfg.feat_stride
        uf = img[:, 0] / jnp.maximum(depth, 1e-6) / s - 0.5
        vf = img[:, 1] / jnp.maximum(depth, 1e-6) / s - 0.5
        db = jcaddn.depth_to_bin(depth, jcfg)
        inb = (depth > 0) & (db < jcfg.num_bins) & (uf > -1) & (uf < wf) & (vf > -1) & (vf < hf)
        u0 = jnp.clip(jnp.floor(uf).astype(jnp.int32), 0, wf - 1)
        v0 = jnp.clip(jnp.floor(vf).astype(jnp.int32), 0, hf - 1)
        return jnp.clip(db, 0, jcfg.num_bins - 1), u0, v0, inb

    out = jax.jit(jax.vmap(per_sample))(jnp.asarray(l2c), jnp.asarray(c2i))
    return tuple(torch.tensor(np.asarray(a)).long() if a.dtype != bool
                 else torch.tensor(np.asarray(a)) for a in out)


def jax_assignments(anchors, gt_boxes, gt_valid, cfg):
    """The reference's anchor assignment of each sample (single class, as
    its ``detection_loss`` calls it) -> (labels [B, A], gt index [B, A])."""
    m_thr, u_thr = cfg.anchors.matched_thrs[0], cfg.anchors.unmatched_thrs[0]
    labels, idx = jax.jit(jax.vmap(
        lambda g, v: jdet.assign_targets(jnp.asarray(anchors), g, v, m_thr, u_thr)))(
        jnp.asarray(gt_boxes), jnp.asarray(gt_valid))
    return torch.tensor(np.asarray(labels)).long(), torch.tensor(np.asarray(idx)).long()


LABELS_DIFFER = 0.01  # share of anchors; read: 2 of 1,024 at the smoke geometry
IOU_TIE = 1e-5  # fp32 rounding of a BEV IoU in [0, 1]


def held_assignments(anchors, gt_boxes, gt_valid, cfg):
    """The reference's assignment, once the port's own is held to it: at
    most LABELS_DIFFER of the labels differ, and each that differs sits at a
    tie, its IoU within IOU_TIE of a threshold or of its ground truth's best
    anchor (the forced foreground)."""
    want = jax_assignments(anchors, gt_boxes, gt_valid, cfg)
    a, g, v = _t(anchors), _t(gt_boxes), _t(gt_valid)
    m_thr, u_thr = cfg.anchors.matched_thrs[0], cfg.anchors.unmatched_thrs[0]
    own = detector3d.assign_targets(a, g, v, m_thr, u_thr)
    differ = own[0] != want[0]
    print(f"anchor labels differing from the reference's: {int(differ.sum())} of "
          f"{differ.numel()}")
    assert differ.float().mean() <= LABELS_DIFFER
    iou = torch.where(v[:, None, :], iou3d.boxes_iou3d(a[None], g), -1.0)  # [B, A, G]
    best = iou.amax(-1)
    at_thr = ((best - m_thr).abs() <= IOU_TIE) | ((best - u_thr).abs() <= IOU_TIE)
    at_best_anchor = (v[:, None, :] & ((iou - iou.amax(1, keepdim=True)).abs() <= IOU_TIE)
                      & (iou > 0)).any(-1)
    assert (at_thr | at_best_anchor)[differ].all()
    return want


def replaying(monkeypatch, floors=None, assignments=None):
    """The port's floors and anchor assignment replaced by the given ones."""
    if floors is not None:
        monkeypatch.setattr(caddn, "frustum_floors", lambda *a: floors)
    if assignments is not None:
        monkeypatch.setattr(detector3d, "assign_targets", lambda *a, **k: assignments)


@functools.lru_cache(maxsize=None)
def _setup():
    """(JAX cfg, port cfg, numpy weights, batch, anchors)."""
    cfg = smoke_cfg()
    tree = perturb(convert.to_numpy(caddn.init(cfg, torch.Generator().manual_seed(0), "cpu")),
                   seed=3, scale=0.02)
    batch = next(iter(recipes._caddn_synth(cfg)(2, 1, 5)))["input"]
    return to_jax_cfg(cfg), cfg, tree, batch, caddn.generate_anchors(cfg)


_KEYS = ("image", "lidar_to_cam", "cam_to_img", "depth_maps", "fg_mask", "gt_boxes", "gt_valid")


@functools.lru_cache(maxsize=None)
def _jax_run():
    """The reference's loss, logs, gradients and forward products, one
    jitted call."""
    jcfg, _, tree, batch, anchors = _setup()
    args = [jnp.asarray(batch[k]) for k in _KEYS]

    def loss(p):
        total, logs = jcaddn.training_loss(p, *args, jnp.asarray(anchors), jcfg)
        feats, logits = jcaddn.image_backbone(p, args[0], jcfg)
        frustum = jcaddn.frustum_features(feats, logits)
        vox = jcaddn.frustum_to_voxel(frustum, args[1], args[2], jcfg)
        preds, _ = jcaddn.forward(p, *args[:3], jcfg)
        return total, (logs, feats, logits, frustum, vox, preds)

    (total, aux), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree.map(jnp.asarray, tree))
    return total, aux, grads


def test_lid_bins_round_trip_and_equal_jax():
    cfg = recipes.caddn_config(load_config("metatransformer_tpu/configs/kitti_caddn.yaml"))
    jcfg = to_jax_cfg(cfg)
    centres = caddn.bin_to_depth(torch.arange(cfg.num_bins), cfg)
    close(centres, jcaddn.bin_to_depth(jnp.arange(cfg.num_bins), jcfg), TOL)
    np.testing.assert_array_equal(caddn.depth_to_bin(centres, cfg).numpy(), np.arange(cfg.num_bins))
    depth = np.concatenate([np.linspace(-5.0, 60.0, 4001, dtype=np.float32),
                            np.asarray([np.inf, np.nan], np.float32)])
    got = caddn.depth_to_bin(_t(depth), cfg).numpy()
    np.testing.assert_array_equal(got, np.asarray(jcaddn.depth_to_bin(jnp.asarray(depth), jcfg)))
    assert (got == cfg.num_bins).sum() > 0 and len(np.unique(got)) == cfg.num_bins + 1


def test_anchors_equal_jax():
    jcfg, cfg, _, _, anchors = _setup()
    np.testing.assert_array_equal(anchors, jcaddn.generate_anchors(jcfg))
    full = recipes.caddn_config(load_config("metatransformer_tpu/configs/kitti_caddn.yaml"))
    np.testing.assert_array_equal(caddn.generate_anchors(full),
                                  jcaddn.generate_anchors(to_jax_cfg(full)))


def test_image_backbone_and_frustum_match_jax():
    _, cfg, tree, batch, _ = _setup()
    _, (_, want_f, want_l, want_fr, _, _), _ = _jax_run()
    with torch.no_grad():
        feats, logits = caddn.image_backbone(convert.from_numpy(tree, "cpu"), _t(batch["image"]),
                                             cfg)
        close(feats, want_f, TOL, "features")
        close(logits, want_l, TOL, "depth logits")
        close(caddn.frustum_features(feats, logits), want_fr, TOL, "frustum")


def test_frustum_floors_and_voxels_match_jax(monkeypatch):
    """The port's floors against the reference's (the count that differ is
    printed), then the voxel sample on the reference's frustum with its
    floors replayed."""
    jcfg, cfg, _, batch, _ = _setup()
    _, (_, _, _, frustum, want, _), _ = _jax_run()
    got_floors = caddn.frustum_floors(_t(batch["lidar_to_cam"]), _t(batch["cam_to_img"]), cfg)
    floors = jax_floors(batch["lidar_to_cam"], batch["cam_to_img"], jcfg)
    differ = sum(int((g != w).sum()) for g, w in zip(got_floors, floors))
    print(f"frustum floors differing from the reference's: {differ} of "
          f"{4 * floors[0].numel()}")
    assert differ <= floors[0].numel() // 1000
    replaying(monkeypatch, floors=floors)
    got = caddn.frustum_to_voxel(_t(frustum), _t(batch["lidar_to_cam"]), _t(batch["cam_to_img"]),
                                 cfg)
    close(got, want, TOL)
    assert floors[3].float().mean() > 0.2 and (got != 0).float().mean() > 0.2


def test_predictions_match_jax(monkeypatch):
    jcfg, cfg, tree, batch, _ = _setup()
    _, (*_, want), _ = _jax_run()
    replaying(monkeypatch, floors=jax_floors(batch["lidar_to_cam"], batch["cam_to_img"], jcfg))
    with torch.no_grad():
        preds, _ = caddn.forward(convert.from_numpy(tree, "cpu"),
                                 *(_t(batch[k]) for k in _KEYS[:3]), cfg)
    for k in preds:
        close(preds[k], want[k], TOL, k)


def test_training_loss_and_gradients_match_jax(monkeypatch):
    """With the reference's floors and anchor assignment replayed (the
    port's own assignment held to it by ``held_assignments``)."""
    jcfg, cfg, tree, batch, anchors = _setup()
    total, (logs, *_), grads = _jax_run()
    assignments = held_assignments(anchors, batch["gt_boxes"], batch["gt_valid"], cfg)
    replaying(monkeypatch, jax_floors(batch["lidar_to_cam"], batch["cam_to_img"], jcfg),
              assignments)
    args = [_t(batch[k]) for k in _KEYS]
    port = port_loss_and_grads(
        lambda p: caddn.training_loss(p, *args, _t(anchors), cfg), tree)
    check_train(port, (total, logs, grads))
    assert (assignments[0] == 1).any()


def test_patch_gemm_in_row_blocks_matches_one_gemm(monkeypatch):
    """detector3d.conv3x3_gemm past _GEMM_PATCH_LIMIT (CaDDN's first BEV
    conv at KITTI width) runs in blocks of output rows: the same product,
    forward and backward, as one GEMM."""
    rng = np.random.default_rng(4)
    x = _t(rng.standard_normal((2, 11, 7, 5)).astype(np.float32))
    w = _t(rng.standard_normal((3, 3, 5, 4)).astype(np.float32))
    g = _t(rng.standard_normal((2, 11, 7, 4)).astype(np.float32))

    def run():
        xs, ws = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        out = detector3d.conv3x3_gemm(xs, ws, 1)
        return (out, *torch.autograd.grad(out, (xs, ws), g))

    want = run()
    monkeypatch.setattr(detector3d, "_GEMM_PATCH_LIMIT", 2 * 7 * 45 * 3)
    assert len(detector3d._row_blocks(2, 11, 7, 45)) == 4
    for a, b in zip(run(), want):
        close(a, b.detach().numpy(), TOL)


def test_init_tree_has_jax_keys_and_shapes():
    jcfg, _, tree, _, _ = _setup()
    want = jax.eval_shape(lambda k: jcaddn.init(jcfg, k), jax.random.PRNGKey(0))
    assert jax.tree.map(np.shape, tree) == jax.tree.map(lambda s: s.shape, want)


def test_init_takes_the_card_or_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        caddn.init(smoke_cfg(), torch.Generator().manual_seed(0))
