"""The port's CenterPoint (models/centerpoint.py) against the JAX package
on the CPU, FP32, at the recipes' smoke geometry (a (25, 64, 64) grid, the
KITTI single head and the nuScenes six class groups with velocity), with
the port's seeded weights, perturbed, carried across:

- the targets (heatmaps, regression rows, indices, masks) of a batch
  against the reference's per-sample assigner, the heatmaps at 1e-6;
- the focal loss and CornerNet's radius in both modes;
- the training loss at 1e-5 and every gradient leaf within 1e-4 of its
  largest (tests/test_torch_detector3d.py ``check_train``);
- the decode's top-K and NMS (equal indices, labels and flags; boxes at
  1e-4) on the prediction maps;
- the init's keys and shapes, and the init landing on the card or raising.
JAX's loss and gradients are one jitted call a config.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metatransformer_tpu.models import centerpoint as jcp
from metatransformer_tpu_torch import recipes
from metatransformer_tpu_torch.configs import load_config
from metatransformer_tpu_torch.core import convert
from metatransformer_tpu_torch.models import centerpoint as cp
from tests.test_torch_detector3d import (_t, check_predictions, check_train, close, det3d_batch,
                                         port_loss_and_grads)
from tests.test_torch_vit_adapter import perturb

torch.set_num_threads(1)
YAMLS = {"kitti": "metatransformer_tpu/configs/kitti_centerpoint.yaml",
         "nuscenes": "metatransformer_tpu/configs/nuscenes_centerpoint.yaml"}


def to_jax(cfg):
    return jcp.CenterPointConfig(**{f.name: getattr(cfg, f.name)
                                    for f in dataclasses.fields(cfg)})


@functools.lru_cache(maxsize=None)
def _setup(which):
    """(port cfg, JAX cfg, perturbed numpy weights, batch): the smoke
    geometry; the nuScenes boxes with two velocity columns and 0-based
    labels over its ten classes."""
    cfg = recipes.centerpoint_config(load_config(YAMLS[which]), smoke=True)
    tree = perturb(convert.to_numpy(cp.init(cfg, torch.Generator().manual_seed(0), "cpu")), 5)
    batch = dict(det3d_batch(11, num_classes=cfg.num_classes))
    rng = np.random.default_rng(12)
    batch["gt_labels"] = rng.integers(0, cfg.num_classes, batch["gt_labels"].shape)
    batch["gt_valid"] = np.ones_like(batch["gt_valid"])  # both boxes drawn
    if cfg.velocity:
        vel = rng.normal(0, 1, batch["gt_boxes"].shape[:-1] + (2,)).astype(np.float32)
        batch["gt_boxes"] = np.concatenate([batch["gt_boxes"], vel], -1)
    return cfg, to_jax(cfg), tree, batch


@functools.lru_cache(maxsize=None)
def _jax_run(which):
    _, jcfg, tree, batch = _setup(which)
    args = [jnp.asarray(batch[k]) for k in ("points", "gt_boxes", "gt_labels", "gt_valid")]

    def loss(p):
        preds = jcp.forward(p, args[0], jcfg)
        total, logs = jcp.detection_loss(preds, *args[1:], jcfg)
        return total, (logs, preds)

    (total, (logs, preds)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree.map(jnp.asarray, tree))
    return total, logs, grads, jax.tree.map(np.asarray, preds)


@pytest.mark.parametrize("which", sorted(YAMLS))
def test_forward_maps_match_jax(which):
    cfg, _, tree, batch = _setup(which)
    want = _jax_run(which)[3]
    with torch.no_grad():
        got = cp.forward(convert.from_numpy(tree, "cpu"), _t(batch["points"]), cfg)
    got, want = cp._as_groups(got), want if isinstance(want, list) else [want]
    assert len(got) == len(want) == len(cfg.groups)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            close(g[k], w[k], 1e-4, k)


@pytest.mark.parametrize("which", sorted(YAMLS))
def test_training_loss_and_gradients_match_jax(which):
    cfg, _, tree, batch = _setup(which)
    total, logs, grads, _ = _jax_run(which)
    args = [_t(batch[k]) for k in ("points", "gt_boxes", "gt_labels", "gt_valid")]
    port = port_loss_and_grads(
        lambda p: cp.detection_loss(cp.forward(p, args[0], cfg), *args[1:], cfg), tree)
    check_train(port, (total, logs, grads))
    assert port[1]["hm"] > 0 and port[1]["loc"] > 0


@pytest.mark.parametrize("which", sorted(YAMLS))
def test_targets_match_jax(which):
    cfg, jcfg, _, batch = _setup(which)
    boxes, labels = batch["gt_boxes"], batch["gt_labels"]
    valid = batch["gt_valid"].copy()
    valid[0, 1] = False  # one padding row
    got = cp.assign_targets(_t(boxes), _t(labels), _t(valid), cfg)
    for i in range(boxes.shape[0]):
        want = jcp.assign_targets(jnp.asarray(boxes[i]), jnp.asarray(labels[i]),
                                  jnp.asarray(valid[i]), jcfg)
        np.testing.assert_allclose(got["heatmap"][i].numpy(), np.asarray(want["heatmap"]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(got["heatmap"][i].numpy() == 1,
                                      np.asarray(want["heatmap"]) == 1)
        np.testing.assert_array_equal(got["inds"][i].numpy(), np.asarray(want["inds"]))
        np.testing.assert_array_equal(got["mask"][i].numpy(), np.asarray(want["mask"]))
        close(got["target_boxes"][i], want["target_boxes"], 1e-6)
    assert (got["heatmap"] == 1).sum() == valid.sum()


@pytest.mark.parametrize("mode", ["centerpoint", "3dal"])
def test_gaussian_radius_and_focal_loss_match_jax(mode):
    rng = np.random.default_rng(13)
    h, w = (rng.uniform(0.5, 40, 50).astype(np.float32) for _ in range(2))
    close(cp.gaussian_radius(_t(h), _t(w), 0.1, mode),
          jcp.gaussian_radius(jnp.asarray(h), jnp.asarray(w), 0.1, mode), 1e-6)
    pred = rng.uniform(1e-4, 1 - 1e-4, (2, 8, 8, 3)).astype(np.float32)
    gt = rng.uniform(0, 0.9, pred.shape).astype(np.float32)
    gt[0, 2, 3, 1] = gt[1, 5, 5, 0] = 1.0
    for g in (gt, gt * 0.5):  # with and without positives
        close(cp.focal_loss_centernet(_t(pred), _t(g)),
              jcp.focal_loss_centernet(jnp.asarray(pred), jnp.asarray(g)), 1e-5)


def _random_maps(cfg, seed):
    """Prediction maps with distinct heatmap values, in both layouts."""
    rng = np.random.default_rng(seed)
    fh, fw = cfg.bev_hw
    groups = []
    for group in cfg.groups:
        maps = {k: rng.normal(0, 0.5, (2, fh, fw, c)).astype(np.float32)
                for k, c in cfg.group_channels(group).items()}
        maps["hm"] = rng.normal(-1, 2, maps["hm"].shape).astype(np.float32)
        groups.append(maps)
    return groups if cfg.class_groups else groups[0]


@pytest.mark.parametrize("which", sorted(YAMLS))
def test_decode_equals_jax(which):
    cfg, jcfg, _, _ = _setup(which)
    maps = _random_maps(cfg, 14)
    to_t = lambda m: {k: _t(v) for k, v in m.items()}  # noqa: E731
    to_j = lambda m: {k: jnp.asarray(v) for k, v in m.items()}  # noqa: E731
    port_maps = [to_t(m) for m in maps] if cfg.class_groups else to_t(maps)
    jax_maps = [to_j(m) for m in maps] if cfg.class_groups else to_j(maps)
    for nms in (True, False):
        got = cp.decode(port_maps, cfg, k=20, nms=nms)
        want = jcp.decode(jax_maps, jcfg, k=20, nms=nms)
        check_predictions(got, want, keys=("boxes", "scores", "labels", "valid"))
        assert got[0]["boxes"].shape[-1] == (9 if cfg.velocity else 7)


@pytest.mark.parametrize("which", sorted(YAMLS))
def test_init_tree_has_jax_keys_and_shapes(which):
    _, jcfg, tree, _ = _setup(which)
    want = jax.eval_shape(lambda k: jcp.init(jcfg, k), jax.random.PRNGKey(0))
    assert jax.tree.map(np.shape, tree) == jax.tree.map(lambda s: s.shape, want)


def test_init_takes_the_card_or_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cp.init(_setup("kitti")[0], torch.Generator().manual_seed(0))
