"""The port's IA-SSD (models/iassd.py) against the JAX package on the CPU,
FP32, at the recipe's smoke geometry (128 points a cloud; D-FPS to 32, two
ctr-aware stages to 16 and 8, the vote, a last stage around the votes),
with the port's seeded weights, perturbed, carried across.

The BinOri coder round-trips and matches at 1e-4 (``CODER_TOL``); the
centerness, the forward (centres, votes, class and box codes, each
confidence stage's logits), the losses and predictions at 1e-5, the centre
targets exactly, every gradient leaf within GRAD_TOL of its largest
reference value (``check_train``). A second batch masks most of one cloud,
so that its ctr-aware picks meet ties (masked points score -1), which both
packages break to the lower index. The reference's whole step is one jitted
call.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metatransformer_tpu.models import iassd as jiassd
from metatransformer_tpu_torch import recipes
from metatransformer_tpu_torch.configs import load_config
from metatransformer_tpu_torch.core import convert
from metatransformer_tpu_torch.models import iassd
from metatransformer_tpu_torch.ops import point_ops
from tests.test_torch_detector3d import (CODER_TOL, TOL, _t, check_predictions, check_train,
                                         close, det3d_batch, port_loss_and_grads)
from tests.test_torch_point_rcnn import random_boxes
from tests.test_torch_vit_adapter import perturb

torch.set_num_threads(1)


def smoke_cfg():
    return recipes.iassd_config(load_config("metatransformer_tpu/configs/kitti_iassd.yaml"), True)


def to_jax_cfg(cfg):
    fields = {k: getattr(cfg, k) for k in cfg.__dataclass_fields__}
    fields["stages"] = tuple(jiassd.IASSDStage(**s.__dict__) for s in cfg.stages)
    return jiassd.IASSDConfig(**fields)


def _mask(ragged):
    """All points valid, or the second cloud cut to its last 10 of 128: its
    D-FPS to 32 then starts at a masked point (slot 0 is index 0) and, once
    the 10 are taken, repeats it, so its ctr-aware picks meet ties at -1
    (masked) and among the repeats."""
    mask = np.ones((2, 128), bool)
    if ragged:
        mask[1, :118] = False
    return mask


@functools.lru_cache(maxsize=None)
def _setup():
    cfg = smoke_cfg()
    tree = perturb(convert.to_numpy(iassd.init(cfg, torch.Generator().manual_seed(0), "cpu")), 4)
    return to_jax_cfg(cfg), cfg, tree, det3d_batch(6, num_classes=3)


_KEYS = ("points", "gt_boxes", "gt_labels", "gt_valid")


@functools.lru_cache(maxsize=None)
def _jax_run(ragged=False):
    jcfg, _, tree, batch = _setup()
    args = [jnp.asarray(batch[k]) for k in _KEYS]
    mask = jnp.asarray(_mask(ragged))

    def loss(p):
        total, logs = jiassd.training_loss(p, *args, jcfg, points_mask=mask)
        return total, (logs, jiassd.forward(p, args[0], jcfg, points_mask=mask))

    (total, aux), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree.map(jnp.asarray, tree))
    return total, aux, grads


def test_binori_coder_round_trips_and_matches_jax():
    jcfg, cfg, _, _ = _setup()
    rng = np.random.default_rng(0)
    gt = random_boxes(rng, 40)
    gt[:2, 6] = [-np.pi, np.pi]  # clipped into the first and last bins
    points = gt[:, :3] + rng.normal(0, 0.5, (40, 3)).astype(np.float32)
    classes = rng.integers(0, 4, 40)
    res, bin_id, bin_res = iassd.binori_encode(_t(gt), _t(points), _t(classes), cfg)
    want = jiassd.binori_encode(*map(jnp.asarray, (gt, points, classes)), jcfg)
    close(res, want[0], CODER_TOL, "residuals")
    np.testing.assert_array_equal(bin_id.numpy(), np.asarray(want[1]))
    close(bin_res, want[2], CODER_TOL, "bin residual")
    nb = cfg.angle_bins
    enc = torch.cat([res, torch.nn.functional.one_hot(bin_id, nb).float(),
                     bin_res[:, None].expand(-1, nb)], -1)
    dec = iassd.binori_decode(enc, _t(points), _t(classes), cfg)
    close(dec[:, :6], gt[:, :6], CODER_TOL, "round trip")
    close(torch.remainder(dec[:, 6] - _t(gt[:, 6]) + np.pi, 2 * np.pi) - np.pi,
          np.zeros(40, np.float32), CODER_TOL, "heading")
    close(dec, jiassd.binori_decode(jnp.asarray(enc.numpy()), jnp.asarray(points),
                                    jnp.asarray(classes), jcfg), CODER_TOL)


def test_centerness_and_center_targets_match_jax():
    jcfg, cfg, _, batch = _setup()
    rng = np.random.default_rng(1)
    boxes = random_boxes(rng, 50)
    points = boxes[:, :3] + rng.uniform(-1.5, 1.5, (50, 3)).astype(np.float32)
    close(iassd.centerness(_t(points), _t(boxes)),
          jiassd.centerness(jnp.asarray(points), jnp.asarray(boxes)), TOL)
    xyz = np.concatenate([batch["gt_boxes"][:, :1, :3] + rng.uniform(-3, 3, (2, 200, 3)),
                          batch["points"][..., :3]], 1).astype(np.float32)
    args = (xyz, batch["gt_boxes"], batch["gt_labels"], batch["gt_valid"])
    for extra in (cfg.extra_width, 0.0):
        got = iassd.assign_center_targets(*map(_t, args), extra)
        want = jiassd.assign_center_targets(
            *map(jnp.asarray, args), jcfg.__class__(**{**jcfg.__dict__, "extra_width": extra}))
        for g, w in zip(got, want):
            close(g, np.asarray(w), 0)
        assert 0 < got[0].sum() < got[0].numel()


@pytest.mark.parametrize("ragged", [False, True])
def test_forward_matches_jax(ragged):
    _, cfg, tree, batch = _setup()
    _, (_, want), _ = _jax_run(ragged)
    with torch.no_grad():
        got = iassd.forward(convert.from_numpy(tree, "cpu"), _t(batch["points"]), cfg,
                            _t(_mask(ragged)))
    for k in ("centers", "centers_origin", "ctr_offsets", "center_cls", "center_reg"):
        close(got[k], want[k], TOL, k)
    np.testing.assert_array_equal(got["center_mask"].numpy(), np.asarray(want["center_mask"]))
    assert len(got["sa_ins"]) == len(want["sa_ins"]) == 2
    for (xyz, logits), (wxyz, wlogits) in zip(got["sa_ins"], want["sa_ins"]):
        close(xyz, wxyz, TOL, "stage centres")
        close(logits, wlogits, TOL, "stage logits")
    if ragged:  # fewer valid D-FPS picks than the next stage's 16: it takes -1 ties
        pts, mask = _t(batch["points"][1:, :, :3]), _t(_mask(True)[1:])
        assert mask.gather(1, point_ops.masked_fps(pts, mask, 32)).sum() < 16


@pytest.mark.parametrize("ragged", [False, True])
def test_training_loss_and_gradients_match_jax(ragged):
    _, cfg, tree, batch = _setup()
    total, (logs, _), grads = _jax_run(ragged)
    args = [_t(batch[k]) for k in _KEYS]
    port = port_loss_and_grads(
        lambda p: iassd.training_loss(p, *args, cfg, points_mask=_t(_mask(ragged))), tree)
    check_train(port, (total, logs, grads))
    assert port[1]["corner"] > 0 and port[1]["vote"] > 0  # foreground centres


def test_predict_equals_jax():
    jcfg, cfg, tree, batch = _setup()
    cfg = cfg.__class__(**{**cfg.__dict__, "score_thresh": 0.0, "max_out": 8})
    jcfg = jcfg.__class__(**{**jcfg.__dict__, "score_thresh": 0.0, "max_out": 8})
    want = jiassd.predict(jax.tree.map(jnp.asarray, tree), jnp.asarray(batch["points"]), jcfg)
    got = iassd.predict(convert.from_numpy(tree, "cpu"), _t(batch["points"]), cfg)
    check_predictions(got, want, ("boxes", "scores", "labels", "valid"))


def test_init_tree_has_jax_keys_and_shapes():
    jcfg, _, tree, _ = _setup()
    want = jax.eval_shape(lambda k: jiassd.init(jcfg, k), jax.random.PRNGKey(0))
    assert jax.tree.map(np.shape, tree) == jax.tree.map(lambda s: s.shape, want)


def test_init_takes_the_card_or_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        iassd.init(smoke_cfg(), torch.Generator().manual_seed(0))
