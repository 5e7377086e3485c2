"""The port's Part-A2 (models/part_a2.py) against the JAX package on the
CPU, FP32, at the recipe's smoke geometry (the sparse U-Net over the
(25, 64, 64) grid, 8 RoIs from 64 proposals, a 3^3 part pool), with the
port's seeded weights, perturbed, carried across.

The part targets (foreground flags exactly, part locations at 1e-5,
``tests/test_part_a2.py``), the U-Net decoder's voxel features, the seg and
part predictions and the stage-1 outputs at TOL; losses, predictions and
every gradient leaf as in tests/test_torch_voxel_rcnn.py. JAX's whole step
is one jitted call.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metatransformer_tpu.models import part_a2 as jpa
from metatransformer_tpu.ops import sparse_conv as jsp
from metatransformer_tpu_torch import recipes
from metatransformer_tpu_torch.configs import load_config
from metatransformer_tpu_torch.core import convert
from metatransformer_tpu_torch.models import part_a2 as pa, second, voxel_rcnn as vr
from metatransformer_tpu_torch.ops import sparse_conv as sp
from tests.test_torch_detector3d import (TOL, _t, check_predictions, check_train, close,
                                         det3d_batch, port_loss_and_grads)
from tests.test_torch_vit_adapter import perturb
from tests.test_torch_voxel_rcnn import jax_cfg, on_proposals

torch.set_num_threads(1)
PART_TOL = 1e-5


def smoke_cfg():
    return recipes.two_stage_config(
        "part_a2", load_config("metatransformer_tpu/configs/kitti_part_a2.yaml"), True)


def to_jax_cfg(cfg):
    return jpa.PartA2Config(**jax_cfg(cfg))


def test_part_targets_equal_jax():
    """Voxels of a hand-made active set against two boxes, one rotated and
    one padding: the foreground flags and the box-frame part locations."""
    cfg = smoke_cfg()
    rng = np.random.default_rng(0)
    coords = np.concatenate([rng.integers(0, 2, (300, 1)), rng.integers(0, 25, (300, 1)),
                             rng.integers(0, 64, (300, 2))], -1).astype(np.int64)
    valid = rng.uniform(size=300) < 0.9
    gt = np.asarray([[[3.2, 0.0, -0.5, 3.2, 1.6, 1.5, 0.4], [0] * 7],
                     [[2.0, 1.0, -1.0, 2.5, 2.0, 2.0, -0.3], [4.0, -1.5, -1.0, 2, 2, 2, 0]]],
                    np.float32)
    gv = np.asarray([[True, False], [True, True]])
    st = sp.SparseTensor(torch.zeros(300, 4), _t(coords), _t(valid), cfg.stage1.spatial_shape, 2)
    jst = jsp.SparseTensor(jnp.zeros((300, 4)), jnp.asarray(coords, jnp.int32),
                           jnp.asarray(valid), cfg.stage1.spatial_shape, 2)
    fg, part = pa.part_targets(st, _t(gt), _t(gv), cfg)
    jfg, jpart = jpa.part_targets(jst, jnp.asarray(gt), jnp.asarray(gv), to_jax_cfg(cfg))
    np.testing.assert_array_equal(fg.numpy(), np.asarray(jfg))
    close(part, jpart, PART_TOL)
    assert 5 < int(fg.sum()) < 250


@functools.lru_cache(maxsize=None)
def _setup():
    cfg = smoke_cfg()
    tree = perturb(convert.to_numpy(pa.init(cfg, torch.Generator().manual_seed(0), "cpu")), 5)
    anchors = second.generate_anchors(cfg.stage1)
    batch = det3d_batch(8)
    preds = pa.forward(convert.from_numpy(tree, "cpu"), _t(batch["points"]), cfg)[0]
    rois = vr.propose(preds, _t(anchors), pa.as_voxel_rcnn(cfg))[0].numpy()
    return to_jax_cfg(cfg), cfg, tree, on_proposals(batch, rois), anchors


@functools.lru_cache(maxsize=None)
def _jax_run():
    """JAX's training loss, logs and gradients with its forward's outputs,
    in one jitted call."""
    jcfg, _, tree, batch, anchors = _setup()
    args = [jnp.asarray(batch[k]) for k in ("points", "gt_boxes", "gt_valid")]

    def loss(p):
        total, logs = jpa.training_loss(p, args[0], args[1], args[2], jnp.asarray(anchors), jcfg)
        preds, dec, seg, part = jpa.forward(p, args[0], jcfg)
        return total, (logs, preds, dec.features, dec.valid, seg, part)

    (total, aux), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree.map(jnp.asarray, tree))
    return total, aux, grads


def test_forward_matches_jax():
    """Stage 1 over the encoder, the decoder's features on the input active
    set, the seg logits and the part predictions."""
    _, cfg, tree, batch, _ = _setup()
    preds, dec, seg, part = pa.forward(convert.from_numpy(tree, "cpu"), _t(batch["points"]), cfg)
    _, (_, jpreds, jfeat, jvalid, jseg, jpart), _ = _jax_run()
    for k in preds:
        close(preds[k], jpreds[k], TOL, k)
    np.testing.assert_array_equal(dec.valid.numpy(), np.asarray(jvalid))
    close(dec.features, jfeat, TOL, "decoder")
    close(seg, jseg, TOL, "seg")
    close(part, jpart, TOL, "part")
    assert (dec.features[dec.valid] != 0).any(-1).float().mean() > 0.5


def test_training_loss_and_gradients_match_jax():
    _, cfg, tree, batch, anchors = _setup()
    total, (logs, *_), grads = _jax_run()
    args = [_t(batch[k]) for k in ("points", "gt_boxes", "gt_valid")]
    port = port_loss_and_grads(lambda p: pa.training_loss(p, *args, _t(anchors), cfg), tree)
    check_train(port, (total, logs, grads))
    assert port[1]["rcnn_reg"] > 0 and port[1]["part"] > 0


def test_predict_equals_jax():
    jcfg, cfg, tree, batch, anchors = _setup()
    want = jpa.predict(jax.tree.map(jnp.asarray, tree), jnp.asarray(batch["points"]),
                       jnp.asarray(anchors), jcfg, score_thr=0.0, max_out=8)
    got = pa.predict(convert.from_numpy(tree, "cpu"), _t(batch["points"]), _t(anchors), cfg,
                     score_thr=0.0, max_out=8)
    check_predictions(got, want)


def test_init_tree_has_jax_keys_and_shapes():
    jcfg, _, tree, _, _ = _setup()
    want = jax.eval_shape(lambda k: jpa.init(jcfg, k), jax.random.PRNGKey(0))
    assert jax.tree.map(np.shape, tree) == jax.tree.map(lambda s: s.shape, want)


def test_init_takes_the_card_or_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pa.init(smoke_cfg(), torch.Generator().manual_seed(0))
