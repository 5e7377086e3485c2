"""The four COCO detection recipes (recipes.py ``build_detection2d`` and
``build_htc``) against the JAX package's at --smoke geometry on the CPU:

- ``synth`` batches bit-equal to JAX's;
- the parameter trees with JAX's keys and shapes (the reference's init
  traced with ``jax.eval_shape``: its eager init of the adapter takes
  tens of seconds here, and the recipes are built with it stubbed);
- ``forward`` on the same perturbed weights and batch under FP32 (the BF16
  policy patched to FP32 in both packages, as tests/test_torch_segmentor.py
  does) at rtol 1e-5, with LSJ's scale pinned to JAX's draw from the step's
  key; LSJ scales the boxes and leaves the masks as they are;
- one training step of coco_mask_rcnn as the CLI builds it: loss, every
  gradient leaf and the update against the reference's step computed in
  float64 (``check_step``), which also shows the whole backbone training at
  one rate, as in the reference.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metatransformer_tpu import recipes as jrecipes
from metatransformer_tpu.configs import load_config as jload_config
from metatransformer_tpu.core import encoder as jenc
from metatransformer_tpu.models import htc as jhtc
from metatransformer_tpu.models import mask_rcnn as jmrcnn
from metatransformer_tpu.train import optim as joptim
from metatransformer_tpu_torch import recipes, train_cli
from metatransformer_tpu_torch.configs import CONFIG_DIR, load_config
from metatransformer_tpu_torch.core import convert
from metatransformer_tpu_torch.core import encoder as enc
from metatransformer_tpu_torch.core.tree import leaves_with_path
from metatransformer_tpu_torch.models import mask_rcnn
from metatransformer_tpu_torch.train import augment
from tests.test_torch_mask_rcnn import jax_value_and_grad_f64
from tests.test_torch_recipes import DETECTION
from tests.test_torch_segmentor import check_step
from tests.test_torch_vit_adapter import perturb

torch.set_num_threads(1)
BATCH = 2
KEY = jax.random.PRNGKey(7)
LOSS_RTOL = 1e-5


def _path(name):
    return os.path.join(CONFIG_DIR, name)


def _shaped(init):
    """The reference's init, traced for shapes only, filled with zeros."""
    def fn(cfg, key):
        shapes = jax.eval_shape(functools.partial(init, cfg), key)
        return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)

    return fn


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(JAX recipe with its init stubbed, port recipe) at --smoke geometry."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmrcnn, "init", _shaped(jmrcnn.init))
        mp.setattr(jhtc, "init", _shaped(jhtc.init))
        jrec = jrecipes.build(jload_config(_path(name)), jax.random.PRNGKey(0), smoke=True)
    rec = recipes.build(load_config(_path(name)), torch.Generator().manual_seed(0), smoke=True,
                        device="cpu")
    return jrec, rec


def _weights(rec, seed=2):
    return perturb(convert.to_numpy(rec.params), seed=seed, scale=0.02)


@pytest.mark.parametrize("name", DETECTION)
def test_synth_is_bit_equal_to_jax(name):
    jrec, rec = _pair(name)
    got, want = list(rec.synth(BATCH, 2, 3)), list(jrec.synth(BATCH, 2, 3))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        g_leaves = leaves_with_path(g)
        w_leaves = leaves_with_path(jax.tree.map(np.asarray, w))
        assert [p for p, _ in g_leaves] == [p for p, _ in w_leaves]
        for (path, a), (_, b) in zip(g_leaves, w_leaves):
            assert isinstance(a, np.ndarray) and a.dtype == b.dtype, path
            np.testing.assert_array_equal(a, b, err_msg="/".join(map(str, path)))


@pytest.mark.parametrize("name", DETECTION)
def test_parameter_trees_have_the_same_keys_and_shapes(name):
    jrec, rec = _pair(name)
    got, want = leaves_with_path(rec.params), leaves_with_path(jrec.params)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert tuple(a.shape) == tuple(b.shape), path
        assert a.device.type == "cpu"


def _lsj_scale():
    """The scale JAX's LSJ draws from KEY (augment.large_scale_jitter)."""
    return float(jax.random.uniform(jax.random.split(KEY)[0], (), minval=0.1, maxval=2.0))


def _pin_lsj(monkeypatch):
    lsj = augment.large_scale_jitter
    monkeypatch.setattr(augment, "large_scale_jitter",
                        lambda g, x, b, *a, **k: lsj(g, x, b, *a, scale=_lsj_scale(), **k))


@pytest.mark.parametrize("name", [n for n in DETECTION if "coco_mask_rcnn" not in n])
def test_forward_matches_jax_under_fp32(name, monkeypatch):
    """(coco_mask_rcnn's forward is held in its step below.)"""
    monkeypatch.setattr(enc, "BF16", enc.FP32)
    monkeypatch.setattr(jenc, "BF16", jenc.FP32)
    _pin_lsj(monkeypatch)
    jrec, rec = _pair(name)
    params = _weights(rec)
    batch = next(iter(rec.synth(BATCH, 1, 3)))["input"]
    want = jax.jit(jrec.forward)(jax.tree.map(jnp.asarray, params),
                                 jax.tree.map(jnp.asarray, batch), KEY)
    with torch.no_grad():
        got = rec.forward(convert.from_numpy(params, "cpu"), batch,
                          torch.Generator().manual_seed(0))
    assert got.shape == () and torch.isfinite(got)
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)


def test_lsj_scales_the_boxes_and_leaves_the_masks(monkeypatch):
    """Reference caveat kept: the upgraded recipe's LSJ scales the image and
    the boxes but hands forward_train the masks as they were."""
    _pin_lsj(monkeypatch)
    _, rec = _pair("coco_upgraded_mask_rcnn_metatransformer.yaml")
    batch = next(iter(rec.synth(BATCH, 1, 3)))["input"]
    seen = {}

    def forward_train(p, img, boxes, *a, gt_masks=None, **k):
        seen.update(image=img, boxes=boxes, masks=gt_masks)
        return torch.zeros(()), {}

    monkeypatch.setattr(mask_rcnn, "forward_train", forward_train)
    rec.forward(rec.params, batch, torch.Generator().manual_seed(0))
    scale = _lsj_scale()
    np.testing.assert_array_equal(seen["masks"].numpy(), batch["gt_masks"])
    want = np.minimum(np.maximum(batch["gt_boxes"] * np.float32(scale), 0), 63)
    np.testing.assert_allclose(seen["boxes"].numpy(), want, rtol=1e-6)
    assert not np.allclose(seen["image"].numpy(), batch["image"])


def test_coco_mask_rcnn_step_matches_jax_and_trains_the_whole_backbone(monkeypatch):
    """One AdamW step through ``train_cli.setup`` from perturbed weights
    against the reference's loss, gradients and optax update in float64:
    nothing is frozen and every rate factor is 1 despite the YAML's
    ``frozen: true`` and ``layer_decay: 0.95``, since the tree has no
    top-level "encoder" (the reference's behaviour)."""
    monkeypatch.setattr(enc, "BF16", enc.FP32)
    monkeypatch.setattr(jenc, "BF16", jenc.FP32)
    name = "coco_mask_rcnn_metatransformer.yaml"
    jrec, _ = _pair(name)
    cfg = jload_config(_path(name))
    session = train_cli.setup(["--cfg", _path(name), "--smoke", "--device", "cpu", "--epochs",
                               "1", "--steps-per-epoch", "1", "train.batch_size=2"])
    trainer = session.trainer
    assert cfg.encoder.frozen and cfg.train.layer_decay == 0.95
    assert trainer.frozen == {} and set(trainer.trainable) == {"backbone", "fpn", "rpn", "rcnn"}
    assert all(s == 1.0 for s in trainer.optimizer.lr_scales)
    params = _weights(session.recipe)
    for (_, leaf), (_, src) in zip(leaves_with_path(trainer.trainable), leaves_with_path(params)):
        with torch.no_grad():
            leaf.copy_(torch.tensor(src))
    start = convert.to_numpy(trainer.trainable)
    batch = next(iter(session.recipe.synth(2, 1, 3)))
    port_loss = trainer.train_epoch([batch], torch.Generator().manual_seed(0))["loss"]

    keys = sorted(batch["input"])
    loss, _, grads = jax_value_and_grad_f64(
        lambda p, *a: (jrec.forward(p, dict(zip(keys, a)), KEY), {}), params,
        *(batch["input"][k] for k in keys))
    tx = joptim.build(cfg.train.optimizer, cfg.train.lr, weight_decay=cfg.train.weight_decay,
                      layer_decay=cfg.train.get("layer_decay"), encoder_depth=12)
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
        g64 = jax.tree.map(jnp.asarray, grads)
        updates, _ = jax.jit(tx.update)(g64, tx.init(p64), p64)
        updates = jax.tree.map(lambda u: np.asarray(u, np.float32), updates)
    check_step(port_loss, loss, trainer, start, jax.tree.map(np.float32, grads), updates)
