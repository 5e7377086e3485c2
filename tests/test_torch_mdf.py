"""The port's multi-dataset fusion (models/mdf.py, models/mdf_detectors.py)
against the JAX package on the CPU, FP32, with seeded weights, perturbed,
carried across.

UniNorm, domain attention and the MDF classifier: outputs at 1e-5 and the
gradients of a fixed loss within GRAD_TOL of each leaf's largest reference
value, for each dataset id, given as a Python int or a 0-d tensor. The
affine stacking and selection round-trip. MDF SECOND at the recipe's smoke
geometry: the merged two-dataset step (``weight_a * loss_a + weight_b *
loss_b``, dataset ids 0 and 1) at 1e-5 with every gradient leaf as
``check_train``, and both datasets' rows of every stacked norm affine take
a gradient in that one step. MDF CenterPoint on the KITTI smoke geometry:
the prediction maps at 1e-4 (tests/test_torch_centerpoint.py's bound) and
its loss and gradients for dataset 1.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metatransformer_tpu.models import mdf as jmdf
from metatransformer_tpu.models import mdf_detectors as jmd
from metatransformer_tpu.models import second as jsecond
from metatransformer_tpu_torch import recipes
from metatransformer_tpu_torch.configs import load_config
from metatransformer_tpu_torch.core import convert
from metatransformer_tpu_torch.core.tree import leaves_with_path
from metatransformer_tpu_torch.models import mdf, mdf_detectors as md, second
from tests.test_torch_centerpoint import to_jax as cp_to_jax
from tests.test_torch_detector3d import (GRAD_TOL, TOL, _t, check_train, close, det3d_batch,
                                         port_loss_and_grads)
from tests.test_torch_vit_adapter import perturb

torch.set_num_threads(1)
MDF_YAML = "metatransformer_tpu/configs/mdf_waymo_nusc_second.yaml"


def _grads_close(got, want):
    """Each gradient leaf within GRAD_TOL of its largest reference value; a
    leaf the reference leaves at zero but for rounding (below 1e-6 of the
    tree's largest: the bias ahead of UniNorm) near zero in the port too, as
    ``check_train``."""
    flat, jflat = leaves_with_path(got), leaves_with_path(jax.tree.map(np.asarray, want))
    assert [p for p, _ in flat] == [p for p, _ in jflat]
    largest = max(np.abs(w).max() for _, w in jflat)
    for (path, g), (_, w) in zip(flat, jflat):
        if np.abs(w).max() < 1e-6 * largest:
            assert np.abs(g).max() < 1e-5 * largest, path
            continue
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_TOL * np.abs(w).max(), err_msg=str(path))


def _fixed_loss(out, weights):
    return (out * weights).sum() + 0.1 * (out**2).sum()


@pytest.mark.parametrize("dataset_id", [0, 1, "tensor"])
def test_uni_norm_and_domain_attention_match_jax(dataset_id):
    rng = np.random.default_rng(0)
    norm_cfg = mdf.UniNormConfig(12, 2)
    attn_cfg = mdf.DomainAttentionConfig(12, 2, reduction=4)
    tree = perturb({"norm": convert.to_numpy(mdf.uni_norm_init(norm_cfg)),
                    "attn": convert.to_numpy(mdf.domain_attention_init(
                        attn_cfg, torch.Generator().manual_seed(1)))}, seed=2, scale=0.3)
    x = rng.standard_normal((3, 5, 4, 12)).astype(np.float32) * 2 + 1
    weights = rng.standard_normal(x.shape).astype(np.float32)
    did = torch.tensor(1) if dataset_id == "tensor" else dataset_id
    jid = jnp.int32(1 if dataset_id == "tensor" else dataset_id)

    def jax_fn(p):
        h = jmdf.uni_norm_apply(p["norm"], jnp.asarray(x), jid,
                                jmdf.UniNormConfig(**norm_cfg.__dict__))
        out = jmdf.domain_attention_apply(p["attn"], h,
                                          jmdf.DomainAttentionConfig(**attn_cfg.__dict__))
        return _fixed_loss(out, jnp.asarray(weights)), out

    (_, want), jgrads = jax.value_and_grad(jax_fn, has_aux=True)(jax.tree.map(jnp.asarray, tree))

    def port_fn(p):
        out = mdf.domain_attention_apply(
            p["attn"], mdf.uni_norm_apply(p["norm"], _t(x), did, norm_cfg), attn_cfg)
        return _fixed_loss(out, _t(weights)), out

    _, out, grads = port_loss_and_grads(port_fn, tree)
    close(out, want, TOL)
    _grads_close(grads, jgrads)
    other = 1 - int(did)
    assert (grads["norm"]["scale"][other] == 0).all() and (grads["norm"]["scale"][int(did)] != 0).all()


@pytest.mark.parametrize("dataset_id", [0, 1])
def test_mdf_classifier_matches_jax(dataset_id):
    cfg = mdf.MDFClassifierConfig()
    jcfg = jmdf.MDFClassifierConfig(**cfg.__dict__)
    tree = perturb(convert.to_numpy(mdf.mdf_classifier_init(cfg, torch.Generator().manual_seed(3), "cpu")),
                   seed=4, scale=0.3)
    assert jax.tree.map(np.shape, tree) == jax.tree.map(
        lambda s: s.shape, jax.eval_shape(lambda k: jmdf.mdf_classifier_init(jcfg, k),
                                          jax.random.PRNGKey(0)))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, cfg.in_dim)).astype(np.float32)
    weights = rng.standard_normal((6, cfg.num_classes)).astype(np.float32)

    def jax_fn(p):
        out = jmdf.mdf_classifier_forward(p, jnp.asarray(x), jnp.int32(dataset_id), jcfg)
        return _fixed_loss(out, jnp.asarray(weights)), out

    (_, want), jgrads = jax.value_and_grad(jax_fn, has_aux=True)(jax.tree.map(jnp.asarray, tree))

    def port_fn(p):
        out = mdf.mdf_classifier_forward(p, _t(x), dataset_id, cfg)
        return _fixed_loss(out, _t(weights)), out

    _, out, grads = port_loss_and_grads(port_fn, tree)
    close(out, want, TOL)
    _grads_close(grads, jgrads)


def test_mdf_classifier_init_takes_the_card_or_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mdf.mdf_classifier_init(mdf.MDFClassifierConfig(), torch.Generator().manual_seed(0))


def test_stacked_affines_round_trip():
    tree = {"a": {"w": torch.randn(3, 4), "bn_scale": torch.randn(4)},
            "b": [{"gn_bias": torch.randn(2), "b": torch.randn(2)}]}
    stacked = md.stack_norm_affines(tree, 3)
    assert stacked["a"]["bn_scale"].shape == (3, 4) and stacked["a"]["w"].shape == (3, 4)
    assert stacked["b"][0]["gn_bias"].shape == (3, 2) and stacked["b"][0]["b"].shape == (2,)
    for i in (0, 2, torch.tensor(1)):
        back = md.select_dataset(stacked, i)
        for (p, a), (q, b) in zip(leaves_with_path(back), leaves_with_path(tree)):
            assert p == q and torch.equal(a, b)


# --------------------------------------------------------------------------
# MDF SECOND, the merged two-dataset step
# --------------------------------------------------------------------------


def _jax_second_cfg(cfg):
    return jmd.MDFSECONDConfig(base=jsecond.SECONDConfig(**cfg.base.__dict__),
                               num_datasets=cfg.num_datasets,
                               domain_attention=cfg.domain_attention, reduction=cfg.reduction)


@functools.lru_cache(maxsize=None)
def _second_setup():
    """(port cfg, JAX cfg, numpy weights, the two datasets' batches,
    anchors)."""
    cfg = recipes.mdf_second_config(load_config(MDF_YAML), smoke=True)
    tree = perturb(convert.to_numpy(md.init(cfg, torch.Generator().manual_seed(0), "cpu")), 6)
    batches = (det3d_batch(7), det3d_batch(8))
    return cfg, _jax_second_cfg(cfg), tree, batches, second.generate_anchors(cfg.base)


_KEYS = ("points", "gt_boxes", "gt_valid")
WEIGHTS = (1.0, 0.5)


@functools.lru_cache(maxsize=None)
def _second_jax_run():
    _, jcfg, tree, batches, anchors = _second_setup()

    def loss(p):
        parts = [jmd.training_loss(p, *(jnp.asarray(b[k]) for k in _KEYS), jnp.asarray(anchors),
                                   jcfg, jnp.int32(i)) for i, b in enumerate(batches)]
        total = sum(w * t for w, (t, _) in zip(WEIGHTS, parts))
        logs = {f"{k}_{i}": v for i, (_, lg) in enumerate(parts) for k, v in lg.items()}
        preds = jmd.forward(p, jnp.asarray(batches[1]["points"]), jcfg, jnp.int32(1))
        return total, (logs, preds)

    (total, (logs, preds)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree.map(jnp.asarray, tree))
    return total, logs, grads, preds


def test_mdf_second_forward_matches_jax():
    cfg, _, tree, batches, _ = _second_setup()
    want = _second_jax_run()[3]
    with torch.no_grad():
        got = md.forward(convert.from_numpy(tree, "cpu"), _t(batches[1]["points"]), cfg,
                         torch.tensor(1))
    assert got.keys() == want.keys()
    for k in got:
        close(got[k], want[k], TOL, k)


def test_mdf_second_merged_step_matches_jax_and_trains_both_datasets():
    cfg, _, tree, batches, anchors = _second_setup()
    total, logs, grads, _ = _second_jax_run()

    def loss(p):
        parts = [md.training_loss(p, *(_t(b[k]) for k in _KEYS), _t(anchors), cfg, i)
                 for i, b in enumerate(batches)]
        return (sum(w * t for w, (t, _) in zip(WEIGHTS, parts)),
                {f"{k}_{i}": v for i, (_, lg) in enumerate(parts) for k, v in lg.items()})

    port = port_loss_and_grads(loss, tree)
    check_train(port, (total, logs, grads))
    stacked = [(p, g) for p, g in leaves_with_path(port[2]) if p[-1] in md._STACKED_KEYS]
    assert len(stacked) > 20
    for path, g in stacked:
        assert g.shape[0] == 2 and (np.abs(g).sum(-1) > 0).all(), path


def test_mdf_second_init_tree_has_jax_keys_and_shapes():
    _, jcfg, tree, _, _ = _second_setup()
    want = jax.eval_shape(lambda k: jmd.init(jcfg, k), jax.random.PRNGKey(0))
    assert jax.tree.map(np.shape, tree) == jax.tree.map(lambda s: s.shape, want)


def test_mdf_second_init_takes_the_card_or_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        md.init(_second_setup()[0], torch.Generator().manual_seed(0))


# --------------------------------------------------------------------------
# MDF CenterPoint
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _cp_setup():
    base = recipes.centerpoint_config(load_config("metatransformer_tpu/configs/kitti_centerpoint.yaml"),
                                      smoke=True)
    cfg = md.MDFCenterPointConfig(base=base, reduction=4)
    jcfg = jmd.MDFCenterPointConfig(base=cp_to_jax(base), reduction=4)
    tree = perturb(convert.to_numpy(md.init_centerpoint(cfg, torch.Generator().manual_seed(1),
                                                        "cpu")), 7)
    batch = dict(det3d_batch(9, num_classes=base.num_classes))
    batch["gt_labels"] = np.random.default_rng(10).integers(0, base.num_classes,
                                                            batch["gt_labels"].shape)
    return cfg, jcfg, tree, batch


@functools.lru_cache(maxsize=None)
def _cp_jax_run():
    _, jcfg, tree, batch = _cp_setup()
    args = [jnp.asarray(batch[k]) for k in ("points", "gt_boxes", "gt_labels", "gt_valid")]

    def loss(p):
        total, logs = jmd.training_loss_centerpoint(p, *args, jcfg, jnp.int32(1))
        return total, (logs, jmd.forward_centerpoint(p, args[0], jcfg, jnp.int32(1)))

    (total, (logs, preds)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree.map(jnp.asarray, tree))
    return total, logs, grads, preds


def test_mdf_centerpoint_matches_jax():
    cfg, jcfg, tree, batch = _cp_setup()
    total, logs, grads, want = _cp_jax_run()
    assert jax.tree.map(np.shape, tree) == jax.tree.map(
        lambda s: s.shape, jax.eval_shape(lambda k: jmd.init_centerpoint(jcfg, k),
                                          jax.random.PRNGKey(0)))
    args = [_t(batch[k]) for k in ("points", "gt_boxes", "gt_labels", "gt_valid")]
    with torch.no_grad():
        got = md.forward_centerpoint(convert.from_numpy(tree, "cpu"), args[0], cfg, 1)
    for k in got:
        close(got[k], want[k], 1e-4, k)
    port = port_loss_and_grads(
        lambda p: md.training_loss_centerpoint(p, *args, cfg, 1), tree)
    check_train(port, (total, logs, grads))
