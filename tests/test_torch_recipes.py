"""The port's recipes (recipes.py) against the JAX package's, for every
ported recipe YAML at --smoke geometry on the CPU:

- ``synth`` batches are bit-equal to JAX's (integer labels widen to int64);
- the parameter trees have the same keys and shapes;
- with the JAX parameters carried across, ``forward`` on the same batch
  matches at the BF16 drift bound of tests/test_torch_pipeline.py (atol
  0.15, rtol 0.1); the two MAE losses (FP32) at 1e-4, with the reference's
  random draws passed in (the Mask2Former losses on them too); the graph
  recipe in eval mode (no generator);
- ``loss_fn`` matches at 1e-5 on fixed arrays.

The four COCO detection recipes are held in
tests/test_torch_detection_recipes.py, the fourteen 3D ones (PointPillars,
SECOND, Voxel R-CNN, PV-RCNN, SECOND-IoU, Part-A2, PV-RCNN++, PointRCNN,
IA-SSD, CaDDN, the three CenterPoint YAMLs and MDF SECOND) in
tests/test_torch_det3d_recipes.py. The three
point-zoo recipes (PointNeXt, CurveNet, SimpleView; FP32) and the five
point-segmentation ones (RandLA-Net, BAAF-Net, PointTransformer,
Stratified Transformer; FP32) are held here: synth, trees, and the first
step's logits at 1e-4 (as the MAE losses) and loss at 1e-5, with the
port's weights given to both (RandLA-Net with JAX's permutation). The one
YAML of a family the port does not have (the MoE image recipe) raises
NotImplementedError naming its ROADMAP item.
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
from metatransformer_tpu.heads import mask2former as jm2f
from metatransformer_tpu.models import video_pretrain as jvp
from metatransformer_tpu.train import step as jstep
from metatransformer_tpu_torch import recipes
from metatransformer_tpu_torch.configs import CONFIG_DIR, load_config
from metatransformer_tpu_torch.core import convert
from metatransformer_tpu_torch.core.tree import leaves_with_path
from metatransformer_tpu_torch.heads import mask2former as m2f
from metatransformer_tpu_torch.models import point_mae, video_pretrain
from metatransformer_tpu_torch.train import step as step_lib
from tests.test_torch_mask2former import host_lsa_on_host_arrays  # noqa: F401 (autouse)
from tests.test_torch_mask2former import jax_loss_draws

torch.set_num_threads(1)

PORTED = [
    "ade20k_mask2former_metatransformer.yaml", "ade20k_upernet_metatransformer.yaml",
    "coco_mask2former_metatransformer.yaml", "adult_tabtransformer.yaml", "bankm_tabtransformer.yaml", "etth1_metatransformer.yaml",
    "ettm1_imputation_metatransformer.yaml", "imagenet_large_metatransformer.yaml",
    "imagenet_metatransformer.yaml", "indianpines_caf_metatransformer.yaml",
    "indianpines_hyper_metatransformer.yaml", "kinetics400_metatransformer.yaml",
    "kinetics400_videomae_pretrain.yaml", "m4_metatransformer.yaml",
    "modelnet40_metatransformer.yaml", "modelnet40_pointmae_pretrain.yaml",
    "multimodal_fusion_metatransformer.yaml", "pavia_hyper_metatransformer.yaml",
    "pcqm4mv2_tokengt.yaml", "pcqm4mv2_tokengt_performer.yaml", "s3dis_metatransformer.yaml",
    "scannet_metatransformer.yaml", "scanobjectnn_metatransformer.yaml",
    "shapenetpart_metatransformer.yaml", "smd_anomaly_metatransformer.yaml",
    "speechcommands_metatransformer.yaml", "uea_metatransformer.yaml",
    "xray_chest_metatransformer.yaml",
]
# the recipes still to port, by the ROADMAP item that names them
UNPORTED = {"imagenet_moe_metatransformer.yaml": "item 8"}
# the COCO detection recipes, held in tests/test_torch_detection_recipes.py
DETECTION = ("coco_cascade_rcnn_metatransformer.yaml", "coco_htcpp_metatransformer.yaml",
             "coco_mask_rcnn_metatransformer.yaml",
             "coco_upgraded_mask_rcnn_metatransformer.yaml")
# the 3D detection recipes (KITTI, CenterPoint's nuScenes and Waymo, MDF's
# Waymo + nuScenes), held in tests/test_torch_det3d_recipes.py
DET3D = ("kitti_caddn.yaml", "kitti_centerpoint.yaml", "kitti_iassd.yaml", "kitti_part_a2.yaml",
         "kitti_point_rcnn.yaml", "kitti_pointpillars.yaml", "kitti_pv_rcnn.yaml",
         "kitti_pv_rcnn_pp.yaml", "kitti_second.yaml", "kitti_second_iou.yaml",
         "kitti_voxel_rcnn.yaml", "mdf_waymo_nusc_second.yaml", "nuscenes_centerpoint.yaml",
         "waymo_centerpoint.yaml")
# the point-classification zoo's recipes (FP32), held below
POINT_ZOO = ("modelnet40_curvenet.yaml", "modelnet40_pointnext.yaml",
             "scanobjectnn_simpleview.yaml")
# the point-segmentation baselines' recipes (FP32), held below
POINT_SEG = ("s3dis_baafnet.yaml", "s3dis_pointtransformer.yaml", "s3dis_randlanet.yaml",
             "s3dis_stratified.yaml", "semantickitti_randlanet.yaml")
MAE = ("kinetics400_videomae_pretrain.yaml", "modelnet40_pointmae_pretrain.yaml")
MASK2FORMER = ("ade20k_mask2former_metatransformer.yaml", "coco_mask2former_metatransformer.yaml")
GRAPH = ("pcqm4mv2_tokengt.yaml", "pcqm4mv2_tokengt_performer.yaml")
BATCH = 2
KEY = jax.random.PRNGKey(7)


def _path(name):
    return os.path.join(CONFIG_DIR, name)


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(JAX recipe, port recipe) at --smoke geometry; the port's on the CPU."""
    jrec = jrecipes.build(jload_config(_path(name)), jax.random.PRNGKey(0), smoke=True)
    rec = recipes.build(load_config(_path(name)), torch.Generator().manual_seed(0),
                        smoke=True, device="cpu")
    return jrec, rec


def _batches(rec, n=2, seed=3):
    return list(rec.synth(BATCH, n, seed))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_the_ported_list_is_exact():
    """Every shipped recipe is either ported or named unported: exact
    counts, so a new YAML or a newly ported family shows here."""
    every = sorted(n for n in os.listdir(CONFIG_DIR) if n.endswith(".yaml") and n != "default.yaml")
    assert len(PORTED) == 28 and len(DETECTION) == 4 and len(DET3D) == 14
    assert len(POINT_ZOO) == 3 and len(POINT_SEG) == 5 and len(UNPORTED) == 1
    assert len(PORTED + list(DETECTION) + list(DET3D) + list(POINT_ZOO) + list(POINT_SEG)) == 54
    assert sorted(PORTED + list(DETECTION) + list(DET3D) + list(POINT_ZOO) + list(POINT_SEG)
                  + list(UNPORTED)) == every


@pytest.mark.parametrize("name", PORTED)
def test_synth_is_bit_equal_to_jax(name):
    jrec, rec = _pair(name)
    got, want = _batches(rec, 2), list(jrec.synth(BATCH, 2, 3))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        g_leaves, w_leaves = leaves_with_path(g), leaves_with_path(_np(w))
        assert [p for p, _ in g_leaves] == [p for p, _ in w_leaves]
        for (path, a), (_, b) in zip(g_leaves, w_leaves):
            assert isinstance(a, np.ndarray), path
            np.testing.assert_array_equal(a, b, err_msg="/".join(map(str, path)))
            if path[0] in ("label", "cls") and np.issubdtype(a.dtype, np.integer):
                assert a.dtype == np.int64, path
            else:
                assert a.dtype == b.dtype, path


@pytest.mark.parametrize("name", PORTED)
def test_parameter_trees_have_the_same_keys_and_shapes(name):
    jrec, rec = _pair(name)
    got, want = leaves_with_path(rec.params), leaves_with_path(_np(jrec.params))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert tuple(a.shape) == tuple(b.shape), path
        assert a.device.type == "cpu"


def _forward_both(name, monkeypatch):
    """Both forwards on the first synthetic batch, the port's with the JAX
    parameters; the MAE recipes with JAX's draws passed in, the graph one
    in eval mode."""
    jrec, rec = _pair(name)
    np_params = _np(jrec.params)
    batch = _batches(rec, 1)[0]
    jx = jax.tree.map(jnp.asarray, batch["input"])
    key = None if name in GRAPH else KEY
    if name == MAE[0]:
        drawn = []
        orig = jvp.tube_mask
        monkeypatch.setattr(jvp, "tube_mask", lambda *a: drawn.append(orig(*a)) or drawn[-1])
        with jax.disable_jit():  # the mask as concrete indices
            want = jrec.forward(jax.tree.map(jnp.asarray, np_params), jx, key)
        vis, msk = (torch.tensor(np.asarray(a)).long() for a in drawn[0])
        monkeypatch.setattr(video_pretrain, "tube_mask", lambda *a, **k: (vis, msk))
    elif name in MASK2FORMER:  # jitted: its eager loss takes half a minute here
        want = jax.jit(jrec.forward)(jax.tree.map(jnp.asarray, np_params), jx, key)
    else:
        want = jrec.forward(jax.tree.map(jnp.asarray, np_params), jx, key)
    if name == MAE[1]:
        def forward(params, points, generator, cfg):
            b, n, _ = points.shape
            l = int(n * cfg.sample_ratio)  # noqa: E741
            shuffle = np.asarray(jnp.argsort(jax.random.uniform(KEY, (b, l)), axis=1))
            return point_mae.forward_at(params, points, torch.tensor(shuffle).long(), cfg)

        monkeypatch.setattr(point_mae, "forward", forward)
    if name in MASK2FORMER:  # JAX's loss points, from its key (2 layers, 3 gts, 64 points)
        draws = jax_loss_draws(KEY, 2, BATCH, 3, 64, jm2f.Mask2FormerConfig())
        loss = m2f.loss
        monkeypatch.setattr(m2f, "loss", lambda *a, **k: loss(*a, **k, draws=draws))
    with torch.no_grad():
        got = rec.forward(convert.from_numpy(np_params, "cpu"), batch["input"],
                          None if name in GRAPH else torch.Generator().manual_seed(0))
    return got, np.asarray(want), batch


@pytest.mark.parametrize("name", PORTED)
def test_forward_matches_jax_with_the_parameters_carried_across(name, monkeypatch):
    got, want, _ = _forward_both(name, monkeypatch)
    assert tuple(got.shape) == want.shape and torch.isfinite(got).all()
    if name in MAE:  # FP32 losses
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-4)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, atol=0.15, rtol=0.1)


@pytest.mark.parametrize("name", PORTED)
def test_loss_fn_matches_jax_on_fixed_arrays(name):
    jrec, rec = _pair(name)
    batch = _batches(rec, 1, seed=9)[0]
    jloss = jrec.loss_fn or jstep.cross_entropy_loss
    loss = rec.loss_fn or step_lib.cross_entropy_loss
    rng = np.random.default_rng(11)
    with torch.no_grad():
        out = np.asarray(rec.forward(rec.params, batch["input"], torch.Generator().manual_seed(0)))
    out = rng.standard_normal(out.shape).astype(np.float32) if out.ndim else out
    label = batch.get("label")
    want = float(jloss(jnp.asarray(out), jax.tree.map(jnp.asarray, label)))
    got = float(loss(torch.tensor(out), jax.tree.map(torch.tensor, label)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@functools.lru_cache(maxsize=None)
def _zoo_pair(name):
    """(JAX recipe, port recipe, JAX init's shapes) of a point-zoo YAML at
    --smoke geometry: the JAX recipe's init returns the port's weights (its
    eager init of CurveNet or SimpleView takes seconds), traced for shapes
    only."""
    from metatransformer_tpu.models import curvenet, point_baselines, simpleview  # noqa: F401
    from metatransformer_tpu.utils.registry import MODELS as JMODELS

    rec = recipes.build(load_config(_path(name)), torch.Generator().manual_seed(0),
                        smoke=True, device="cpu")
    weights, shapes = convert.to_numpy(rec.params), {}
    entry = JMODELS.get(load_config(_path(name)).model.NAME)

    def init(cfg, key):
        shapes["tree"] = jax.eval_shape(lambda k: real_init(cfg, k), key)
        return jax.tree.map(jnp.asarray, weights)

    real_init = entry.init
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(entry, "init", init)
        jrec = jrecipes.build(jload_config(_path(name)), jax.random.PRNGKey(0), smoke=True)
    return jrec, rec, shapes["tree"]


@pytest.mark.parametrize("name", POINT_ZOO)
def test_point_zoo_synth_and_trees_equal_jax(name):
    jrec, rec, shapes = _zoo_pair(name)
    for g, w in zip(_batches(rec, 2), jrec.synth(BATCH, 2, 3)):
        np.testing.assert_array_equal(g["input"], np.asarray(w["input"]))
        np.testing.assert_array_equal(g["label"], np.asarray(w["label"]))
        assert g["input"].dtype == np.float32 and g["label"].dtype == np.int64
    got = leaves_with_path(rec.params)
    want = leaves_with_path(jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes))
    assert [(p, tuple(a.shape)) for p, a in got] == [(p, b.shape) for p, b in want]


@pytest.mark.parametrize("name", POINT_ZOO)
def test_point_zoo_first_step_matches_jax(name):
    """The first synthetic batch's logits (FP32) at 1e-4 and their
    cross-entropy at 1e-5, the same weights in both. SimpleView runs in
    float64 on the reference's fp32 depth images, as in
    tests/test_torch_point_baselines.py: at fp32 the reference's own logits
    stand further from the float64 ones than the bound."""
    from tests.test_torch_point_baselines import ILL_CONDITIONED, _wide, fixed_views

    jrec, rec, _ = _zoo_pair(name)
    batch = _batches(rec, 1)[0]
    params, x = _np(jrec.params), batch["input"]
    family = load_config(_path(name)).model.NAME
    wide = family in ILL_CONDITIONED
    if wide:
        params, x = _wide(params), x.astype(np.float64)
    with fixed_views(family, recipes._point_zoo_smoke_cfg(family, 1), batch["input"]):
        with jax.enable_x64(wide):
            want = np.asarray(jax.jit(jrec.forward)(jax.tree.map(jnp.asarray, params),
                                                    jnp.asarray(x), KEY))
        with torch.no_grad():
            got = rec.forward(convert.from_numpy(params, "cpu"), x, None)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    jloss = float(jstep.cross_entropy_loss(jnp.asarray(want), jnp.asarray(batch["label"])))
    loss = float(step_lib.cross_entropy_loss(torch.tensor(want), torch.tensor(batch["label"])))
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    np.testing.assert_allclose(
        float(step_lib.cross_entropy_loss(got, torch.tensor(batch["label"]))), jloss, rtol=1e-4)


@functools.lru_cache(maxsize=None)
def _seg_pair(name):
    """(JAX recipe, port recipe, JAX init's shapes) of a point-segmentation
    YAML at --smoke geometry, the JAX recipe's init returning the port's
    weights (traced for shapes only), as ``_zoo_pair``."""
    from metatransformer_tpu.models import (  # noqa: F401  (their registry hooks)
        baafnet, point_transformer_seg, randlanet, stratified_transformer)
    from metatransformer_tpu.utils.registry import MODELS as JMODELS

    rec = recipes.build(load_config(_path(name)), torch.Generator().manual_seed(0),
                        smoke=True, device="cpu")
    weights, shapes = convert.to_numpy(rec.params), {}
    entry = JMODELS.get(load_config(_path(name)).model.NAME)

    def init(cfg, key):
        shapes["tree"] = jax.eval_shape(lambda k: real_init(cfg, k), key)
        return jax.tree.map(jnp.asarray, weights)

    real_init = entry.init
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(entry, "init", init)
        mp.setattr(point_transformer_seg, "init", init)  # its recipe calls the module's init
        jrec = jrecipes.build(jload_config(_path(name)), jax.random.PRNGKey(0), smoke=True)
    return jrec, rec, shapes["tree"]


@pytest.mark.parametrize("name", POINT_SEG)
def test_point_seg_synth_and_trees_equal_jax(name):
    jrec, rec, shapes = _seg_pair(name)
    for g, w in zip(_batches(rec, 2), jrec.synth(BATCH, 2, 3)):
        assert g["input"].keys() == w["input"].keys()
        for k in g["input"]:
            np.testing.assert_array_equal(g["input"][k], np.asarray(w["input"][k]))
            assert g["input"][k].dtype == np.float32
        np.testing.assert_array_equal(g["label"], np.asarray(w["label"]))
        assert g["label"].dtype == np.int64
    got = leaves_with_path(rec.params)
    want = leaves_with_path(jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes))
    assert [(p, tuple(a.shape)) for p, a in got] == [(p, b.shape) for p, b in want]


@pytest.mark.parametrize("name", POINT_SEG)
def test_point_seg_first_step_matches_jax(name, monkeypatch):
    """The first synthetic batch's per-point logits (FP32) at 1e-4 and
    their cross-entropy at 1e-5, the same weights in both; RandLA-Net's
    permutation is the reference's (its key 0)."""
    from metatransformer_tpu_torch.models import randlanet

    jrec, rec, _ = _seg_pair(name)
    batch = _batches(rec, 1)[0]
    n = batch["input"]["points"].shape[1]
    perm = torch.tensor(np.asarray(jax.random.permutation(jax.random.PRNGKey(0), n)))
    monkeypatch.setattr(randlanet, "default_perm", lambda *_: perm)
    want = np.asarray(jax.jit(jrec.forward)(jax.tree.map(jnp.asarray, _np(jrec.params)),
                                            jax.tree.map(jnp.asarray, batch["input"]), KEY))
    with torch.no_grad():
        got = rec.forward(convert.from_numpy(_np(jrec.params), "cpu"), batch["input"], None)
    assert got.shape == (BATCH, n, load_config(_path(name)).model.num_classes)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    jloss = float(jrec.loss_fn(jnp.asarray(want), jnp.asarray(batch["label"])))
    np.testing.assert_allclose(float(rec.loss_fn(torch.tensor(want), torch.tensor(batch["label"]))),
                               jloss, rtol=1e-5)
    np.testing.assert_allclose(float(rec.loss_fn(got, torch.tensor(batch["label"]))), jloss,
                               rtol=1e-4)


@pytest.mark.parametrize("name", sorted(UNPORTED))
def test_unported_recipes_raise_naming_their_item(name):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md queue 1, {UNPORTED[name]}"):
        recipes.build(load_config(_path(name)), torch.Generator().manual_seed(0),
                      smoke=True, device="cpu")


def test_unknown_modality_and_detector_exit_as_the_reference():
    cfg = load_config(_path("imagenet_metatransformer.yaml"), ["modality=smell"])
    with pytest.raises(SystemExit, match="no recipe builder for modality 'smell'"):
        recipes.build(cfg, torch.Generator(), device="cpu")
    cfg = load_config(_path("kitti_second.yaml"), ["model.NAME=Nope"])
    with pytest.raises(SystemExit, match="unknown 3D detector NAME 'Nope'"):
        recipes.build(cfg, torch.Generator(), device="cpu")


def test_shapenetpart_eval_metric_matches_jax():
    """The ShapeNetPart --eval protocol on the same parameters and batches."""
    name = "shapenetpart_metatransformer.yaml"
    jrec, rec = _pair(name)
    batches = _batches(rec, 2)
    params = convert.from_numpy(_np(jrec.params), "cpu")
    got = rec.eval_metric(params, rec.forward, batches)
    want = jrec.eval_metric(jrec.params, jrec.forward,
                            [jax.tree.map(jnp.asarray, b) for b in batches])
    assert got.keys() == want.keys() == {"ins_miou", "cls_miou"}
    for k in got:  # argmax over BF16 logits may flip a near-tie point
        np.testing.assert_allclose(got[k], want[k], atol=2.0)


def test_the_time_series_minute_column_is_the_hour_column():
    """ETTm1's freq: t reads a fifth calendar column the synthetic marks do
    not have; the reference's clamped gather reads the hour column, which
    the port repeats explicitly."""
    marks = torch.arange(24).reshape(1, 6, 4)
    got = recipes._calendar_marks(marks, "t")
    assert got.shape == (1, 6, 5) and torch.equal(got[..., 4], marks[..., 3])
    assert recipes._calendar_marks(marks, "h") is marks
    assert recipes._calendar_marks(None, "t") is None
