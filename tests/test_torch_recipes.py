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
tests/test_torch_detection_recipes.py, the four KITTI ones (PointPillars,
SECOND, Voxel R-CNN, PV-RCNN) in tests/test_torch_det3d_recipes.py. The 19
YAMLs of families the port does not have raise NotImplementedError naming
their ROADMAP item.
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
UNPORTED = {
    "imagenet_moe_metatransformer.yaml": "item 8",
    **{name: "item 9" for name in (
        "kitti_caddn.yaml",
        "kitti_centerpoint.yaml", "kitti_iassd.yaml", "kitti_part_a2.yaml",
        "kitti_point_rcnn.yaml", "kitti_pv_rcnn_pp.yaml", "kitti_second_iou.yaml",
        "mdf_waymo_nusc_second.yaml", "nuscenes_centerpoint.yaml",
        "waymo_centerpoint.yaml", "modelnet40_curvenet.yaml", "modelnet40_pointnext.yaml",
        "scanobjectnn_simpleview.yaml", "s3dis_baafnet.yaml", "s3dis_pointtransformer.yaml",
        "s3dis_randlanet.yaml", "s3dis_stratified.yaml", "semantickitti_randlanet.yaml",
    )},
}
# the COCO detection recipes, held in tests/test_torch_detection_recipes.py
DETECTION = ("coco_cascade_rcnn_metatransformer.yaml", "coco_htcpp_metatransformer.yaml",
             "coco_mask_rcnn_metatransformer.yaml",
             "coco_upgraded_mask_rcnn_metatransformer.yaml")
# the KITTI detection recipes, held in tests/test_torch_det3d_recipes.py
DET3D = ("kitti_pointpillars.yaml", "kitti_pv_rcnn.yaml", "kitti_second.yaml",
         "kitti_voxel_rcnn.yaml")
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
    assert len(PORTED) == 28 and len(DETECTION) == len(DET3D) == 4 and len(UNPORTED) == 19
    assert sorted(PORTED + list(DETECTION) + list(DET3D) + list(UNPORTED)) == every


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
