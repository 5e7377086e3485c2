"""The port's fourteen 3D detection recipes (recipes.py: the KITTI
PointPillars, SECOND, Voxel R-CNN, PV-RCNN, SECOND-IoU, Part-A2, PV-RCNN++,
PointRCNN, IA-SSD and CaDDN, CenterPoint on KITTI, nuScenes and Waymo, and
MDF SECOND on Waymo + nuScenes) against the JAX package's at --smoke
geometry on the CPU, FP32:

- ``synth`` batches are bit-equal to JAX's;
- the parameter trees have the same keys and shapes as the reference's
  init (traced for shapes only);
- with the port's seeded weights (perturbed) given to both, ``forward``
  (the training loss) matches at 1e-5.

tests/test_torch_train_cli.py trains each of the fourteen one step through
``train_cli``.
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
from metatransformer_tpu.models import caddn as jcaddn
from metatransformer_tpu.models import centerpoint as jcp
from metatransformer_tpu.models import detector3d as jdet
from metatransformer_tpu.models import iassd as jiassd
from metatransformer_tpu.models import mdf_detectors as jmd
from metatransformer_tpu.models import part_a2 as jpa
from metatransformer_tpu.models import point_rcnn as jprc
from metatransformer_tpu.models import pv_rcnn as jpv
from metatransformer_tpu.models import pv_rcnn_pp as jpp
from metatransformer_tpu.models import second as jsecond
from metatransformer_tpu.models import second_iou as jsi
from metatransformer_tpu.models import voxel_rcnn as jvr
from metatransformer_tpu_torch import recipes
from metatransformer_tpu_torch.configs import CONFIG_DIR, load_config
from metatransformer_tpu_torch.core import convert
from metatransformer_tpu_torch.core.tree import leaves_with_path
from metatransformer_tpu_torch.models import caddn
from tests.test_torch_caddn import held_assignments, replaying
from tests.test_torch_recipes import DET3D
from tests.test_torch_vit_adapter import perturb

torch.set_num_threads(1)
BATCH = 2
LOSS_RTOL = 1e-5
JAX_INIT = {"kitti_pointpillars.yaml": jdet, "kitti_second.yaml": jsecond,
            "kitti_voxel_rcnn.yaml": jvr, "kitti_pv_rcnn.yaml": jpv,
            "kitti_second_iou.yaml": jsi, "kitti_part_a2.yaml": jpa,
            "kitti_pv_rcnn_pp.yaml": jpp, "kitti_centerpoint.yaml": jcp,
            "nuscenes_centerpoint.yaml": jcp, "waymo_centerpoint.yaml": jcp,
            "kitti_point_rcnn.yaml": jprc, "kitti_iassd.yaml": jiassd,
            "kitti_caddn.yaml": jcaddn, "mdf_waymo_nusc_second.yaml": jmd}


def _path(name):
    return os.path.join(CONFIG_DIR, name)


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(JAX recipe, port recipe, numpy weights, JAX init's shapes): the JAX
    recipe is built with its init replaced by the port's perturbed weights
    (the reference's eager init takes 20 s and more here)."""
    rec = recipes.build(load_config(_path(name)), torch.Generator().manual_seed(0), smoke=True,
                        device="cpu")
    weights = perturb(convert.to_numpy(rec.params), seed=3, scale=0.02)
    mod, shapes = JAX_INIT[name], {}

    def init(cfg, key):
        shapes["tree"] = jax.eval_shape(functools.partial(mod.init.__wrapped__, cfg), key)
        return jax.tree.map(jnp.asarray, weights)

    init.__wrapped__ = mod.init
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod, "init", init)
        jrec = jrecipes.build(jload_config(_path(name)), jax.random.PRNGKey(0), smoke=True)
    return jrec, rec, weights, shapes["tree"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("name", DET3D)
def test_synth_is_bit_equal_to_jax(name):
    jrec, rec, _, _ = _pair(name)
    got, want = list(rec.synth(BATCH, 2, 3)), list(jrec.synth(BATCH, 2, 3))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        g_leaves, w_leaves = leaves_with_path(g), leaves_with_path(_np(w))
        assert [p for p, _ in g_leaves] == [p for p, _ in w_leaves]
        for (path, a), (_, b) in zip(g_leaves, w_leaves):
            assert a.dtype == b.dtype, path
            np.testing.assert_array_equal(a, b, err_msg=str(path))


@pytest.mark.parametrize("name", DET3D)
def test_parameter_trees_have_the_same_keys_and_shapes(name):
    _, rec, _, shapes = _pair(name)
    got = [(p, tuple(v.shape)) for p, v in leaves_with_path(rec.params)]
    want = [(p, tuple(v.shape)) for p, v in leaves_with_path(
        jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes))]
    assert got == want


@pytest.mark.parametrize("name", DET3D)
def test_forward_matches_jax(name, monkeypatch):
    """CaDDN's anchor assignment meets exact ties (tests/test_torch_caddn.py):
    the reference's is replayed, once the port's own is held to it."""
    jrec, rec, weights, _ = _pair(name)
    batch = next(iter(rec.synth(BATCH, 1, 5)))["input"]
    if name == "kitti_caddn.yaml":
        cfg = recipes.caddn_config(load_config(_path(name)), smoke=True)
        replaying(monkeypatch, assignments=held_assignments(
            caddn.generate_anchors(cfg), batch["gt_boxes"], batch["gt_valid"], cfg))
    want = jax.jit(jrec.forward)(jax.tree.map(jnp.asarray, weights),
                                 jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(1))
    got = rec.forward(convert.from_numpy(weights, "cpu"), batch, None)
    assert np.isfinite(float(want)) and float(want) > 0
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL, atol=1e-6)
