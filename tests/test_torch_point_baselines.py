"""The port's point-cloud baseline zoo (models/point_baselines.py,
point_baselines2.py and point_baselines3.py: PointNet++, DGCNN, PointMLP,
PointNeXt, PointNet, PCT, PointViT, DeepGCN, BallDGCNN, GroupPointNet and
ViTGraph) against the JAX package on the CPU, FP32, at the recipes' smoke
geometry (``recipes._point_zoo_smoke_cfg``: 64 points a cloud, batch 2),
with the port's seeded weights, perturbed, carried across.

Each family's logits at FWD_TOL (the 1e-5 of ``tests/test_point_baselines*.py``,
relative to the largest logit), its gradient of a fixed loss within
ZOO_GRAD_TOL of each leaf's largest JAX value, and its tree's keys and
shapes against the reference's init. ZOO_GRAD_TOL is 1e-3, the loosest of
the JAX tests (``tests/test_part_a2.py``): train-mode BatchNorm at batch 2
divides by a two-sample spread, and the two packages' fp32 gradients stand
up to 1.3e-4 of a leaf's largest value apart (PointMLP's embed/bn_bias,
PCT's fuse/bn_scale). PointNet and SimpleView (``ILL_CONDITIONED``) run in
float64 on both sides, since JAX's own fp32 logits stand further from the
float64 ones than the port's: PointNet's perturbed STN regresses 64 x 64
transforms with entries near 1 (JAX 1.2e-3 off, the port 4.4e-4);
SimpleView's MVFC BatchNorm runs over a batch of 2 (JAX 1.9e-5, the port
1.2e-6). Neither samples by FPS, so the reference runs under
``jax.enable_x64``; its SimpleView computes its depth images in fp32 only,
so both trunks there take the reference's fp32 images, widened (the
projections are held on their own in tests/test_torch_simpleview.py). FPS
runs as the reference's on the CPU and the port's plain version, index for
index. Also PointNet's feature-transform regulariser, the max-pool's and
the gated activations' values and gradients (exactly, ties and zeros
included, and with their choices replayed), the registry entries, and the
init landing on the card or raising.
"""

import contextlib
import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metatransformer_tpu import recipes as jrecipes
from metatransformer_tpu.models import curvenet as jcn
from metatransformer_tpu.models import point_baselines as jpb
from metatransformer_tpu.models import point_baselines2 as jpb2
from metatransformer_tpu.models import point_baselines3 as jpb3
from metatransformer_tpu.models import simpleview as jsv
from metatransformer_tpu.utils.registry import MODELS as JMODELS
from metatransformer_tpu_torch import recipes
from metatransformer_tpu_torch.core import convert
from metatransformer_tpu_torch.core.tree import leaves_with_path
from metatransformer_tpu_torch.models import point_baselines as pb
from metatransformer_tpu_torch.models import point_baselines2 as pb2
from metatransformer_tpu_torch.models import simpleview as sv
from metatransformer_tpu_torch.ops import gates
from metatransformer_tpu_torch.utils.registry import MODELS
from tests.test_torch_detector3d import port_loss_and_grads
from tests.test_torch_vit_adapter import perturb

torch.set_num_threads(1)
FWD_TOL = 1e-5
ZOO_GRAD_TOL = 1e-3
# held in float64 on both sides: the reference's fp32 is the less exact one
ILL_CONDITIONED = ("PointNetEncoder", "SimpleView")
NUM_CLASSES = 4
FAMILIES = ("PointNet2Encoder", "DGCNN", "PointMLP", "PointNeXt", "PointNetEncoder", "PCT",
            "PointViT", "DeepGCN", "BallDGCNN", "GroupPointNet", "ViTGraph")
_JAX_MODULES = (jpb, jpb2, jpb3, jcn, jsv)  # their imports fill the JAX registry


def to_jax(value):
    """A port config (nested frozen dataclasses) as the JAX package's
    class of the same name, field for field."""
    if dataclasses.is_dataclass(value):
        cls = next(getattr(m, type(value).__name__) for m in _JAX_MODULES
                   if hasattr(m, type(value).__name__))
        return cls(**{f.name: to_jax(getattr(value, f.name)) for f in dataclasses.fields(value)})
    if isinstance(value, tuple):
        return tuple(to_jax(v) for v in value)
    return value


def cloud(seed, b=2, n=64):
    return (np.random.default_rng(seed).standard_normal((b, n, 3)) * 0.5).astype(np.float32)


def _loss_of(logits, weights):
    return (logits * weights).sum() + 0.1 * (logits**2).sum()


def _wide(tree):
    return jax.tree.map(lambda a: a.astype(np.float64) if a.dtype == np.float32 else a, tree)


@functools.lru_cache(maxsize=None)
def _depth_images(pts_bytes, cfg):
    pts = np.frombuffer(pts_bytes, np.float32).reshape(2, -1, 3)
    return np.asarray(jsv.project_views(jnp.asarray(pts), cfg.resolution, cfg.size_xy))


def fixed_views(name, cfg, pts):
    """Context: SimpleView held in float64 takes the reference's fp32 depth
    images of ``pts`` in both packages (see the module docstring)."""
    stack = contextlib.ExitStack()
    if name == "SimpleView" and name in ILL_CONDITIONED:
        img = _depth_images(np.asarray(pts, np.float32).tobytes(), cfg)
        stack.enter_context(mock.patch.object(
            jsv, "project_views", lambda *a: jnp.asarray(img, jnp.float64)))
        stack.enter_context(mock.patch.object(
            sv, "project_views", lambda *a: torch.tensor(img, dtype=torch.float64)))
    return stack


@functools.lru_cache(maxsize=None)
def zoo_pair(name, seed=0):
    """(port cfg, JAX cfg, numpy weights, points, logit weights, JAX logits,
    JAX gradients, JAX init's shapes) at smoke geometry; float64 weights and
    points for the ILL_CONDITIONED families."""
    cfg = recipes._point_zoo_smoke_cfg(name, NUM_CLASSES)
    jcfg = to_jax(cfg)
    assert jcfg == jrecipes._point_zoo_smoke_cfg(name, NUM_CLASSES)
    port, ref = MODELS.get(name), JMODELS.get(name)
    tree = perturb(convert.to_numpy(port.init(cfg, torch.Generator().manual_seed(seed), "cpu")),
                   seed + 1, scale=0.05)
    pts = cloud(seed + 2)
    wts = np.random.default_rng(seed + 3).standard_normal((2, NUM_CLASSES)).astype(np.float32)
    wide = name in ILL_CONDITIONED
    if wide:
        tree, pts, wts = _wide(tree), pts.astype(np.float64), wts.astype(np.float64)

    def loss(p):
        logits = ref.forward(p, jnp.asarray(pts), jcfg)
        return _loss_of(logits, jnp.asarray(wts)), logits

    with fixed_views(name, cfg, pts), jax.enable_x64(wide):  # the images in fp32
        (_, logits), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            jax.tree.map(jnp.asarray, tree))
        grads = jax.tree.map(np.asarray, grads)
    shapes = jax.eval_shape(lambda k: ref.init(jcfg, k), jax.random.PRNGKey(0))
    return cfg, jcfg, tree, pts, wts, np.asarray(logits), grads, shapes


def check_forward(name, seed=0):
    cfg, _, tree, pts, _, want, _, _ = zoo_pair(name, seed)
    with torch.no_grad(), fixed_views(name, cfg, pts):
        got = MODELS.get(name).forward(convert.from_numpy(tree, "cpu"), torch.tensor(pts), cfg)
    assert tuple(got.shape) == want.shape == (2, NUM_CLASSES)
    scale = max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=FWD_TOL, atol=FWD_TOL * scale)


def check_gradients(name, seed=0):
    """Each leaf of the gradient of a fixed loss of the logits within
    ZOO_GRAD_TOL of that leaf's largest JAX value (a leaf JAX leaves at
    zero but for rounding is near zero in the port too)."""
    cfg, _, tree, pts, wts, _, jgrads, _ = zoo_pair(name, seed)
    fwd = MODELS.get(name).forward

    def loss(p):
        return _loss_of(fwd(p, torch.tensor(pts), cfg), torch.tensor(wts)), {}

    with fixed_views(name, cfg, pts):
        _, _, grads = port_loss_and_grads(loss, tree)
    flat, jflat = leaves_with_path(grads), leaves_with_path(jgrads)
    assert [p for p, _ in flat] == [p for p, _ in jflat]
    largest = max(np.abs(g).max() for _, g in jflat)
    for (path, g), (_, w) in zip(flat, jflat):
        top = np.abs(w).max()
        if top < 1e-6 * largest:
            assert np.abs(g).max() < 1e-5 * largest, path
            continue
        np.testing.assert_allclose(g, w, rtol=0, atol=ZOO_GRAD_TOL * top, err_msg=str(path))


def check_tree(name):
    _, _, tree, _, _, _, _, shapes = zoo_pair(name)
    assert jax.tree.map(np.shape, tree) == jax.tree.map(lambda s: s.shape, shapes)


@pytest.mark.parametrize("name", FAMILIES)
def test_forward_matches_jax(name):
    check_forward(name)


@pytest.mark.parametrize("name", FAMILIES)
def test_gradients_match_jax(name):
    check_gradients(name)


@pytest.mark.parametrize("name", FAMILIES)
def test_init_tree_has_jax_keys_and_shapes(name):
    check_tree(name)


def test_pointnet_regulariser_matches_jax():
    cfg, jcfg, tree, pts, *_ = zoo_pair("PointNetEncoder")  # float64
    got = pb2.pointnet_feature_transform_regularizer(convert.from_numpy(tree, "cpu"),
                                                     torch.tensor(pts), cfg)
    with jax.enable_x64(True):
        want = jpb2.pointnet_feature_transform_regularizer(jax.tree.map(jnp.asarray, tree),
                                                           jnp.asarray(pts), jcfg)
    np.testing.assert_allclose(got.item(), float(want), rtol=FWD_TOL)
    assert got.item() > 0


# (the port's op, the reference's) on [4, 5, 6] inputs with exact ties and
# exact zeros: a max-pool over axis 1, ReLU, the zoo's leaky ReLU
POOLED_AND_GATED = {
    "pool_max": (lambda x: pb.pool_max(x, 1), lambda x: jnp.max(x, 1)),
    "relu": (pb._relu, jax.nn.relu),
    "leaky_relu": (pb._lrelu, lambda x: jax.nn.leaky_relu(x, 0.2)),
}


@pytest.mark.parametrize("op", sorted(POOLED_AND_GATED))
def test_pooled_and_gated_gradients_match_jax(op):
    """``pool_max`` splits a tie's gradient evenly and the gated
    activations take ``jax.nn``'s slope at 0 (ReLU 0, leaky ReLU 1), on
    values and gradients alike; ``max_winners`` and ``act_gate`` replayed
    from another input route the gradient where they say."""
    port_fn, jax_fn = POOLED_AND_GATED[op]
    x = np.random.default_rng(0).integers(-2, 3, (4, 5, 6)).astype(np.float32)
    w = np.random.default_rng(1).standard_normal(jax_fn(x).shape).astype(np.float32)
    want_y, vjp = jax.vjp(jax_fn, jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    got_y = port_fn(xt)
    got_y.backward(torch.tensor(w))
    np.testing.assert_array_equal(got_y.detach().numpy(), np.asarray(want_y))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(w))[0]))
    # the choice taken from another input: its gradient, this input's value
    other = x + np.random.default_rng(2).uniform(-0.5, 0.5, x.shape).astype(np.float32)
    owner, target = (pb, "max_winners") if op == "pool_max" else (gates, "act_gate")
    with mock.patch.object(owner, target, lambda t, *a, _f=getattr(owner, target): _f(
            torch.tensor(other), *a)):
        xt = torch.tensor(x, requires_grad=True)
        port_fn(xt).backward(torch.tensor(w))
    _, vjp_other = jax.vjp(jax_fn, jnp.asarray(other))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(vjp_other(jnp.asarray(w))[0]))


@pytest.mark.parametrize("name", FAMILIES)
def test_registered_with_the_reference_contract(name):
    entry = MODELS.get(name)
    assert {"init", "forward", "Config"} <= set(vars(entry))
    assert entry.Config.__name__ == JMODELS.get(name).Config.__name__


@pytest.mark.parametrize("name", ["PointNeXt", "PointViT", "BallDGCNN"])
def test_init_takes_the_card_or_raises(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = recipes._point_zoo_smoke_cfg(name, NUM_CLASSES)
    with pytest.raises(RuntimeError, match="CUDA"):
        MODELS.get(name).init(cfg, torch.Generator().manual_seed(0))
