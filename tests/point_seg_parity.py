"""Shared parity checks of the port's point-segmentation backbones
(models/{randlanet,baafnet,point_transformer_seg,stratified_transformer}.py)
against the JAX package on the CPU, at the recipes' smoke geometry (64
points a cloud, batch 2), with the reference's init, perturbed, carried
across.

The logits at FWD_TOL of the largest, each gradient leaf of a fixed loss of
the logits within GRAD_TOL of that leaf's largest reference value (the
zoo's bound: train-mode BatchNorm over few samples), every FPS index equal
to the reference's, and the init's keys and shapes. A family whose
reference fp32 stands further from float64 than the port's runs in float64
on both sides; the reference's FPS does not run under x64, so there it
takes the indices the port's FPS (its plain version, computed in fp32)
drew, which are first held equal to the reference's own.
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import torch

from metatransformer_tpu.ops import point_ops as jpo
from metatransformer_tpu_torch.core import convert
from metatransformer_tpu_torch.core.tree import leaves_with_path
from metatransformer_tpu_torch.ops import point_ops as po
from tests.test_torch_detector3d import port_loss_and_grads
from tests.test_torch_vit_adapter import perturb

FWD_TOL = 1e-5
GRAD_TOL = 1e-3
NUM_CLASSES = 5
N_POINTS = 64


def wide(tree):
    return jax.tree.map(lambda a: a.astype(np.float64) if a.dtype == np.float32 else a, tree)


def cloud(seed, b=2, n=N_POINTS, c=3):
    return (np.random.default_rng(seed).standard_normal((b, n, c)) * 0.5).astype(np.float32)


def _loss_of(logits, weights):
    return (logits * weights).sum() + 0.1 * (logits**2).sum()


def recorded_fps(forward):
    """(the port's FPS calls [(points, n, indices)] in order, the result)
    of ``forward()``."""
    calls, fps = [], po.furthest_point_sample

    def record(points, n):
        idx = fps(points, n)
        calls.append((points.detach().float().numpy(), n, idx.numpy()))
        return idx

    with mock.patch.object(po, "furthest_point_sample", record):
        out = forward()
    return calls, out


def replayed_fps(calls):
    """A context in which the reference's FPS answers with ``calls``'
    indices, in order."""
    it = iter([idx for _, _, idx in calls])
    return mock.patch.object(jpo, "furthest_point_sample",
                             lambda points, n: jnp.asarray(next(it)))


@functools.lru_cache(maxsize=None)
def seg_pair(jmod, mod, cfg, jcfg, seed=0, in64=False, features=0, perm=None):
    """The reference's and the port's runs of one family on the same
    perturbed reference weights and cloud: a dict of the numpy tree, the
    inputs, the reference's logits, gradients and init shapes, and the
    port's FPS calls. ``features`` > 0 passes that many feature channels;
    ``perm`` a permutation (RandLA-Net) to both; ``in64`` runs both in
    float64."""
    tree = perturb(jax.tree.map(np.asarray, jmod.init(jcfg, jax.random.PRNGKey(seed))),
                   seed + 1, scale=0.05)
    pts = cloud(seed + 2)
    feats = cloud(seed + 4, c=features) if features else None
    wts = np.random.default_rng(seed + 3).standard_normal(
        (2, N_POINTS, NUM_CLASSES)).astype(np.float32)
    port_kw = {} if perm is None else {"perm": torch.tensor(np.asarray(perm))}
    # the port's FPS in fp32, whose indices the reference must draw too
    calls, _ = recorded_fps(lambda: mod.forward(
        convert.from_numpy(tree, "cpu"), torch.tensor(pts), cfg,
        features=None if feats is None else torch.tensor(feats), **port_kw))
    for points, n, idx in calls:
        np.testing.assert_array_equal(idx, np.asarray(jpo.furthest_point_sample(
            jnp.asarray(points), n)))
    if in64:
        tree, pts, wts = wide(tree), pts.astype(np.float64), wts.astype(np.float64)
        feats = None if feats is None else feats.astype(np.float64)

    def loss(p, x, f):
        logits = jmod.forward(p, x, jcfg, features=f)
        return _loss_of(logits, jnp.asarray(wts)), logits

    with jax.enable_x64(in64), replayed_fps(calls):
        (_, logits), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            jax.tree.map(jnp.asarray, tree), jnp.asarray(pts),
            None if feats is None else jnp.asarray(feats))
        logits, grads = np.asarray(logits), jax.tree.map(np.asarray, grads)
    shapes = jax.eval_shape(lambda k: jmod.init(jcfg, k), jax.random.PRNGKey(0))
    return {"tree": tree, "pts": pts, "feats": feats, "wts": wts, "logits": logits,
            "grads": grads, "shapes": shapes, "calls": calls, "port_kw": port_kw}


def port_forward(mod, cfg, run, params=None):
    f = run["feats"]
    return mod.forward(convert.from_numpy(run["tree"], "cpu") if params is None else params,
                       torch.tensor(run["pts"]), cfg,
                       features=None if f is None else torch.tensor(f), **run["port_kw"])


def check_forward(mod, cfg, run):
    with torch.no_grad():
        got = port_forward(mod, cfg, run)
    want = run["logits"]
    assert tuple(got.shape) == want.shape == (2, N_POINTS, NUM_CLASSES)
    assert got.dtype == (torch.float64 if want.dtype == np.float64 else torch.float32)
    scale = max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=FWD_TOL, atol=FWD_TOL * scale)


def check_gradients(mod, cfg, run):
    """Each leaf within GRAD_TOL of that leaf's largest reference value (a
    leaf the reference leaves at zero but for rounding, below 1e-6 of the
    tree's largest, is near zero in the port too)."""
    def loss(p):
        return _loss_of(port_forward(mod, cfg, run, p), torch.tensor(run["wts"])), {}

    _, _, grads = port_loss_and_grads(loss, run["tree"])
    flat, jflat = leaves_with_path(grads), leaves_with_path(run["grads"])
    assert [p for p, _ in flat] == [p for p, _ in jflat]
    largest = max(np.abs(g).max() for _, g in jflat)
    for (path, g), (_, w) in zip(flat, jflat):
        top = np.abs(w).max()
        if top < 1e-6 * largest:
            assert np.abs(g).max() < 1e-5 * largest, path
            continue
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_TOL * top, err_msg=str(path))


def check_tree(mod, cfg, run):
    """The port's own init has the reference's keys and shapes."""
    tree = convert.to_numpy(mod.init(cfg, torch.Generator().manual_seed(0), "cpu"))
    assert jax.tree.map(np.shape, tree) == jax.tree.map(lambda s: s.shape, run["shapes"])
