"""The port's sparse 3D convolution and voxelisation (ops/sparse_conv.py,
ops/voxelize.py) against the JAX package on the CPU, FP32.

The index outputs are held exactly: voxel coordinates and valid masks
(with a batch that overflows ``max_voxels``), the strided conv's dedup
mask (with duplicate strided outputs), the rulebook lookups. The convs'
features and their gradients at 1e-4 (``tests/test_sparse_conv.py``), the
mean VFE at 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metatransformer_tpu.ops import sparse_conv as jsp
from metatransformer_tpu.ops import voxelize as jvox
from metatransformer_tpu_torch.ops import sparse_conv as sp
from metatransformer_tpu_torch.ops import voxelize

torch.set_num_threads(1)
TOL = 1e-4
VFE_TOL = 1e-6


def random_sparse(seed, n_active=40, cap=64, shape=(6, 8, 10), b=2, c=5):
    """A random active voxel set with unique coordinates, in both packages:
    (JAX SparseTensor, port SparseTensor)."""
    rng = np.random.default_rng(seed)
    d, h, w = shape
    flat = rng.choice(b * d * h * w, size=n_active, replace=False)
    coords = np.zeros((cap, 4), np.int32)
    coords[:n_active] = np.stack([flat // (d * h * w), (flat // (h * w)) % d,
                                  (flat // w) % h, flat % w], -1)
    valid = np.zeros(cap, bool)
    valid[:n_active] = True
    feats = (rng.standard_normal((cap, c)) * valid[:, None]).astype(np.float32)
    jst = jsp.SparseTensor(jnp.asarray(feats), jnp.asarray(coords), jnp.asarray(valid),
                           shape, b)
    st = sp.SparseTensor(torch.tensor(feats), torch.tensor(coords).long(), torch.tensor(valid),
                         shape, b)
    return jst, st


def weight(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def same_tensor(st, jst, tol=TOL):
    np.testing.assert_array_equal(st.valid.numpy(), np.asarray(jst.valid))
    keep = st.valid.numpy()
    np.testing.assert_array_equal(st.coords.numpy()[keep], np.asarray(jst.coords)[keep])
    np.testing.assert_allclose(st.features.detach().numpy(), np.asarray(jst.features),
                               atol=tol, rtol=tol)
    assert st.spatial_shape == tuple(jst.spatial_shape) and st.batch_size == jst.batch_size


def test_lookup_equals_jax():
    jst, st = random_sparse(0)
    keys, order = sp.build_lookup(st)
    jkeys, jorder = jsp.build_lookup(jst)
    valid = np.asarray(jkeys) != np.asarray(jsp.SENTINEL)
    np.testing.assert_array_equal(keys.numpy()[valid], np.asarray(jkeys)[valid])
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    assert (keys.numpy()[~valid] == sp.SENTINEL).all()
    rng = np.random.default_rng(1)
    q = np.concatenate([np.asarray(jkeys)[valid][:10], rng.integers(0, 960, 20)]).astype(np.int32)
    src, found = sp.lookup(keys, order, torch.tensor(q).long())
    jsrc, jfound = jsp.lookup(jkeys, jorder, jnp.asarray(q))
    np.testing.assert_array_equal(found.numpy(), np.asarray(jfound))
    np.testing.assert_array_equal(src.numpy()[found.numpy()], np.asarray(jsrc)[found.numpy()])


def test_subm_conv_matches_jax_and_the_dense_oracle():
    jst, st = random_sparse(0)
    w = weight(1, (3, 3, 3, 5, 7))
    out = sp.subm_conv3d(st, torch.tensor(w))
    same_tensor(out, jsp.subm_conv3d(jst, jnp.asarray(w)))
    dense = sp.dense_conv3d_oracle(st, torch.tensor(w))
    c = st.coords
    want = dense[c[:, 0], c[:, 1], c[:, 2], c[:, 3]]
    keep = st.valid
    torch.testing.assert_close(out.features[keep], want[keep], atol=TOL, rtol=TOL)
    np.testing.assert_allclose(dense.numpy(), np.asarray(jsp.dense_conv3d_oracle(
        jst, jnp.asarray(w))), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("stride, padding, k, shape", [
    ((2, 2, 2), (1, 1, 1), (3, 3, 3), (6, 8, 8)),
    ((2, 2, 2), (0, 1, 1), (3, 3, 3), (5, 8, 8)),
    ((2, 1, 1), (0, 0, 0), (3, 1, 1), (5, 4, 4)),
])
def test_strided_conv_equals_jax_with_duplicate_outputs(stride, padding, k, shape):
    """A dense active set, so many inputs fall on one output: the first
    occurrence wins (a stable sort) and the rest are masked invalid."""
    jst, st = random_sparse(2, n_active=120, cap=140, shape=shape)
    w = weight(3, (*k, 5, 4))
    out = sp.sparse_conv3d(st, torch.tensor(w), stride, padding)
    jout = jsp.sparse_conv3d(jst, jnp.asarray(w), stride, padding)
    same_tensor(out, jout)
    assert out.valid.sum() < st.valid.sum()  # duplicates were dropped
    # the output set is the downsampled input positions only: spconv's
    # kernel-reachable positions with an empty centre are not emitted
    kern, strd, padd = np.array(k), np.array(stride), np.array(padding)
    c = st.coords[st.valid].numpy()
    down = np.concatenate([c[:, :1], (c[:, 1:] + padd - kern // 2) // strd], 1)
    inside = ((down[:, 1:] >= 0) & (down[:, 1:] < np.array(out.spatial_shape))).all(1)
    assert ({tuple(r) for r in down[inside]}
            == {tuple(r) for r in out.coords[out.valid].numpy()})
    keep = out.valid.numpy()
    co = out.coords.numpy()[keep]
    dense = sp.dense_conv3d_oracle(st, torch.tensor(w), stride, padding)
    np.testing.assert_allclose(out.features.numpy()[keep],
                               dense.numpy()[co[:, 0], co[:, 1], co[:, 2], co[:, 3]],
                               atol=TOL, rtol=TOL)


def test_inverse_conv_equals_jax():
    jst, st = random_sparse(4, n_active=60, cap=80, shape=(6, 8, 8))
    wd, wu = weight(5, (3, 3, 3, 5, 6)), weight(6, (3, 3, 3, 6, 3))
    coarse = sp.sparse_conv3d(st, torch.tensor(wd), (2, 2, 2), (1, 1, 1))
    jcoarse = jsp.sparse_conv3d(jst, jnp.asarray(wd), (2, 2, 2), (1, 1, 1))
    out = sp.inverse_sparse_conv3d(coarse, st, torch.tensor(wu), (2, 2, 2), (1, 1, 1))
    same_tensor(out, jsp.inverse_sparse_conv3d(jcoarse, jst, jnp.asarray(wu), (2, 2, 2),
                                               (1, 1, 1)))


def test_batch_norm_relu_and_to_dense_equal_jax():
    jst, st = random_sparse(6)
    scale, bias = weight(7, (5,)), weight(8, (5,))
    out = sp.batch_norm_relu(st, torch.tensor(scale), torch.tensor(bias))
    jout = jsp.batch_norm_relu(jst, jnp.asarray(scale), jnp.asarray(bias))
    same_tensor(out, jout, 1e-5)
    assert (out.features[~st.valid] == 0).all()
    np.testing.assert_allclose(sp.to_dense(out).numpy(), np.asarray(jsp.to_dense(jout)),
                               atol=1e-5)


def test_conv_gradients_equal_jax():
    """d/d(weights, features) of subm -> BN/ReLU -> strided conv."""
    jst, st = random_sparse(9)
    w1, w2 = weight(10, (3, 3, 3, 5, 4)), weight(11, (3, 3, 3, 4, 4)) * 0.3
    ones, zeros = np.ones(4, np.float32), np.zeros(4, np.float32)

    def jloss(w1, w2, f):
        o = jsp.subm_conv3d(dataclasses.replace(jst, features=f), w1)
        o = jsp.batch_norm_relu(o, jnp.asarray(ones), jnp.asarray(zeros))
        return jnp.sum(jsp.sparse_conv3d(o, w2, (2, 2, 2), (1, 1, 1)).features ** 2)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(w1), jnp.asarray(w2), jst.features)
    leaves = [torch.tensor(w1).requires_grad_(True), torch.tensor(w2).requires_grad_(True),
              st.features.clone().requires_grad_(True)]
    o = sp.subm_conv3d(dataclasses.replace(st, features=leaves[2]), leaves[0])
    o = sp.batch_norm_relu(o, torch.tensor(ones), torch.tensor(zeros))
    (sp.sparse_conv3d(o, leaves[1], (2, 2, 2), (1, 1, 1)).features ** 2).sum().backward()
    for got, w in zip(leaves, want):
        w = np.asarray(w)
        np.testing.assert_allclose(got.grad.numpy(), w, atol=TOL * np.abs(w).max(), rtol=0)


# --------------------------------------------------------------------------
# voxelisation
# --------------------------------------------------------------------------


def test_voxelize_points_mean_vfe():
    """tests/test_sparse_conv.py's four points: two share a voxel, one is
    out of range."""
    pts = np.asarray([[[0.05, 0.05, 0.05, 1.0], [0.08, 0.02, 0.01, 3.0],
                       [0.35, 0.05, 0.05, 5.0], [9.0, 9.0, 9.0, 7.0]]], np.float32)
    args = ((0.1, 0.1, 0.1), (0, 0, 0, 1, 1, 1), (10, 10, 10), 8)
    st = sp.voxelize_points(torch.tensor(pts), torch.ones(1, 4, dtype=torch.bool), *args)
    same_tensor(st, jsp.voxelize_points(jnp.asarray(pts), jnp.ones((1, 4), bool), *args), VFE_TOL)
    assert st.valid.sum() == 2
    feats, coords = st.features[st.valid].numpy(), st.coords[st.valid].numpy()
    np.testing.assert_allclose(feats[coords[:, 3] == 0][0], [0.065, 0.035, 0.03, 2.0],
                               atol=VFE_TOL)


@pytest.mark.parametrize("max_voxels", [512, 96])
def test_voxelize_points_equals_jax(max_voxels):
    """KITTI-like clouds with padding; at 96 the batch overflows the cap,
    which keeps the smallest keys of the whole batch: sample 0 first."""
    rng = np.random.default_rng(12)
    pts = np.concatenate([rng.uniform([0, -3.2, -3], [6.4, 3.2, 2], (2, 200, 3)),
                          rng.uniform(0, 1, (2, 200, 1))], -1).astype(np.float32)
    pts[:, :20] = pts[:, 20:40] + 0.01  # shared voxels
    pts[1, 150:, :3] = 50.0  # out of range
    mask = np.ones((2, 200), bool)
    mask[0, 180:] = False
    args = ((0.1, 0.1, 0.2), (0.0, -3.2, -3.0, 6.4, 3.2, 2.0), (25, 64, 64), max_voxels)
    st = sp.voxelize_points(torch.tensor(pts), torch.tensor(mask), *args)
    jst = jsp.voxelize_points(jnp.asarray(pts), jnp.asarray(mask), *args)
    same_tensor(st, jst, VFE_TOL)
    per_sample = np.bincount(st.coords[st.valid][:, 0].numpy(), minlength=2)
    if max_voxels == 96:
        assert st.valid.all() and per_sample[0] > per_sample[1]
    else:
        assert 0 < st.valid.sum() < max_voxels


def test_voxel_ids_and_mean_vfe_equal_jax():
    rng = np.random.default_rng(13)
    cfg = voxelize.VoxelConfig(pc_range=(0.0, -3.2, -3.0, 6.4, 3.2, 2.0),
                               voxel_size=(0.8, 0.8, 1.0))
    jcfg = jvox.VoxelConfig(pc_range=cfg.pc_range, voxel_size=cfg.voxel_size)
    pts = rng.uniform([-1, -4, -3.5, 0], [7, 4, 2.5, 1], (2, 100, 4)).astype(np.float32)
    mask = rng.uniform(0, 1, (2, 100)) > 0.1
    ids, valid = voxelize.voxel_ids(torch.tensor(pts), cfg)
    jids, jvalid = jvox.voxel_ids(jnp.asarray(pts), jcfg)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_allclose(
        voxelize.scatter_mean_vfe(torch.tensor(pts), cfg, torch.tensor(mask)).numpy(),
        np.asarray(jvox.scatter_mean_vfe(jnp.asarray(pts), jcfg, jnp.asarray(mask))),
        atol=VFE_TOL)
