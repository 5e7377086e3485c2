"""Point-cloud ops of the PyTorch port vs the JAX reference: furthest-point
sampling (index-exact), masked FPS, kNN, ball query, grouping, 3-NN
interpolation, chamfer and EMD losses.

Inputs come from seeded numpy and go through both packages. On the JAX side
FPS runs the Pallas kernel in interpret mode and its XLA twin; on the port's
side it runs the plain version, which is what a CPU tensor gets (the CUDA
kernel is held against that plain version on the card, in
``tests/test_torch_point_ops_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metatransformer_tpu.ops import point_interp as jpi
from metatransformer_tpu.ops import point_ops as jpo
from metatransformer_tpu_torch import ops
from metatransformer_tpu_torch.ops import point_interp as pi
from metatransformer_tpu_torch.ops import point_ops as po

torch.set_num_threads(1)

# Float results: both sides do the same fp32 arithmetic in another order of
# summation (aa + bb - 2ab cancels, so the error is absolute, ~1e-6 at |x| ~ 3).
TOL = 1e-5


def _cloud(seed, b, n, kind="normal"):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.uniform(-1, 1, (b, n, 3)).astype(np.float32)
    return rng.standard_normal((b, n, 3)).astype(np.float32)


# ----------------------------------------------------------------------- FPS


@pytest.mark.parametrize(
    "seed, b, n, g, kind",
    [(3, 2, 128, 16, "normal"), (4, 3, 200, 50, "uniform"), (5, 1, 64, 64, "normal"),
     (6, 4, 257, 33, "uniform")],
)
def test_fps_index_exact_vs_pallas_and_xla(seed, b, n, g, kind):
    pts = _cloud(seed, b, n, kind)
    got = po.furthest_point_sample(torch.tensor(pts), g)
    assert got.dtype == torch.int64 and got.shape == (b, g) and not got.requires_grad
    pallas = np.asarray(jpo._fps_pallas(jnp.asarray(pts), g, interpret=True))
    xla = np.asarray(jpo._fps_xla(jnp.asarray(pts), g))
    np.testing.assert_array_equal(got.numpy(), pallas)
    np.testing.assert_array_equal(got.numpy(), xla)
    assert (got[:, 0] == 0).all()


def test_fps_duplicated_points_and_more_samples_than_distinct_points():
    """Ties on purpose: every point appears four times and G exceeds the
    number of distinct points, so late rounds pick among all-zero minima.
    The first index among equal maxima wins, in both packages."""
    base = _cloud(7, 2, 8)
    pts = np.concatenate([base, base, base, base], axis=1)  # 32 points, 8 distinct
    got = po.furthest_point_sample(torch.tensor(pts), 12).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jpo._fps_pallas(jnp.asarray(pts), 12, interpret=True)))
    np.testing.assert_array_equal(got, np.asarray(jpo._fps_xla(jnp.asarray(pts), 12)))
    assert (got[:, :8] < 8).all()  # the first copy of each distinct point
    assert (got[:, 8:] == 0).all()  # then every minimum is 0: index 0


def test_fps_takes_strided_and_low_precision_input():
    pts = _cloud(8, 2, 96)
    want = po.furthest_point_sample(torch.tensor(pts), 20)
    wide = torch.zeros(2, 96, 7)
    wide[..., 2:5] = torch.tensor(pts)
    assert torch.equal(po.furthest_point_sample(wide[..., 2:5], 20), want)
    assert torch.equal(po.furthest_point_sample(torch.tensor(pts).double(), 20), want)
    half = torch.tensor(pts).bfloat16()  # computed in fp32 from the rounded coordinates
    assert torch.equal(po.furthest_point_sample(half, 20),
                       po.furthest_point_sample(half.float(), 20))
    leaf = torch.tensor(pts, requires_grad=True)
    assert not po.furthest_point_sample(leaf, 20).requires_grad


def test_fps_rejects_bad_input():
    with pytest.raises(ValueError):
        po.furthest_point_sample(torch.zeros(2, 16, 2), 4)
    with pytest.raises(TypeError):
        po.furthest_point_sample(torch.zeros(2, 16, 3, dtype=torch.int32), 4)
    with pytest.raises(ValueError):  # the kernel wrapper never takes a CPU tensor
        po.fps_cuda(torch.zeros(2, 16, 3), 4)


def test_fps_on_cpu_counts_no_launch():
    ops.reset_launch_counts()
    po.furthest_point_sample(torch.tensor(_cloud(9, 1, 32)), 8)
    assert ops.launch_counts()["fps"] == 0
    assert set(ops.launch_counts()) >= {"fps", "attn_sublayer", "flash_fwd"}


def test_masked_fps_matches_jax_and_stays_on_valid_points():
    pts = _cloud(10, 3, 64)
    mask = np.zeros((3, 64), bool)
    mask[0, :40] = True  # ragged
    mask[1, 5:23] = True  # first valid point is not point 0
    mask[2, ::3] = True  # scattered
    got = po.masked_fps(torch.tensor(pts), torch.tensor(mask), 10).numpy()
    want = np.asarray(jpo.masked_fps(jnp.asarray(pts), jnp.asarray(mask), 10))
    np.testing.assert_array_equal(got, want)
    # slot 0 is index 0 whatever the mask; it carries the first valid point's
    # coordinates, so every sample lies on a valid point
    safe = np.where(mask[..., None], pts, pts[np.arange(3), mask.argmax(-1)][:, None])
    for b in range(3):
        for i in got[b]:
            assert mask[b, i] or np.array_equal(safe[b, i], safe[b, mask[b].argmax()])


def test_random_sample_is_a_seeded_subset_without_repeats():
    pts = torch.tensor(_cloud(11, 4, 50))
    a = po.random_sample(torch.Generator().manual_seed(3), pts, 20)
    b = po.random_sample(torch.Generator().manual_seed(3), pts, 20)
    assert torch.equal(a, b) and a.shape == (4, 20) and a.dtype == torch.int64
    for row in a:
        assert len(set(row.tolist())) == 20 and 0 <= int(row.min()) and int(row.max()) < 50
    assert not torch.equal(a[0], a[1])


# ------------------------------------------------------------ neighbourhoods


def test_square_dists_matches_jax():
    a, b = _cloud(12, 2, 24), _cloud(13, 2, 40)
    got = po.square_dists(torch.tensor(a), torch.tensor(b)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jpo.square_dists(jnp.asarray(a), jnp.asarray(b))), atol=TOL)
    assert (got >= 0).all()


def test_knn_matches_jax():
    """Sorted distances agree within TOL. top-k need not order near-equal
    values alike, so indices are compared only in rows whose k+1 nearest
    distances are pairwise further apart than 1e-4."""
    pts = _cloud(14, 2, 128)
    centers, k = pts[:, :16], 8
    d, idx = po.knn(torch.tensor(centers), torch.tensor(pts), k)
    jd, jidx = jpo.knn(jnp.asarray(centers), jnp.asarray(pts), k)
    assert idx.dtype == torch.int64 and idx.shape == (2, 16, k)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=TOL)
    assert (d[..., 1:] >= d[..., :-1]).all()  # nearest first
    assert (idx[..., 0] == torch.arange(16)).all()  # a center's nearest point is itself
    full = np.sort(np.asarray(jpo.square_dists(jnp.asarray(centers), jnp.asarray(pts))), -1)
    clear = (np.diff(full[..., : k + 1], axis=-1) > 1e-4).all(-1)
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(idx.numpy()[clear], np.asarray(jidx)[clear])


@pytest.mark.parametrize("radius", [0.05, 0.6, 10.0], ids=["no-hit", "some", "all"])
def test_ball_query_matches_jax(radius):
    """First k in-radius indices in ascending order, empty slots repeat the
    first hit, no hit at all gives index 0: exact integers. Centers are off
    the cloud so the smallest radius leaves rows with no hit."""
    pts = _cloud(15, 2, 96, "uniform")
    centers = _cloud(16, 2, 12, "uniform")
    got = po.ball_query(torch.tensor(centers), torch.tensor(pts), radius, 6)
    want = np.asarray(jpo.ball_query(jnp.asarray(centers), jnp.asarray(pts), radius, 6))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int64
    if radius == 0.05:
        assert (got == 0).all(dim=-1).any()


@pytest.mark.parametrize("relative, normalize", [(True, False), (False, False), (True, True)])
def test_group_points_matches_jax(relative, normalize):
    pts, feats = _cloud(17, 2, 64), _cloud(18, 2, 64)
    centers = pts[:, :8]
    idx = np.random.default_rng(19).integers(0, 64, (2, 8, 5))
    dp, fj = po.group_points(torch.tensor(centers), torch.tensor(pts), torch.tensor(idx),
                             torch.tensor(feats), relative, normalize)
    jdp, jfj = jpo.group_points(jnp.asarray(centers), jnp.asarray(pts), jnp.asarray(idx),
                                jnp.asarray(feats), relative, normalize)
    np.testing.assert_allclose(dp.numpy(), np.asarray(jdp), atol=1e-6)
    np.testing.assert_array_equal(fj.numpy(), np.asarray(jfj))
    assert po.group_points(torch.tensor(centers), torch.tensor(pts), torch.tensor(idx))[1] is None


def test_gather_points_carries_a_gradient_to_the_points():
    pts = torch.tensor(_cloud(20, 2, 16), requires_grad=True)
    idx = torch.tensor([[0, 3, 3], [5, 5, 5]])
    po.gather_points(pts, idx).sum().backward()
    assert pts.grad[0, 3].tolist() == [2.0] * 3 and pts.grad[1, 5].tolist() == [3.0] * 3
    assert pts.grad.sum().item() == 18.0


# ------------------------------------------------- interpolation and losses


@pytest.mark.parametrize("m", [1, 2, 3, 20])
def test_three_nn_and_interpolate_match_jax(m):
    """With fewer than 3 known points the nearest is repeated."""
    unknown, known, feats = _cloud(21, 2, 40), _cloud(22, 2, m), _cloud(23, 2, m)
    d2, idx = pi.three_nn(torch.tensor(unknown), torch.tensor(known))
    jd2, jidx = jpi.three_nn(jnp.asarray(unknown), jnp.asarray(known))
    assert d2.shape == idx.shape == (2, 40, 3)
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd2), atol=TOL)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))  # random points: no near-ties
    got = pi.three_interpolate(torch.tensor(feats), idx, d2)
    want = jpi.three_interpolate(jnp.asarray(feats), jidx, jd2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    both = pi.three_interpolation(torch.tensor(unknown), torch.tensor(known), torch.tensor(feats))
    np.testing.assert_allclose(both.numpy(), np.asarray(want), atol=TOL)


def test_three_interpolate_weights_floor_and_promote():
    """A point that coincides with a known point gets weight 1 / 1e-8 on
    it; fp32 weights promote bf16 features to an fp32 result."""
    known = torch.tensor(_cloud(24, 1, 5))
    feats = torch.tensor(_cloud(25, 1, 5))
    out = pi.three_interpolation(known, known, feats)
    torch.testing.assert_close(out, feats, atol=1e-5, rtol=0)
    assert pi.three_interpolation(known, known, feats.bfloat16()).dtype == torch.float32


def test_chamfer_and_emd_losses_match_jax():
    a, b = _cloud(26, 3, 48), _cloud(27, 3, 64)
    ta, tb, ja, jb = torch.tensor(a), torch.tensor(b), jnp.asarray(a), jnp.asarray(b)
    for got, want in zip(pi.chamfer_distance(ta, tb), jpi.chamfer_distance(ja, jb)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    np.testing.assert_allclose(
        pi.chamfer_loss(ta, tb).item(), float(jpi.chamfer_loss(ja, jb)), atol=TOL)
    np.testing.assert_allclose(
        pi.chamfer_l1_loss(ta, tb).item(), float(jpi.chamfer_l1_loss(ja, jb)), atol=TOL)
    c = _cloud(28, 3, 48)
    np.testing.assert_allclose(
        pi.emd_loss(ta, torch.tensor(c)).item(), float(jpi.emd_loss(ja, jnp.asarray(c))),
        atol=TOL)
    np.testing.assert_allclose(
        pi.emd_loss(ta, torch.tensor(c), eps=0.05, iters=10).item(),
        float(jpi.emd_loss(ja, jnp.asarray(c), eps=0.05, iters=10)), atol=TOL)


def test_chamfer_l1_gradient_matches_jax():
    import jax

    a, b = _cloud(29, 2, 16), _cloud(30, 2, 16)
    ta = torch.tensor(a, requires_grad=True)
    pi.chamfer_l1_loss(ta, torch.tensor(b)).backward()
    want = jax.grad(lambda x: jpi.chamfer_l1_loss(x, jnp.asarray(b)))(jnp.asarray(a))
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(want), atol=TOL)
