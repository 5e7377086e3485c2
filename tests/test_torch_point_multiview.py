"""The multi-view point classifier and the C++ host runtime of the PyTorch
port vs the JAX reference.

Weights travel JAX -> numpy -> ``convert.from_numpy``; clouds come from
seeded numpy. The host runtime (grid subsampling, kNN) is C++ in both
packages; the port's copy is built by g++ at first use and held against the
reference's bindings and against its own numpy versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metatransformer_tpu.core import encoder as jenc
from metatransformer_tpu.models import point_multiview as jmv
from metatransformer_tpu.runtime import native as jnative
from metatransformer_tpu_torch.core import convert, encoder as enc
from metatransformer_tpu_torch.models import point_multiview as mv
from metatransformer_tpu_torch.runtime import native

torch.set_num_threads(1)

PROJ = dict(local_size=4, trans_dim=8, graph_dim=8, obj_size=24, img_size=32)


def _cfgs(num_views=2):
    kw = dict(num_views=num_views, patch_size=16, num_classes=7)
    return (
        jmv.MultiViewConfig(proj=jmv.ProjEncConfig(**PROJ),
                            encoder=jenc.EncoderConfig(dim=64, depth=2, num_heads=1), **kw),
        mv.MultiViewConfig(proj=mv.ProjEncConfig(**PROJ),
                           encoder=enc.EncoderConfig(dim=64, depth=2, num_heads=1), **kw),
    )


def _cloud(seed, b, n=64):
    return np.random.default_rng(seed).standard_normal((b, n, 3)).astype(np.float32)


# ---------------------------------------------------------------- multi-view


def test_views_and_rotations_match_jax():
    np.testing.assert_array_equal(mv.VIEWS, jmv.VIEWS)
    got = mv.euler2mat(torch.tensor(mv.VIEWS[:, 0])).numpy()
    np.testing.assert_allclose(got, np.asarray(jmv.euler2mat(jnp.asarray(jmv.VIEWS[:, 0]))),
                               atol=1e-6)
    for r in got:
        np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-5)


@pytest.mark.parametrize("num_views", [1, 4, 10])
def test_point_transform_matches_jax(num_views):
    pts = _cloud(0, 2, 32)
    got = mv.point_transform(torch.tensor(pts), num_views)
    want = jmv.point_transform(jnp.asarray(pts), num_views)
    assert got.shape == (2 * num_views, 32, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_proj_enc_matches_jax():
    """The rendered images, fp32 on both sides (1e-4: sums over the splat
    and three convolutions in another order)."""
    jcfg, cfg = _cfgs()
    np_params = jax.tree.map(np.asarray, jmv.init(jcfg, jax.random.PRNGKey(0)))
    pts = _cloud(1, 2)
    jpc = jmv.point_transform(jnp.asarray(pts), 2)
    want = jmv.proj_enc(jax.tree.map(jnp.asarray, np_params),
                        jnp.repeat(jnp.asarray(pts), 2, 0), jpc, jcfg.proj)
    tpts = torch.tensor(pts)
    with torch.no_grad():
        got = mv.proj_enc(convert.from_numpy(np_params, "cpu"), tpts.repeat_interleave(2, 0),
                          mv.point_transform(tpts, 2), cfg.proj)
    assert got.shape == (4, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert (got[0] - got[1]).abs().max() > 1e-3  # two views render differently


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_multiview_forward_matches_jax(precision):
    jcfg, cfg = _cfgs()
    np_params = jax.tree.map(np.asarray, jmv.init(jcfg, jax.random.PRNGKey(2)))
    pts = _cloud(3, 2)
    jprec, prec = (jenc.FP32, enc.FP32) if precision == "fp32" else (jenc.BF16, enc.BF16)
    want = jmv.forward(jax.tree.map(jnp.asarray, np_params), jnp.asarray(pts), jcfg, jprec)
    with torch.no_grad():
        got = mv.forward(convert.from_numpy(np_params, "cpu"), torch.tensor(pts), cfg, prec)
    assert got.shape == (2, 7)
    if precision == "fp32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    else:  # the drift bound of the reference's fused-vs-XLA bf16 encoder test
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   atol=0.15, rtol=0.1)


def test_multiview_init_and_gradients_reach_the_renderer():
    _, cfg = _cfgs()
    params = mv.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    jparams = jmv.init(_cfgs()[0], jax.random.PRNGKey(0))
    shapes = lambda t: jax.tree.map(lambda a: tuple(a.shape), t)
    assert shapes(params) == shapes(jax.tree.map(np.asarray, jparams))
    for leaf in (params["input_trans"]["w"], params["img_layer"]["w"], params["graph"]["w"]):
        leaf.requires_grad_(True)
    mv.forward(params, torch.tensor(_cloud(4, 2)), cfg).square().sum().backward()
    assert params["input_trans"]["w"].grad.abs().max() > 0
    assert params["img_layer"]["w"].grad.abs().max() > 0
    with pytest.raises(RuntimeError, match="CUDA card"):
        mv.init(cfg, torch.Generator().manual_seed(0))  # no device named: the card


# -------------------------------------------------------------- host runtime


def test_native_library_builds_into_the_build_directory():
    lib_path = native.build()
    assert lib_path.exists() and lib_path.parent.name == "_build"
    assert lib_path == native.library_path() and native.library() is native.library()


@pytest.mark.parametrize("with_features", [False, True])
def test_grid_subsample_matches_jax_package_and_plain(with_features):
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (500, 3)).astype(np.float32)
    feats = rng.standard_normal((500, 4)).astype(np.float32) if with_features else None
    got_p, got_f = native.grid_subsample(pts, feats, dl=0.25)
    want_p, want_f = jnative.grid_subsample(pts, feats, dl=0.25)
    np.testing.assert_array_equal(got_p, want_p)  # the same C++ source
    plain_p, plain_f = native.grid_subsample_plain(pts, feats, dl=0.25)
    np.testing.assert_allclose(got_p, plain_p, atol=1e-6)  # same voxels, same order
    if with_features:
        np.testing.assert_array_equal(got_f, want_f)
        np.testing.assert_allclose(got_f, plain_f, atol=1e-5)
    else:
        assert got_f is None and plain_f is None
    assert len(got_p) < 500


def test_grid_subsample_merges_voxels():
    pts = np.array([[0.01, 0.01, 0.01], [0.02, 0.02, 0.02], [0.9, 0.9, 0.9]], np.float32)
    feats = np.array([[1.0], [3.0], [10.0]], np.float32)
    for fn in (native.grid_subsample, native.grid_subsample_plain):
        out_p, out_f = fn(pts, feats, dl=0.1)
        assert out_p.shape == (2, 3)
        np.testing.assert_allclose(out_p[0], [0.015, 0.015, 0.015], atol=1e-6)
        np.testing.assert_allclose(out_f[:, 0], [2.0, 10.0], atol=1e-6)


@pytest.mark.parametrize("n", [100, 2000])  # brute force, and the grid index
def test_knn_search_matches_jax_package_and_plain(n):
    rng = np.random.default_rng(1)
    support = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    queries = rng.uniform(-1, 1, (50, 3)).astype(np.float32)
    idx, d2 = native.knn_search(support, queries, 8)
    jidx, jd2 = jnative.knn_search(support, queries, 8)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(d2, jd2)
    pidx, pd2 = native.knn_search_plain(support, queries, 8)
    np.testing.assert_allclose(np.sort(d2, axis=1), pd2, rtol=1e-3, atol=1e-4)
    assert (np.sort(idx, axis=1) == np.sort(pidx, axis=1)).mean() > 0.99  # near-ties aside


def test_native_wrappers_validate_before_they_pass_pointers():
    pts = np.zeros((4, 3), np.float32)
    with pytest.raises(ValueError):
        native.grid_subsample(np.zeros((4, 2), np.float32))
    with pytest.raises(ValueError):
        native.grid_subsample(pts, np.zeros((3, 1), np.float32))
    with pytest.raises(ValueError):
        native.grid_subsample(pts, dl=0.0)
    with pytest.raises(ValueError):
        native.knn_search(pts, pts, 5)
    with pytest.raises(ValueError):
        native.knn_search(pts, np.zeros((0, 3), np.float32), 1)


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """No fallback: with no compiler to be found the build raises."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="not found"):
        native.build()
