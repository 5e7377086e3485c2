"""The port's ViT-Adapter (models/vit_adapter.py), multi-scale deformable
attention (ops/ms_deform_attn.py), window attention and BEiT blocks against
the JAX package on the CPU, FP32, at the JAX recipes' smoke geometry (dim 32,
depth 2, 64 px, conv_inplane 8, 4 deform heads).

Every parameter tree is perturbed with seeded noise before it is carried
across: the injector's gamma and the sampling-offset and attention weights
are zero at init, so a fresh tree would check nothing of them.

Tolerances: resize 1e-6; SAME conv / max-pool and MSDeformAttn 1e-5; the
adapter's features 1e-4 (the encoder's parity bound,
tests/test_encoder_parity.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metatransformer_tpu.core import beit as jbeit
from metatransformer_tpu.core import encoder as jenc
from metatransformer_tpu.models import vit_adapter as jva
from metatransformer_tpu.ops import ms_deform_attn as jmsda
from metatransformer_tpu.ops import window_attention as jwin
from metatransformer_tpu_torch.core import beit
from metatransformer_tpu_torch.core import convert
from metatransformer_tpu_torch.core import encoder as enc
from metatransformer_tpu_torch.models import vit_adapter as va
from metatransformer_tpu_torch.ops import ms_deform_attn as msda
from metatransformer_tpu_torch.ops import window_attention as win

torch.set_num_threads(1)
FEATURE_TOL = 1e-4


def perturb(tree, seed=0, scale=0.1):
    """Every floating leaf plus seeded normal noise (numpy tree out)."""
    rng = np.random.default_rng(seed)

    def leaf(a):
        a = np.asarray(a)
        if not np.issubdtype(a.dtype, np.floating):
            return a
        return (a + scale * rng.standard_normal(a.shape)).astype(a.dtype)

    return jax.tree.map(leaf, tree)


def smoke_adapter(jax_side: bool, **kw):
    """The JAX recipes' smoke adapter geometry (recipes.py _adapter_cfg)."""
    mod, e = (jva, jenc) if jax_side else (va, enc)
    return mod.ViTAdapterConfig(
        encoder=e.EncoderConfig(dim=32, depth=kw.pop("depth", 2), num_heads=4),
        img_size=64, patch_size=16, conv_inplane=8, deform_num_heads=4,
        interaction_indexes=kw.pop("interaction_indexes", ((0, 0), (1, 1))), **kw)


def images(b=2, hw=64, seed=1):
    return np.random.default_rng(seed).standard_normal((b, hw, hw, 3)).astype(np.float32)


def close(got, want, tol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


# --------------------------------------------------------------------------
# XLA semantics the helpers keep
# --------------------------------------------------------------------------

RESIZES = [  # (in h, in w, out h, out w, channels, method): every scale the path takes
    *[(16, 16, s, s, 8, "bilinear") for s in (1, 2, 3, 6)],  # UperNet's PPM
    *[(128, 128, s, s, 4, "bilinear") for s in (16, 32, 64)],  # Mask2Former's masks
    (512, 512, 384, 384, 3, "bilinear"), (64, 64, 80, 80, 3, "bilinear"),  # TTA
    (32, 32, 40, 40, 8, "bicubic"), (32, 32, 24, 24, 8, "bicubic"),  # TTA's pos-embed
    (16, 16, 128, 128, 5, "bilinear"), (4, 4, 16, 16, 8, "bilinear"),  # up to 1/4
]


@pytest.mark.parametrize("case", RESIZES, ids=lambda c: "x".join(map(str, c)))
def test_resize_is_jax_image_resize(case):
    h, w, oh, ow, c, method = case
    x = np.random.default_rng(h + oh).standard_normal((1, h, w, c)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (1, oh, ow, c), method)
    close(va.resize(torch.tensor(x), (oh, ow), method), want, 1e-6, str(case))


def test_resize_to_640_within_the_references_fp32_positions():
    """TTA's 1.25 upscale of a 512 image: ``jax.image.resize`` computes its
    sample positions in fp32, so near 640 they carry up to an ulp of 640;
    the two packages agree within that ulp times the largest step between
    neighbouring pixels (measured 7.4e-5 here)."""
    x = np.random.default_rng(512).standard_normal((1, 512, 512, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 640, 640, 3), "bilinear"))
    got = va.resize(torch.tensor(x), (640, 640)).numpy()
    step = max(np.abs(np.diff(x, axis=1)).max(), np.abs(np.diff(x, axis=2)).max())
    bound = 2 * np.spacing(np.float32(640)) * step
    assert np.abs(got - want).max() <= bound


CONVS = [  # (size, k, stride, cin, cout, groups)
    (8, 3, 1, 4, 6, 1), (8, 3, 2, 4, 6, 1), (9, 3, 2, 4, 6, 1), (9, 3, 1, 4, 6, 1),
    (64, 3, 2, 3, 4, 1), (7, 1, 1, 5, 3, 1), (8, 3, 1, 6, 6, 6), (5, 3, 1, 6, 6, 6),
]


@pytest.mark.parametrize("case", CONVS, ids=lambda c: "x".join(map(str, c)))
def test_conv2d_pads_as_xla_same(case):
    size, k, stride, cin, cout, groups = case
    rng = np.random.default_rng(size * k + stride)
    x = rng.standard_normal((2, size, size, cin)).astype(np.float32)
    w = rng.standard_normal((k, k, cin // groups, cout)).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    want = jva.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=stride,
                      groups=groups)
    got = va.conv2d(torch.tensor(x), torch.tensor(w), torch.tensor(b), stride=stride,
                    groups=groups)
    close(got, want, 1e-5, str(case))


@pytest.mark.parametrize("size", [8, 9, 64, 65])
def test_max_pool_pads_as_reduce_window_same(size):
    x = np.random.default_rng(size).standard_normal((2, size, size, 4)).astype(np.float32)
    want = jax.lax.reduce_window(jnp.asarray(x), -jnp.inf, jax.lax.max, (1, 3, 3, 1),
                                 (1, 2, 2, 1), "SAME")
    close(va.max_pool_same(torch.tensor(x)), want, 1e-5)


def test_group_norm_matches():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 6, 64)).astype(np.float32) * 3 + 1
    s, b = rng.standard_normal(64).astype(np.float32), rng.standard_normal(64).astype(np.float32)
    want = jva.group_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
    close(va.group_norm(torch.tensor(x), torch.tensor(s), torch.tensor(b)), want, 1e-5)


# --------------------------------------------------------------------------
# Multi-scale deformable attention
# --------------------------------------------------------------------------

SHAPES = [(8, 8), (4, 4), (2, 2)]


def test_bilinear_sample_matches_outside_the_map_too():
    rng = np.random.default_rng(4)
    img = rng.standard_normal((3, 5, 7, 4)).astype(np.float32)
    coords = rng.uniform(-0.2, 1.2, (3, 50, 2)).astype(np.float32)
    want = jmsda.bilinear_sample(jnp.asarray(img), jnp.asarray(coords))
    close(msda.bilinear_sample(torch.tensor(img), torch.tensor(coords)), want, 1e-5)


def test_ms_deform_attn_core_matches():
    rng = np.random.default_rng(5)
    s = sum(h * w for h, w in SHAPES)
    value = rng.standard_normal((2, s, 4, 8)).astype(np.float32)
    loc = rng.uniform(-0.1, 1.1, (2, 10, 4, 3, 4, 2)).astype(np.float32)
    wgt = rng.uniform(0, 1, (2, 10, 4, 3, 4)).astype(np.float32)
    want = jmsda.ms_deform_attn_core(jnp.asarray(value), SHAPES, jnp.asarray(loc),
                                     jnp.asarray(wgt))
    got = msda.ms_deform_attn_core(torch.tensor(value), SHAPES, torch.tensor(loc),
                                   torch.tensor(wgt))
    close(got, want, 1e-5)


@pytest.mark.parametrize("ratio", [0.5, 1.0])
def test_ms_deform_attn_apply_matches_with_perturbed_weights(ratio):
    jcfg = jmsda.MSDeformAttnConfig(dim=32, num_heads=4, num_levels=3, num_points=4, ratio=ratio)
    cfg = msda.MSDeformAttnConfig(dim=32, num_heads=4, num_levels=3, num_points=4, ratio=ratio)
    params = perturb(jmsda.init(jcfg, jax.random.PRNGKey(2)), seed=2)
    rng = np.random.default_rng(6)
    s = sum(h * w for h, w in SHAPES)
    q = rng.standard_normal((2, 12, 32)).astype(np.float32)
    ref = rng.uniform(0, 1, (2, 12, 3, 2)).astype(np.float32)
    v = rng.standard_normal((2, s, 32)).astype(np.float32)
    want = jmsda.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(q), jnp.asarray(ref),
                       jnp.asarray(v), SHAPES, jcfg)
    got = msda.apply(convert.from_numpy(params, "cpu"), torch.tensor(q), torch.tensor(ref),
                     torch.tensor(v), SHAPES, cfg)
    close(got, want, 1e-5)
    # the tree has the reference's keys and shapes
    fresh = msda.init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert {k: tuple(t.shape) for k, t in fresh.items()} == {
        k: np.shape(a) for k, a in params.items()}


def test_window_partition_round_trips_and_pads():
    x = torch.randn(2, 7 * 5, 3)
    w = win.window_partition(torch.randn(2, 36, 3), 6, 6, 3)
    assert w.shape == (8, 9, 3)
    want = jwin.windowed_block(jnp.asarray(x.numpy()), lambda t: t * 2.0 + 1.0, 7, 5, 3)
    close(win.windowed_block(x, lambda t: t * 2.0 + 1.0, 7, 5, 3), want, 1e-6)
    y = torch.randn(2, 36, 3)
    torch.testing.assert_close(win.window_unpartition(win.window_partition(y, 6, 6, 3), 2, 6, 6, 3), y)


# --------------------------------------------------------------------------
# BEiT blocks
# --------------------------------------------------------------------------


def test_beit_indices_and_encode_match():
    np.testing.assert_array_equal(beit.relative_position_index((3, 4)),
                                  jbeit.relative_position_index((3, 4)))
    np.testing.assert_array_equal(beit.windowed_relative_position_index((5, 5), 3),
                                  jbeit.windowed_relative_position_index((5, 5), 3))
    jcfg = jbeit.BEiTConfig(dim=32, depth=2, num_heads=4, window=(3, 3))
    cfg = beit.BEiTConfig(dim=32, depth=2, num_heads=4, window=(3, 3))
    params = perturb(jbeit.init(jcfg, jax.random.PRNGKey(3)), seed=3)
    x = np.random.default_rng(7).standard_normal((2, 10, 32)).astype(np.float32)
    want = jbeit.encode(jax.tree.map(jnp.asarray, params), jnp.asarray(x), jcfg)
    close(beit.encode(convert.from_numpy(params, "cpu"), torch.tensor(x), cfg), want, 1e-5)
    assert set(beit.init(cfg, torch.Generator(), "cpu")) == set(params)


# --------------------------------------------------------------------------
# The adapter
# --------------------------------------------------------------------------

# name: config overrides. The reference scans one stacked interaction body
# when the slices are uniform (same length, contiguous from block 0, one
# set of window flags) and loops over the slices otherwise; the port always
# loops. Both of the reference's routes are held here.
ADAPTERS = {
    "timm_stacked": {},
    "timm_stacked_two_blocks_a_slice": dict(depth=4, interaction_indexes=((0, 1), (2, 3))),
    "timm_stacked_spare_block": dict(depth=3),  # block 2 lies in no slice
    "timm_per_slice": dict(depth=3, interaction_indexes=((0, 0), (1, 2))),
    "timm_windowed": dict(window_attn=(True, True), window_size=3),
    "timm_windowed_per_slice": dict(window_attn=(True, False), window_size=3),
    "beit": dict(block_type="beit", window_attn=(True, False), window_size=3),
    "uniperceiver": dict(block_type="uniperceiver"),
}


@pytest.fixture(scope="module", params=sorted(ADAPTERS))
def adapter_run(request):
    """(name, port config, numpy params, images, JAX's features)."""
    name = request.param
    jcfg = smoke_adapter(True, **dict(ADAPTERS[name]))
    cfg = smoke_adapter(False, **dict(ADAPTERS[name]))
    params = perturb(jva.init(jcfg, jax.random.PRNGKey(0)))
    x = images()
    want = jax.jit(jva.apply, static_argnums=2)(jax.tree.map(jnp.asarray, params),
                                                 jnp.asarray(x), jcfg)
    return name, cfg, params, x, [np.asarray(f) for f in want]


def test_adapter_features_match_jax(adapter_run):
    name, cfg, params, x, want = adapter_run
    got = va.apply(convert.from_numpy(params, "cpu"), torch.tensor(x), cfg)
    assert len(got) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        close(g, w, FEATURE_TOL, f"{name} f{i + 1}")


def test_adapter_tree_matches_and_the_backward_reaches_every_leaf(adapter_run):
    name, cfg, params, x, _ = adapter_run
    fresh = va.init(cfg, torch.Generator().manual_seed(0), "cpu")
    shapes = lambda t: jax.tree.map(lambda a: tuple(np.shape(a)), t)  # noqa: E731
    assert shapes(convert.to_numpy(fresh)) == shapes(params)
    tree = convert.from_numpy(params, "cpu", requires_grad=True)
    sum(f.square().mean() for f in va.apply(tree, torch.tensor(x[:1]), cfg)).backward()
    missing = [p for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]
               if leaf.grad is None or not torch.isfinite(leaf.grad).all()]
    assert not missing, missing


@pytest.mark.parametrize("dim", [32, 128])
def test_adapter_bf16_keeps_the_stream_fp32_around_its_blocks(dim):
    """Under BF16 the token stream stays fp32, as the reference's does: a
    block that resolves to the fused sublayers (dim 128: D % 128 = 0, head
    dim 32) takes it in bf16, the kernels' dtype; any other (dim 32: "xla")
    takes it in fp32 and casts inside. The features stay fp32 and finite."""
    cfg = smoke_adapter(False, window_attn=(True, False), window_size=3)
    cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, dim=dim))
    tree = va.init(cfg, torch.Generator().manual_seed(0), "cpu")
    seen = []
    orig = enc.block
    with pytest.MonkeyPatch.context() as m:
        m.setattr(enc, "block", lambda x, *a, **k: seen.append(
            (x.dtype, enc._resolve_impl(cfg.encoder, x.shape[1], enc.BF16))) or orig(x, *a, **k))
        feats = va.apply(tree, torch.tensor(images(1)), cfg, enc.BF16)
    impl = "fused" if dim == 128 else "xla"
    dtype = torch.bfloat16 if dim == 128 else torch.float32
    assert seen == [(dtype, impl)] * 2
    assert all(f.dtype == torch.float32 and torch.isfinite(f).all() for f in feats)
