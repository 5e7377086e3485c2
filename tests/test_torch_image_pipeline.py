"""The port's image serving slice (uint8 -> logits) vs the JAX reference.

The JAX model's own parameters travel JAX -> numpy -> ``from_numpy``, so
both packages compute the same function on the same seeded images."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metatransformer_tpu.core import encoder as jenc
from metatransformer_tpu.heads import cls as jcls
from metatransformer_tpu.models import classifier as jclassifier
from metatransformer_tpu.models import image_classifier as jic
from metatransformer_tpu.tokenizers import image as jtok
from metatransformer_tpu_torch.core import convert, encoder as enc
from metatransformer_tpu_torch.heads import cls
from metatransformer_tpu_torch.models import classifier
from metatransformer_tpu_torch.models import image_classifier as ic
from metatransformer_tpu_torch.ops import fused_block as fb
from metatransformer_tpu_torch.tokenizers import image as tok

torch.set_num_threads(1)

IMG, PATCH, DIM, DEPTH, HEADS, NCLS = 32, 8, 128, 2, 2, 10


def _cfgs():
    jcfg = jic.ImageClassifierConfig(
        tokenizer=jtok.ImageTokenizerConfig(IMG, PATCH, 3, DIM),
        encoder=jenc.EncoderConfig(dim=DIM, depth=DEPTH, num_heads=HEADS),
        num_classes=NCLS,
    )
    cfg = ic.ImageClassifierConfig(
        tokenizer=tok.ImageTokenizerConfig(IMG, PATCH, 3, DIM),
        encoder=enc.EncoderConfig(dim=DIM, depth=DEPTH, num_heads=HEADS),
        num_classes=NCLS,
    )
    return jcfg, cfg


@pytest.fixture(scope="module")
def slice_pair():
    """JAX params (as numpy) and seeded uint8 images."""
    jcfg, cfg = _cfgs()
    np_params = jax.tree.map(np.asarray, jic.init(jcfg, jax.random.PRNGKey(0)))
    images = np.random.default_rng(1).integers(0, 256, (3, IMG, IMG, 3), dtype=np.uint8)
    return jcfg, cfg, np_params, images


def _jax_logits(np_params, images, jcfg, precision):
    params = jax.tree.map(jnp.asarray, np_params)
    return np.asarray(jic.forward(params, jnp.asarray(images), jcfg, precision))


def test_slice_fp32_logits_match_jax(slice_pair):
    jcfg, cfg, np_params, images = slice_pair
    got = ic.forward(convert.from_numpy(np_params, "cpu"), torch.tensor(images), cfg, enc.FP32)
    assert got.shape == (3, NCLS) and got.dtype == torch.float32
    want = _jax_logits(np_params, images, jcfg, jenc.FP32)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_slice_bf16_logits_match_jax(slice_pair):
    jcfg, cfg, np_params, images = slice_pair
    assert enc._resolve_impl(cfg.encoder, 17, enc.BF16) == "fused"
    fb.reset_launch_counts()
    got = ic.forward(convert.from_numpy(np_params, "cpu"), torch.tensor(images), cfg, enc.BF16)
    assert set(fb.launch_counts().values()) == {0}
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    want = _jax_logits(np_params, images, jcfg, jenc.BF16)
    np.testing.assert_allclose(got.numpy(), want, atol=0.15, rtol=0.1)


@pytest.mark.parametrize("precision", [enc.FP32, enc.BF16])
def test_module_wrapper_matches_functional_forward(slice_pair, precision):
    _, cfg, np_params, images = slice_pair
    params = convert.from_numpy(np_params, "cpu")
    model = ic.ImageClassifier(cfg, params, precision=precision, device="cpu")
    want = ic.forward(params, torch.tensor(images), cfg, precision)
    torch.testing.assert_close(model(torch.tensor(images)), want, atol=0, rtol=0)
    leaves = dict(model.named_buffers())
    assert leaves["encoder__qkv_w"].dtype == precision.compute_dtype
    assert leaves["encoder__norm1_scale"].dtype == torch.float32
    assert leaves["head__w0"].shape == (DIM, NCLS)


def test_load_encoder_swaps_weights(slice_pair):
    _, _, np_params, _ = slice_pair
    params = convert.from_numpy(np_params, "cpu")
    new = {k: v + 1 for k, v in params["encoder"].items()}
    out = ic.load_encoder(params, new)
    assert out["encoder"] is new and params["encoder"] is not new


def test_init_layout_matches_jax(slice_pair):
    jcfg, cfg, np_params, _ = slice_pair
    params = ic.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]
    got = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in flat(params)}
    want = {jax.tree_util.keystr(k): v.shape for k, v in flat(np_params)}
    assert got == want


def test_tokenizer_uint8_and_conv_match_jax():
    cfg = tok.ImageTokenizerConfig(img_size=32, patch_size=8, in_channels=3, dim=24)
    jcfg = jtok.ImageTokenizerConfig(img_size=32, patch_size=8, in_channels=3, dim=24)
    rng = np.random.default_rng(2)
    weight = rng.standard_normal((24, 3, 8, 8)).astype(np.float32) * 0.1
    bias = rng.standard_normal(24).astype(np.float32)
    u8 = rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    params = tok.convert_torch_conv(weight, bias, device="cpu")
    jparams = jtok.convert_torch_conv(weight, bias)
    np.testing.assert_array_equal(params["w"].numpy(), np.asarray(jparams["w"]))
    got = tok.apply(params, torch.tensor(u8), cfg)
    want = jtok.apply(jparams, jnp.asarray(u8), jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_array_equal(
        tok.patchify(torch.tensor(u8), 8).numpy(), np.asarray(jtok.patchify(jnp.asarray(u8), 8))
    )
    # uint8 is scaled on the device exactly as float input in [0, 1]
    f32 = tok.apply(params, torch.tensor(u8).float() * (1.0 / 255.0), cfg)
    torch.testing.assert_close(got, f32, atol=0, rtol=0)


@pytest.mark.parametrize("kind", ["cls", "mean", "cls_dist_avg", "cls,max", "cls,max,avg"])
def test_pool_matches_jax(kind):
    x = np.random.default_rng(3).standard_normal((2, 7, 16)).astype(np.float32)
    head = cls.ClsHeadConfig(in_dim=16, num_classes=3)
    jhead = jcls.ClsHeadConfig(in_dim=16, num_classes=3)
    common = dict(seq_len=5, num_prefix_tokens=2, pool=kind)
    got = classifier.pool(
        torch.tensor(x), classifier.ClassifierConfig(enc.EncoderConfig(16, 1, 1), head, **common)
    )
    want = jclassifier.pool(
        jnp.asarray(x),
        jclassifier.ClassifierConfig(jenc.EncoderConfig(16, 1, 1), jhead, **common),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_mlp_head_matches_jax_and_dropout_is_seeded():
    jcfg = jcls.ClsHeadConfig(in_dim=16, num_classes=3, mlps=(8,), dropout=0.5)
    cfg = cls.ClsHeadConfig(in_dim=16, num_classes=3, mlps=(8,), dropout=0.5)
    np_params = jax.tree.map(np.asarray, jcls.init(jcfg, jax.random.PRNGKey(4)))
    x = np.random.default_rng(5).standard_normal((4, 16)).astype(np.float32)
    params = convert.from_numpy(np_params, "cpu")
    got = cls.apply(params, torch.tensor(x), cfg)
    want = jcls.apply(jax.tree.map(jnp.asarray, np_params), jnp.asarray(x), jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # bf16 features promote to fp32 logits, as JAX's promotion does
    assert cls.apply(params, torch.tensor(x).bfloat16(), cfg).dtype == torch.float32
    a = cls.apply(params, torch.tensor(x), cfg, train=True,
                  generator=torch.Generator().manual_seed(0))
    b = cls.apply(params, torch.tensor(x), cfg, train=True,
                  generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert not torch.allclose(a, got)
    with pytest.raises(ValueError, match="Generator"):
        cls.apply(params, torch.tensor(x), cfg, train=True)
