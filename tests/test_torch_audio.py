"""The port's audio path vs the JAX reference: fbank, the AST tokenizer and
its converters, the positional-grid adaptation and the audio classifier
from spectrogram and from waveform.

Inputs come from seeded numpy; weights travel JAX -> numpy ->
``convert.from_numpy``. Sizes are small: 32 mel bins x 64 frames (2 x 5 =
10 overlapping patches), encoder 2 layers of 128 with 2 heads of 64.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metatransformer_tpu.core import encoder as jenc
from metatransformer_tpu.models import audio_classifier as jac
from metatransformer_tpu.ops import fbank as jfbank
from metatransformer_tpu.tokenizers import audio as jtok
from metatransformer_tpu_torch.core import convert, encoder as enc
from metatransformer_tpu_torch.models import audio_classifier as ac
from metatransformer_tpu_torch.ops import fbank
from metatransformer_tpu_torch.tokenizers import audio as tok

torch.set_num_threads(1)

MEL, FRAMES, DIM, DEPTH, HEADS, NCLS = 32, 64, 128, 2, 2, 5
TOK_ARGS = dict(num_mel_bins=MEL, num_frames=FRAMES, dim=DIM)
SAMPLES = 400 + (FRAMES - 1) * 160  # exactly FRAMES frames


def _wave(seed, b, n=SAMPLES):
    return (np.random.default_rng(seed).standard_normal((b, n)) * 0.1).astype(np.float32)


# --------------------------------------------------------------------- fbank


def test_fbank_config_and_tables_equal_jax():
    cfg, jcfg = fbank.FbankConfig(), jfbank.FbankConfig()
    for name in ("frame_shift", "frame_length", "fft_size"):
        assert getattr(cfg, name) == getattr(jcfg, name)
    np.testing.assert_array_equal(fbank.mel_banks(cfg), jfbank.mel_banks(jcfg))
    np.testing.assert_array_equal(fbank._hanning(400), jfbank._hanning(400))
    for n in (0, 399, 400, 559, 560, 164_080):
        assert fbank.num_frames(n, cfg) == jfbank.num_frames(n, jcfg)
    assert fbank.num_frames(164_080, cfg) == 1024
    assert fbank.EPS == jfbank.EPS


@pytest.mark.parametrize("mel_bins", [128, MEL])
def test_fbank_matches_jax_and_numpy_oracle(mel_bins):
    cfg = fbank.FbankConfig(num_mel_bins=mel_bins)
    wav = _wave(0, 2, 16000)  # 1 s at 16 kHz: 98 frames
    got = fbank.fbank(torch.tensor(wav), cfg)
    assert got.shape == (2, 98, mel_bins) and got.dtype == torch.float32
    want = np.asarray(jfbank.fbank(jnp.asarray(wav), jfbank.FbankConfig(num_mel_bins=mel_bins)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), fbank.fbank_np(wav[1], cfg), rtol=1e-4, atol=1e-4)
    jcfg = jfbank.FbankConfig(num_mel_bins=mel_bins)
    np.testing.assert_array_equal(fbank.fbank_np(wav[0], cfg), jfbank.fbank_np(wav[0], jcfg))


def test_fbank_pure_dc_is_the_log_eps_floor():
    got = fbank.fbank(torch.ones(1, 1000))
    torch.testing.assert_close(got, torch.full_like(got, np.log(fbank.EPS)))


# ----------------------------------------------------------------- tokenizer


def test_tokenizer_config_matches_jax():
    a, b = jtok.AudioTokenizerConfig(), tok.AudioTokenizerConfig()
    for name in ("f_patches", "t_patches", "num_patches"):
        assert getattr(a, name) == getattr(b, name)
    assert (b.f_patches, b.t_patches, b.num_patches) == (12, 101, 1212)


def test_tokenizer_apply_matches_jax():
    cfg = tok.AudioTokenizerConfig(**TOK_ARGS)
    np_params = jax.tree.map(np.asarray, jtok.init(jtok.AudioTokenizerConfig(**TOK_ARGS),
                                                   jax.random.PRNGKey(0)))
    assert np_params["w"].shape == (16, 16, 1, DIM)  # HWIO, carried unchanged
    spec = np.random.default_rng(1).standard_normal((2, FRAMES, MEL)).astype(np.float32)
    want = np.asarray(jtok.apply(jax.tree.map(jnp.asarray, np_params), jnp.asarray(spec),
                                 jtok.AudioTokenizerConfig(**TOK_ARGS)))
    got = tok.apply(convert.from_numpy(np_params, "cpu"), torch.tensor(spec), cfg)
    assert got.shape == (2, 10, DIM) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_convert_torch_conv_matches_strided_conv():
    cfg = tok.AudioTokenizerConfig(num_mel_bins=40, num_frames=60, dim=24)
    torch.manual_seed(0)
    conv = torch.nn.Conv2d(1, 24, kernel_size=(16, 16), stride=(10, 10))
    w, b = conv.weight.detach().numpy(), conv.bias.detach().numpy()
    params = tok.convert_torch_conv(w, b, device="cpu")
    np.testing.assert_array_equal(params["w"].numpy(),
                                  np.asarray(jtok.convert_torch_conv(w, b)["w"]))
    spec = np.random.default_rng(0).standard_normal((2, 60, 40)).astype(np.float32)
    with torch.no_grad():  # AST: [B, T, F] -> [B, 1, F, T]
        want = conv(torch.from_numpy(spec).unsqueeze(1).transpose(2, 3)).flatten(2).transpose(1, 2)
    got = tok.apply(params, torch.tensor(spec), cfg)
    assert got.shape == (2, 15, 24)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_rgb_channel_sum_init_equals_jax():
    rng = np.random.default_rng(0)
    rgb_w = rng.standard_normal((8, 3, 16, 16)).astype(np.float32)
    rgb_b = rng.standard_normal(8).astype(np.float32)
    got = tok.init_from_rgb_patch(rgb_w, rgb_b, device="cpu")
    want = jtok.init_from_rgb_patch(rgb_w, rgb_b)
    assert got["w"].shape == (16, 16, 1, 8)
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))
    np.testing.assert_array_equal(got["b"].numpy(), np.asarray(want["b"]))


def test_init_draws_hwio_on_the_named_device_and_the_card_by_default():
    cfg = tok.AudioTokenizerConfig(**TOK_ARGS)
    params = tok.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert params["w"].shape == (16, 16, 1, DIM) and params["b"].abs().max() == 0
    with pytest.raises(RuntimeError, match="CUDA card"):
        tok.init(cfg, torch.Generator().manual_seed(0))


# ----------------------------------------------------------------- classifier


@pytest.mark.parametrize("old, new", [((12, 101), (12, 5)), ((3, 4), (5, 9)), ((6, 7), (2, 11))])
def test_adapt_pos_embed_matches_jax(old, new):
    pos = np.random.default_rng(2).standard_normal((1, 2 + old[0] * old[1], 16)).astype(np.float32)
    want = np.asarray(jac.adapt_pos_embed(jnp.asarray(pos), old, new))
    got = ac.adapt_pos_embed(torch.tensor(pos), old, new)
    assert got.shape == (1, 2 + new[0] * new[1], 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _cfgs(pool="first2_avg", impl="auto"):
    jcfg = jac.AudioClassifierConfig(
        tokenizer=jtok.AudioTokenizerConfig(**TOK_ARGS),
        fbank=jfbank.FbankConfig(num_mel_bins=MEL),
        encoder=jenc.EncoderConfig(dim=DIM, depth=DEPTH, num_heads=HEADS, attn_impl=impl),
        num_classes=NCLS, pool=pool,
    )
    cfg = ac.AudioClassifierConfig(
        tokenizer=tok.AudioTokenizerConfig(**TOK_ARGS),
        fbank=fbank.FbankConfig(num_mel_bins=MEL),
        encoder=enc.EncoderConfig(dim=DIM, depth=DEPTH, num_heads=HEADS, attn_impl=impl),
        num_classes=NCLS, pool=pool,
    )
    return jcfg, cfg


def _np_params(jcfg, seed=0):
    return jax.tree.map(np.asarray, jac.init(jcfg, jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("pool", ["first2_avg", "cls_dist_avg_fixed"])
def test_spectrogram_forward_fp32_matches_jax(pool):
    jcfg, cfg = _cfgs(pool)
    np_params = _np_params(jcfg)
    assert ("prefix_tokens" in np_params) == (pool == "cls_dist_avg_fixed")
    spec = np.random.default_rng(3).standard_normal((2, FRAMES, MEL)).astype(np.float32)
    want = np.asarray(jac.forward_spectrogram(jax.tree.map(jnp.asarray, np_params),
                                              jnp.asarray(spec), jcfg, jenc.FP32))
    with torch.no_grad():
        got = ac.forward(convert.from_numpy(np_params, "cpu"), torch.tensor(spec), cfg, enc.FP32)
    assert got.shape == (2, NCLS) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_waveform_forward_matches_jax(precision):
    """Waveform -> fbank -> logits. FP32 at the encoder's 1e-4; BF16 on the
    fused route (the JAX Pallas kernels in interpret mode, the port's plain
    versions) at the fused kernels' drift bound."""
    jcfg, cfg = _cfgs()
    np_params = _np_params(jcfg, seed=1)
    wav = _wave(4, 2) + 0.3  # a DC offset the mean removal takes away
    jprec, prec = (jenc.FP32, enc.FP32) if precision == "fp32" else (jenc.BF16, enc.BF16)
    want = np.asarray(jac.forward_waveform(jax.tree.map(jnp.asarray, np_params),
                                           jnp.asarray(wav), jcfg, jprec), np.float32)
    with torch.no_grad():
        got = ac.forward_waveform(convert.from_numpy(np_params, "cpu"), torch.tensor(wav), cfg,
                                  prec)
    assert got.shape == (2, NCLS) and got.dtype == torch.float32
    if precision == "fp32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=0.15, rtol=0.1)


def test_flash_forced_forward_matches_jax_pallas_in_interpret_mode():
    jcfg, cfg = _cfgs(impl="flash")
    np_params = _np_params(jcfg, seed=2)
    spec = np.random.default_rng(5).standard_normal((1, FRAMES, MEL)).astype(np.float32)
    want = np.asarray(jac.forward_spectrogram(jax.tree.map(jnp.asarray, np_params),
                                              jnp.asarray(spec), jcfg, jenc.FP32))
    with torch.no_grad():
        got = ac.forward(convert.from_numpy(np_params, "cpu"), torch.tensor(spec), cfg)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_full_geometry_resolves_to_flash():
    """1212 tokens at 1024 frames x 128 bins: the flash path in both
    packages under either policy."""
    cfg, jcfg = ac.AudioClassifierConfig(), jac.AudioClassifierConfig()
    t = cfg.tokenizer.num_patches
    assert t == jcfg.tokenizer.num_patches == 1212
    for prec, jprec in ((enc.BF16, jenc.BF16), (enc.FP32, jenc.FP32)):
        assert enc._resolve_impl(cfg.encoder, t, prec) == "flash"
        assert jenc._resolve_impl(jcfg.encoder, t, jprec) == "flash"
    assert dataclasses.asdict(cfg.fbank) == dataclasses.asdict(jcfg.fbank)
