"""The port's text path vs the JAX reference: the byte-level BPE (same ids
as the JAX ``CLIPBPE``, byte-level and on merges files the tests write),
the CLIP text tower and its HuggingFace converter, and the one-token
``apply``.

Weights travel JAX -> numpy -> ``convert.from_numpy``. The tower is small:
2 layers of 32, 4 heads, a 16-token context.
"""

import gzip

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metatransformer_tpu.tokenizers import bpe as jbpe
from metatransformer_tpu.tokenizers import text as jtext
from metatransformer_tpu_torch.core import convert
from metatransformer_tpu_torch.tokenizers import bpe, text

torch.set_num_threads(1)

MERGES = (("l", "l"), ("ll", "o</w>"), ("h", "e"), ("t", "h"), ("th", "e</w>"), ("c", "a"),
          ("ca", "t</w>"), ("a", "n"), ("o", "t"), ("d", "o"))
TEXTS = ["Hello  World, 123 café!", "the cat can't stop; the hello-hello", "", "do NOT 42x",
         "naïve ünïcödé — ok?", "a much longer sentence " * 20]


def _cfg(**kw):
    args = dict(vocab_size=100, context_length=16, width=32, depth=2, num_heads=4,
                proj_dim=24, target_dim=48, eot_token_id=99)
    args.update(kw)
    return text.TextTokenizerConfig(**args), jtext.TextTokenizerConfig(**args)


# ----------------------------------------------------------------------- BPE


def test_byte_tables_and_word_split_equal_jax():
    assert bpe.bytes_to_unicode() == jbpe.bytes_to_unicode()
    for t in TEXTS:
        assert bpe._word_split(t.lower()) == jbpe._word_split(t.lower())
    assert bpe._word_split("don't stop me 42!!") == ["don", "'t", "stop", "me", "4", "2", "!!"]


@pytest.mark.parametrize("merges", [(), MERGES], ids=["byte-level", "merges"])
def test_bpe_ids_equal_jax(merges):
    tok, jtok = bpe.CLIPBPE(merges=merges), jbpe.CLIPBPE(merges=merges)
    assert tok.vocab_size == jtok.vocab_size == 514 + len(merges)
    assert (tok.sot_id, tok.eot_id) == (jtok.sot_id, jtok.eot_id)
    for t in TEXTS:
        ids = tok.encode(t)
        assert ids == jtok.encode(t)
        assert tok.decode(ids) == jtok.decode(ids)
    got, want = tok.tokenize(TEXTS), jtok.tokenize(TEXTS)
    assert got.dtype == np.int32 and got.shape == (len(TEXTS), 77)
    np.testing.assert_array_equal(got, want)
    assert got[-1, -1] == tok.eot_id  # truncated with EOT last
    with pytest.raises(ValueError):
        tok.tokenize(TEXTS[-1:], truncate=False)


@pytest.mark.parametrize("suffix", [".txt", ".txt.gz"])
def test_merges_file_loads_as_jax_does(tmp_path, suffix):
    path = str(tmp_path / f"merges{suffix}")
    body = "#version: test\n" + "\n".join(" ".join(m) for m in MERGES) + "\nbad line here\n"
    opener = gzip.open if suffix.endswith(".gz") else open
    with opener(path, "wt", encoding="utf-8") as f:
        f.write(body)
    assert bpe.load_merges(path) == jbpe.load_merges(path) == MERGES
    assert bpe.load_merges(path, limit=3) == MERGES[:3]
    tok = bpe.CLIPBPE.from_file(path)
    assert tok._bpe("hello") == ("he", "llo</w>")
    np.testing.assert_array_equal(tok.tokenize(TEXTS), jbpe.CLIPBPE.from_file(path).tokenize(TEXTS))


# --------------------------------------------------------------------- tower


def _np_params(jcfg, seed=0):
    params = jax.tree.map(np.asarray, jtext.init(jcfg, jax.random.PRNGKey(seed)))
    # non-trivial LayerNorm and bias leaves, so every leaf is exercised
    rng = np.random.default_rng(seed + 10)
    for k, v in params.items():
        if "bias" in k or k.endswith("_b") or "scale" in k:
            params[k] = (v + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
    return params


def _ids(seed, b, t=16, eot=99):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 90, (b, t)).astype(np.int64)
    for i in range(b):  # EOT at a different place in each row, zeros after it
        pos = t - 1 - i % t
        ids[i, pos] = eot
        ids[i, pos + 1:] = 0
    return ids


def test_config_defaults_equal_jax():
    import dataclasses

    assert dataclasses.asdict(text.TextTokenizerConfig()) == dataclasses.asdict(
        jtext.TextTokenizerConfig())
    assert list(text._layer_shapes(text.TextTokenizerConfig())) == list(
        jtext._layer_shapes(jtext.TextTokenizerConfig()))


def test_encode_text_and_apply_match_jax():
    cfg, jcfg = _cfg()
    np_params = _np_params(jcfg)
    assert np_params["qkv_w"].shape == (2, 32, 96)  # stacked [depth, in, out]
    ids = _ids(1, 3)
    jparams = jax.tree.map(jnp.asarray, np_params)
    params = convert.from_numpy(np_params, "cpu")
    want = np.asarray(jtext.encode_text(jparams, jnp.asarray(ids), jcfg))
    got = text.encode_text(params, torch.tensor(ids), cfg)
    assert got.shape == (3, 24) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    out = text.apply(params, torch.tensor(ids, dtype=torch.int32), cfg)
    want_out = np.asarray(jtext.apply(jparams, jnp.asarray(ids), jcfg))
    np.testing.assert_allclose(out.numpy(), want_out, rtol=1e-4, atol=1e-4)
    assert out.shape == (3, 1, 48)
    torch.testing.assert_close(out[:, 0, :24], got, rtol=0, atol=0)
    assert out[:, :, 24:].abs().max() == 0


def test_shorter_context_uses_the_first_positions():
    cfg, jcfg = _cfg()
    np_params = _np_params(jcfg, seed=1)
    ids = _ids(2, 2, t=9)
    want = np.asarray(jtext.encode_text(jax.tree.map(jnp.asarray, np_params), jnp.asarray(ids),
                                        jcfg))
    got = text.encode_text(convert.from_numpy(np_params, "cpu"), torch.tensor(ids), cfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_quick_gelu_equals_jax():
    x = np.linspace(-6, 6, 101, dtype=np.float32)
    np.testing.assert_allclose(text.quick_gelu(torch.tensor(x)).numpy(),
                               np.asarray(jtext.quick_gelu(jnp.asarray(x))), rtol=1e-6, atol=1e-7)


def test_convert_hf_clip_text_matches_hf_model_and_jax_converter():
    from transformers import CLIPTextConfig, CLIPTextModelWithProjection

    cfg, jcfg = _cfg()
    hf_cfg = CLIPTextConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.width, intermediate_size=cfg.width * 4,
        num_hidden_layers=cfg.depth, num_attention_heads=cfg.num_heads,
        max_position_embeddings=cfg.context_length, projection_dim=cfg.proj_dim,
        eos_token_id=cfg.eot_token_id, hidden_act="quick_gelu",
    )
    torch.manual_seed(0)
    model = CLIPTextModelWithProjection(hf_cfg).eval()
    state = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    params = text.convert_hf_clip_text(state, cfg, device="cpu")
    jparams = jtext.convert_hf_clip_text(state, jcfg)
    assert set(params) == set(jparams)
    for k, v in params.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jparams[k]), err_msg=k)
    ids = _ids(0, 3)
    with torch.no_grad():
        want = model(torch.from_numpy(ids)).text_embeds
    torch.testing.assert_close(text.encode_text(params, torch.tensor(ids), cfg), want,
                               rtol=1e-4, atol=1e-4)


def test_raw_strings_to_one_token_each():
    """Raw strings -> byte-level ids -> the tower -> [B, 1, 768], zero past
    the projection width; init lands on the named device."""
    ids = bpe.CLIPBPE().tokenize(["a photo of a cat", "a dog"])
    cfg = text.TextTokenizerConfig(width=64, depth=2, num_heads=4)
    params = text.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert params["qkv_w"].shape == (2, 64, 192) and params["token_embed"].shape == (49408, 64)
    out = text.apply(params, torch.from_numpy(ids), cfg)
    assert out.shape == (2, 1, 768) and torch.isfinite(out).all()
    assert out[:, :, cfg.proj_dim:].abs().max() == 0
    with pytest.raises(RuntimeError, match="CUDA card"):
        text.init(cfg, torch.Generator().manual_seed(0))
