"""The port's dense-input modalities vs the JAX reference: time series and
IMU (tokenizer, decoder layer, the four tasks of the model), tabular
(tokenizer, classifier), hyper-spectral (tokenizer, classifier in ViT and
CAF modes) and graph tokens (TokenGT tokens and keep-mask).

Inputs come from seeded numpy; weights travel JAX -> numpy ->
``convert.from_numpy``. Encoders are 2 layers of 128 with 2 heads of 64.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metatransformer_tpu.core import encoder as jenc
from metatransformer_tpu.models import hyper_classifier as jhc
from metatransformer_tpu.models import tabular_classifier as jtc
from metatransformer_tpu.models import time_series as jtsm
from metatransformer_tpu.tokenizers import graph as jgraph
from metatransformer_tpu.tokenizers import hyper as jhyper
from metatransformer_tpu.tokenizers import tabular as jtab
from metatransformer_tpu.tokenizers import time_series as jts
from metatransformer_tpu_torch.core import convert, encoder as enc
from metatransformer_tpu_torch.models import hyper_classifier as hc
from metatransformer_tpu_torch.models import tabular_classifier as tc
from metatransformer_tpu_torch.models import time_series as tsm
from metatransformer_tpu_torch.tokenizers import graph, hyper, tabular
from metatransformer_tpu_torch.tokenizers import time_series as ts

torch.set_num_threads(1)

DIM, DEPTH, HEADS = 128, 2, 2


def _encs(depth=DEPTH, **kw):
    return (jenc.EncoderConfig(dim=DIM, depth=depth, num_heads=HEADS, **kw),
            enc.EncoderConfig(dim=DIM, depth=depth, num_heads=HEADS, **kw))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jx(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return convert.from_numpy(tree, "cpu")


def _perturb(tree, seed, scale=0.1):
    """Every leaf plus seeded noise: zero biases and unit scales would hide
    a leaf that is read wrong."""
    rng = np.random.default_rng(seed)
    if isinstance(tree, dict):
        return {k: _perturb(tree[k], seed + i, scale) for i, k in enumerate(sorted(tree))}
    if not np.issubdtype(tree.dtype, np.floating):
        return tree
    return (tree + scale * rng.standard_normal(tree.shape)).astype(np.float32)


# --------------------------------------------------------------- time series


def test_value_embed_matches_jax_and_circular_conv():
    c_in, d = 7, 16
    torch.manual_seed(0)
    conv = torch.nn.Conv1d(c_in, d, 3, padding=1, padding_mode="circular", bias=False)
    w = conv.weight.detach().numpy()
    params = ts.convert_torch_conv1d(w, device="cpu")
    np.testing.assert_array_equal(params["value_w"].numpy(),
                                  np.asarray(jts.convert_torch_conv1d(w)["value_w"]))
    x = np.random.default_rng(0).standard_normal((2, 10, c_in)).astype(np.float32)
    got = ts.value_embed(params, torch.tensor(x))
    with torch.no_grad():
        want = conv(torch.from_numpy(x).permute(0, 2, 1)).transpose(1, 2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jts.value_embed(_jx(_np(params)), jnp.asarray(x))),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n, d", [(96, 768), (13, 16), (7, 6)])
def test_sinusoid_table_equals_jax(n, d):
    np.testing.assert_array_equal(ts.sinusoid_table(n, d), jts.sinusoid_table(n, d))
    on = ts.positional_embed(d, n, "cpu")
    assert on.shape == (1, n, d) and ts.positional_embed(d, n, "cpu") is on


@pytest.mark.parametrize("embed_type, freq", [("fixed", "h"), ("learned", "t"), ("timeF", "h"),
                                              ("fixed", "t")])
def test_tokenizer_apply_matches_jax(embed_type, freq):
    jcfg = jts.TimeSeriesConfig(c_in=6, dim=32, embed_type=embed_type, freq=freq)
    cfg = ts.TimeSeriesConfig(c_in=6, dim=32, embed_type=embed_type, freq=freq)
    np_params = _np(jts.init(jcfg, jax.random.PRNGKey(0)))
    ours = ts.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert {k: v.shape for k, v in ours.items()} == {k: v.shape for k, v in np_params.items()}
    if embed_type == "fixed":
        for k in ours:
            if k.endswith("_emb"):
                np.testing.assert_array_equal(ours[k].numpy(), np_params[k])
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 12, 6)).astype(np.float32)
    if embed_type == "timeF":
        marks = rng.standard_normal((2, 12, 4)).astype(np.float32)
    else:
        marks = np.stack([rng.integers(0, s, (2, 12)) for s in (13, 32, 7, 24, 4)], -1)
    for mark in (None, marks):
        want = jts.apply(_jx(np_params), jnp.asarray(x), jcfg,
                         None if mark is None else jnp.asarray(mark))
        got = ts.apply(_t(np_params), torch.tensor(x), cfg,
                       None if mark is None else torch.tensor(mark))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    cfg_wo = dataclasses.replace(cfg, use_pos=False)
    got = ts.apply(_t(np_params), torch.tensor(x), cfg_wo)
    np.testing.assert_allclose(got.numpy(), np.asarray(jts.value_embed(_jx(np_params),
                                                                       jnp.asarray(x))), atol=1e-5)


def test_patch_embedding_matches_jax():
    pcfg = ts.PatchConfig(dim=16, patch_len=4, stride=2, padding=2)
    jpcfg = jts.PatchConfig(dim=16, patch_len=4, stride=2, padding=2)
    np_params = _np(jts.patch_init(jpcfg, jax.random.PRNGKey(0)))
    x = np.random.default_rng(2).standard_normal((2, 3, 11)).astype(np.float32)
    want, n_vars = jts.patch_apply(_jx(np_params), jnp.asarray(x), jpcfg)
    got, n = ts.patch_apply(_t(np_params), torch.tensor(x), pcfg)
    assert n == n_vars == 3 and got.shape == want.shape == (6, 5, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert ts.patch_init(pcfg, torch.Generator().manual_seed(0), "cpu")["w"].shape == (4, 16)


@pytest.mark.parametrize("causal", [True, False])
def test_decoder_layer_matches_jax(causal):
    dcfg = tsm.DecoderConfig(dim=16, d_ff=32, num_heads=4)
    jdcfg = jtsm.DecoderConfig(dim=16, d_ff=32, num_heads=4)
    rng = np.random.default_rng(3)
    p = {k: (rng.standard_normal(s) * (s[0] ** -0.5 if k.endswith("_w") else 0.1)
             + (1.0 if "scale" in k else 0.0)).astype(np.float32)
         for k, s in jtsm._decoder_layer_shapes(jdcfg).items()}
    assert list(p) == list(tsm._decoder_layer_shapes(dcfg))
    x = rng.standard_normal((2, 6, 16)).astype(np.float32)
    cross = rng.standard_normal((2, 9, 16)).astype(np.float32)
    want = jtsm._decoder_layer(jnp.asarray(x), jnp.asarray(cross), _jx(p), jdcfg,
                               jax.lax.Precision.HIGHEST, causal=causal)
    got = tsm._decoder_layer(torch.tensor(x), torch.tensor(cross), _t(p), dcfg, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def _ts_cfgs(task, **kw):
    jecfg, ecfg = _encs()
    common = dict(task=task, pred_len=4, seq_len=8, enc_in=3, dec_in=3, c_out=3, **kw)
    return (jtsm.TimeSeriesModelConfig(encoder=jecfg, decoder=jtsm.DecoderConfig(
                dim=DIM, d_ff=64, num_heads=4, depth=2), **common),
            tsm.TimeSeriesModelConfig(encoder=ecfg, decoder=tsm.DecoderConfig(
                dim=DIM, d_ff=64, num_heads=4, depth=2), **common))


@pytest.mark.parametrize("task", ["long_term_forecast", "imputation", "anomaly_detection",
                                  "classification"])
def test_time_series_model_matches_jax(task):
    kw = {"num_classes": 5} if task == "classification" else {}
    jcfg, cfg = _ts_cfgs(task, **kw)
    np_params = _perturb(_np(jtsm.init(jcfg, jax.random.PRNGKey(0))), 7)
    ours = tsm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    flat = lambda tree: {k: v.shape for k, v in convert.to_numpy(tree).items()} \
        if not isinstance(tree, np.ndarray) else tree.shape
    assert jax.tree.map(np.shape, np_params) == jax.tree.map(
        np.shape, convert.to_numpy(ours)), flat
    rng = np.random.default_rng(4)
    x_enc = rng.standard_normal((2, 8, 3)).astype(np.float32)
    marks = rng.integers(0, 4, (2, 8, 4))
    args = {"x_mark_enc": marks}
    if task == "long_term_forecast":
        args.update(x_dec=rng.standard_normal((2, 6, 3)).astype(np.float32),
                    x_mark_dec=rng.integers(0, 4, (2, 6, 4)))
    elif task == "anomaly_detection":
        args = {}
    elif task == "classification":
        pad = np.ones((2, 8), np.float32)
        pad[1, 6:] = 0.0
        args = {"x_mark_enc": pad}
    want = jtsm.forward(_jx(np_params), jnp.asarray(x_enc), jcfg,
                        **{k: jnp.asarray(v) for k, v in args.items()})
    with torch.no_grad():
        got = tsm.forward(_t(np_params), torch.tensor(x_enc), cfg,
                          **{k: torch.tensor(v) for k, v in args.items()})
    shape = {"long_term_forecast": (2, 4, 3), "classification": (2, 5)}.get(task, (2, 8, 3))
    assert got.shape == want.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_forecast_bf16_runs_the_decoder_in_fp32_at_the_drift_bound():
    jcfg, cfg = _ts_cfgs("long_term_forecast")
    np_params = _np(jtsm.init(jcfg, jax.random.PRNGKey(1)))
    rng = np.random.default_rng(5)
    x_enc = rng.standard_normal((2, 8, 3)).astype(np.float32)
    x_dec = rng.standard_normal((2, 6, 3)).astype(np.float32)
    want = jtsm.forward(_jx(np_params), jnp.asarray(x_enc), jcfg, None, jnp.asarray(x_dec), None,
                        jenc.BF16)
    with torch.no_grad():
        got = tsm.forward(_t(np_params), torch.tensor(x_enc), cfg, None, torch.tensor(x_dec),
                          None, enc.BF16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), atol=0.15, rtol=0.1)


# ------------------------------------------------------------------- tabular


def test_tabular_tokenizer_matches_jax():
    cfg = tabular.TabularTokenizerConfig(vocab_sizes=[3, 4, 5], dim=8)
    jcfg = jtab.TabularTokenizerConfig(vocab_sizes=[3, 4, 5], dim=8)
    np.testing.assert_array_equal(cfg.offsets, jcfg.offsets)
    assert (cfg.n_categorical, cfg.total_vocab) == (3, 12)
    np_params = _np(jtab.init(jcfg, jax.random.PRNGKey(0)))
    cats = np.array([[0, 1, 2], [2, 3, 4]], np.int32)
    got = tabular.apply(_t(np_params), torch.tensor(cats), cfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jtab.apply(_jx(np_params),
                                                                     jnp.asarray(cats), jcfg)))
    np.testing.assert_array_equal(got[1, 2].numpy(), np_params["embed"][3 + 4 + 4])
    cont = np.array([[1.0, -2.0]], np.float32)
    mean, std = np.array([0.5, 1.0], np.float32), np.array([2.0, 0.0], np.float32)
    np.testing.assert_allclose(
        tabular.normalize_continuous(torch.tensor(cont), torch.tensor(mean), torch.tensor(std)),
        np.asarray(jtab.normalize_continuous(cont, mean, std)), rtol=1e-6)


@pytest.mark.parametrize("n_cont, mlps", [(0, ()), (2, (16,))])
def test_tabular_classifier_matches_jax(n_cont, mlps):
    jecfg, ecfg = _encs()
    kw = dict(num_classes=3, head_mlps=mlps)
    jcfg = jtc.TabularClassifierConfig(jtab.TabularTokenizerConfig((3, 4, 5), n_cont, DIM),
                                       jecfg, **kw)
    cfg = tc.TabularClassifierConfig(tabular.TabularTokenizerConfig((3, 4, 5), n_cont, DIM),
                                     ecfg, **kw)
    assert cfg.head == tc.TabularClassifierConfig(
        tabular.TabularTokenizerConfig((3, 4, 5), n_cont, DIM), ecfg, **kw).head
    np_params = _perturb(_np(jtc.init(jcfg, jax.random.PRNGKey(0))), 3)
    rng = np.random.default_rng(6)
    cats = np.stack([rng.integers(0, v, 4) for v in (3, 4, 5)], -1).astype(np.int32)
    cont = rng.standard_normal((4, n_cont)).astype(np.float32) if n_cont else None
    want = jtc.forward(_jx(np_params), jnp.asarray(cats), jcfg,
                       None if cont is None else jnp.asarray(cont))
    with torch.no_grad():
        got = tc.forward(_t(np_params), torch.tensor(cats), cfg,
                         None if cont is None else torch.tensor(cont))
    assert got.shape == (4, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------- hyper


def _hyper_cfgs(mode, depth=4):
    jecfg, ecfg = _encs(depth)
    jcfg = jhc.HyperClassifierConfig(jhyper.HyperTokenizerConfig(2, 3, 6, DIM), jecfg, 5,
                                     mode=mode)
    cfg = hc.HyperClassifierConfig(hyper.HyperTokenizerConfig(2, 3, 6, DIM), ecfg, 5, mode=mode)
    return jcfg, cfg


def test_hyper_tokenizer_matches_jax():
    cfg, jcfg = hyper.HyperTokenizerConfig(2, 3, 6, 16), jhyper.HyperTokenizerConfig(2, 3, 6, 16)
    assert cfg.patch_dim == jcfg.patch_dim == 12
    np_params = _perturb(_np(jhyper.init(jcfg, jax.random.PRNGKey(0))), 1)
    x = np.random.default_rng(7).standard_normal((2, 5, 12)).astype(np.float32)
    cls = np.random.default_rng(8).standard_normal((1, 1, 16)).astype(np.float32)
    want = jhyper.apply(_jx(np_params), jnp.asarray(x), jcfg, jnp.asarray(cls))
    got = hyper.apply(_t(np_params), torch.tensor(x), cfg, torch.tensor(cls))
    assert got.shape == (2, 6, 16)  # cls + 5, positions [:6] of 7
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["vit", "caf"])
def test_hyper_classifier_matches_jax(mode):
    """FP32 against the JAX model; CAF with its skip mix moved off the
    identity so that the fusion is live."""
    jcfg, cfg = _hyper_cfgs(mode)
    np_params = _perturb(_np(jhc.init(jcfg, jax.random.PRNGKey(0))), 11, scale=0.05)
    if mode == "caf":
        assert np_params["skipcat_w"].shape == (2, 7, 7, 2)
    ours = hc.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree.map(np.shape, np_params) == jax.tree.map(np.shape, convert.to_numpy(ours))
    x = np.random.default_rng(9).standard_normal((3, 6, 12)).astype(np.float32)
    want = jhc.forward(_jx(np_params), jnp.asarray(x), jcfg)
    with torch.no_grad():
        got = hc.forward(_t(np_params), torch.tensor(x), cfg)
    assert got.shape == (3, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("precision", [enc.FP32, enc.BF16], ids=["fp32", "bf16"])
def test_caf_at_init_equals_vit_mode(precision):
    """Identity-initialised skip mix: CAF == ViT (the reference's own check),
    under FP32 and on the fused route under BF16."""
    _, caf = _hyper_cfgs("caf")
    _, vit = _hyper_cfgs("vit")
    params = hc.init(caf, torch.Generator().manual_seed(1), device="cpu")
    x = torch.randn(2, 6, 12, generator=torch.Generator().manual_seed(2))
    vit_params = {k: v for k, v in params.items() if not k.startswith("skipcat")}
    with torch.no_grad():
        got = hc.forward(params, x, caf, precision)
        want = hc.forward(vit_params, x, vit, precision)
    assert enc._resolve_impl(caf.encoder, 7, precision) == ("fused" if precision.is_bf16 else "xla")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_caf_feeds_each_block_a_contiguous_stream():
    """The fused sublayers take a contiguous [B, T, D] stream (their CUDA
    wrappers refuse any other); the skip mix must hand them one."""
    from unittest import mock

    _, cfg = _hyper_cfgs("caf")
    params = hc.init(cfg, torch.Generator().manual_seed(3), device="cpu")
    seen, block = [], enc.block

    def checked(x, *a, **kw):
        seen.append(x.is_contiguous())
        return block(x, *a, **kw)

    with mock.patch.object(enc, "block", checked), torch.no_grad():
        hc.forward(params, torch.randn(2, 6, 12), cfg, enc.BF16)
    assert seen == [True] * cfg.encoder.depth


# --------------------------------------------------------------------- graph


def _graph_batch(seed, b=3, max_n=6, max_e=7, f_n=2, f_e=2, k=3):
    rng = np.random.default_rng(seed)
    return {
        "node_data": rng.integers(0, 16, (b, max_n, f_n)).astype(np.int32),
        "edge_data": rng.integers(0, 8, (b, max_e, f_e)).astype(np.int32),
        "edge_index": rng.integers(0, max_n, (b, max_e, 2)).astype(np.int32),
        "node_num": np.array([max_n, 3, 1][:b], np.int32),
        "edge_num": np.array([max_e, 2, 0][:b], np.int32),
        "lap_eigvec": rng.standard_normal((b, max_n, k)).astype(np.float32),
    }


def _graph_cfgs(**kw):
    args = dict(num_atoms=16, num_edge_types=8, dim=16, lap_node_id_k=4, rand_node_id_dim=5,
                orf_node_id_dim=8)
    args.update(kw)
    return jgraph.GraphTokenizerConfig(**args), graph.GraphTokenizerConfig(**args)


def test_embed_sum_and_index_embed_match_jax():
    table = np.random.default_rng(0).standard_normal((10, 4)).astype(np.float32)
    ids = np.array([[[0, 3], [2, 0], [0, 0]]], np.int32)
    got = graph._embed_sum(torch.tensor(table), torch.tensor(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(jgraph._embed_sum(jnp.asarray(table),
                                                                         jnp.asarray(ids))))
    assert got[0, 2].abs().max() == 0
    node_id = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    index = np.array([[[0, 0], [1, 2]], [[2, 1], [0, 2]]], np.int32)
    got = graph._index_embed(torch.tensor(node_id), torch.tensor(index))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jgraph._index_embed(jnp.asarray(node_id), jnp.asarray(index))))


@pytest.mark.parametrize("k_avail", [3, 6])
def test_graph_tokens_and_mask_match_jax(k_avail):
    """Laplacian ids (padded up from 3 or cut down from 6 to k = 4) and the
    type id; the keep-mask and the zeroed padding slots."""
    jcfg, cfg = _graph_cfgs()
    np_params = _np(jgraph.init(jcfg, jax.random.PRNGKey(0)))
    batch = _graph_batch(1, k=k_avail)
    want, jkeep = jgraph.apply(_jx(np_params), _jx(batch), jcfg)
    tokens, keep = graph.apply(_t(np_params), _t(batch), cfg)
    assert tokens.shape == (3, 2 + 6 + 7, 16) and keep.dtype == torch.bool
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(keep[2].numpy(), [1, 1, 1] + [0] * 12)
    assert tokens[2, 3:].abs().max() == 0
    np.testing.assert_allclose(tokens.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_graph_random_ids_and_sign_flip_match_jax_given_its_draws():
    """rand + ORF + Laplacian ids with the training sign flip: the JAX
    draws, replayed in the reference's order, passed in."""
    jcfg, cfg = _graph_cfgs(rand_node_id=True, orf_node_id=True)
    np_params = _np(jgraph.init(jcfg, jax.random.PRNGKey(0)))
    batch = _graph_batch(2)
    rng = jax.random.PRNGKey(5)
    want, _ = jgraph.apply(_jx(np_params), _jx(batch), jcfg, rng=rng, train=True)
    rng, sub = jax.random.split(rng)
    rand_ids = jgraph._l2norm(jax.random.uniform(sub, (3, 6, 5)))
    rng, sub = jax.random.split(rng)
    orf_ids = jgraph.orf_node_ids(sub, 3, 6, 8)
    rng, sub = jax.random.split(rng)
    signs = jnp.where(jax.random.uniform(sub, (3, 1, 4)) >= 0.5, 1.0, -1.0)
    got, _ = graph.apply(_t(np_params), _t(batch), cfg, train=True,
                         rand_ids=torch.tensor(np.asarray(rand_ids)),
                         orf_ids=torch.tensor(np.asarray(orf_ids)),
                         lap_signs=torch.tensor(np.asarray(signs)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="Generator"):
        graph.apply(_t(np_params), _t(batch), cfg)
    drawn, keep = graph.apply(_t(np_params), _t(batch), cfg, torch.Generator().manual_seed(0),
                              train=True)
    assert drawn.shape == got.shape and torch.isfinite(drawn).all()
    assert keep.sum() == 2 * 3 + (6 + 7) + (3 + 2) + 1  # specials + each graph's slots


@pytest.mark.parametrize("max_n, dim", [(8, 8), (6, 8), (8, 5)])
def test_orf_node_ids_are_orthonormal_rows_of_unit_norm(max_n, dim):
    """QR's signs need not agree across libraries: held by property. Rows
    are unit norm; with dim >= max_n they are orthonormal, and a cut keeps
    the Gram matrix of the leading columns."""
    ids = graph.orf_node_ids(torch.Generator().manual_seed(0), 2, max_n, dim)
    assert ids.shape == (2, max_n, dim)
    torch.testing.assert_close(ids.norm(dim=-1), torch.ones(2, max_n), atol=1e-5, rtol=0)
    if dim >= max_n:
        gram = ids @ ids.transpose(1, 2)
        torch.testing.assert_close(gram, torch.eye(max_n).expand(2, -1, -1), atol=1e-5, rtol=0)
    again = graph.orf_node_ids(torch.Generator().manual_seed(0), 2, max_n, dim)
    torch.testing.assert_close(ids, again, rtol=0, atol=0)


def test_graph_init_matches_jax_shapes_and_needs_a_device():
    jcfg, cfg = _graph_cfgs(rand_node_id=True, orf_node_id=True)
    ours = graph.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    want = _np(jgraph.init(jcfg, jax.random.PRNGKey(0)))
    assert {k: tuple(v.shape) for k, v in ours.items()} == {k: v.shape for k, v in want.items()}
    with pytest.raises(RuntimeError, match="CUDA card"):
        graph.init(cfg, torch.Generator().manual_seed(0))
