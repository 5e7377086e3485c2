"""The port's graph family vs the JAX reference: the Performer / FAVOR+
attention (``ops/performer.py``) and the encoder's ``"performer"`` branch,
the graph collator (``data/graph_collate.py``) and the TokenGT graph
predictor (``models/graph_predictor.py``: forward, L1 loss, evaluate and
the checkpoint entry).

Inputs come from seeded numpy; weights travel JAX -> numpy ->
``convert.from_numpy``. FP32 at 1e-4 (the encoder's parity tolerance);
the random features and the collated batches are the same numpy code in
both packages and must be equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metatransformer_tpu import pipeline as jpipe
from metatransformer_tpu.core import encoder as jenc
from metatransformer_tpu.data import graph_collate as jcollate
from metatransformer_tpu.models import graph_predictor as jgp
from metatransformer_tpu.ops import performer as jperf
from metatransformer_tpu.tokenizers import graph as jgraph
from metatransformer_tpu.utils import checkpoint as jckpt
from metatransformer_tpu_torch import pipeline
from metatransformer_tpu_torch.core import convert, encoder as enc
from metatransformer_tpu_torch.data import graph_collate
from metatransformer_tpu_torch.models import graph_predictor as gp
from metatransformer_tpu_torch.ops import performer
from metatransformer_tpu_torch.tokenizers import graph as graph_tok
from metatransformer_tpu_torch.utils import checkpoint

torch.set_num_threads(1)

TOL = 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jx(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return convert.from_numpy(tree, "cpu")


# ---------------------------------------------------------------- performer


@pytest.mark.parametrize("seed,nf,hd", [(0, 16, 8), (3, 48, 24), (7, 10, 24), (0, 64, 64)])
def test_orthogonal_random_features_equal_jax(seed, nf, hd):
    got = performer.orthogonal_random_features(seed, nf, hd)
    np.testing.assert_array_equal(got, jperf.orthogonal_random_features(seed, nf, hd))
    assert got.shape == (nf, hd) and got.dtype == np.float32
    block = got[: min(nf, hd)]
    np.testing.assert_allclose(block @ block.T, hd * np.eye(len(block)), atol=1e-4)


def _qkv(seed, b=2, h=2, t=12, d=8, scale=0.5):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, h, t, d)) * scale).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("nf", [16, 256])
def test_favor_attention_matches_jax(masked, nf):
    q, k, v = _qkv(1, t=10)
    w = performer.orthogonal_random_features(0, nf, 8)
    mask = np.array([[1] * 6 + [0] * 4, [1] * 10], bool) if masked else None
    want = np.asarray(jperf.favor_attention(*_jx([q, k, v]), jnp.asarray(w),
                                            mask=None if mask is None else jnp.asarray(mask)))
    got = performer.favor_attention(*[torch.from_numpy(a) for a in (q, k, v)],
                                    torch.from_numpy(w),
                                    mask=None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == (2, 2, 10, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_favor_tracks_exact_softmax_with_many_features():
    q, k, v = [torch.from_numpy(a) for a in _qkv(0)]
    exact = torch.softmax(q @ k.transpose(-1, -2) / np.sqrt(8), dim=-1) @ v

    def err(m):
        w = torch.from_numpy(performer.orthogonal_random_features(3, m, 8))
        est = performer.favor_attention(q, k, v, w)
        return ((est - exact).abs().mean() / exact.abs().mean()).item()

    small, big = err(16), err(2048)
    assert big < 0.15 and big < small, (small, big)


def _encoder_pair(**kw):
    args = dict(dim=48, depth=2, num_heads=2, attn_impl="performer")
    args.update(kw)
    return jenc.EncoderConfig(**args), enc.EncoderConfig(**args)


@pytest.mark.parametrize("kw", [dict(), dict(performer_features=64, performer_seed=5),
                                dict(num_heads=4, performer_features=10)])
@pytest.mark.parametrize("masked", [False, True])
def test_encoder_performer_branch_matches_jax(kw, masked):
    """encode(attn_impl="performer") at FP32 against JAX's, with and
    without a keep-mask; nf = 0 means 2 * head_dim."""
    jcfg, cfg = _encoder_pair(**kw)
    params = _np(jenc.init(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, 9, 48)) * 0.3).astype(np.float32)
    mask = np.array([[1] * 9, [1] * 5 + [0] * 4], bool) if masked else None
    want = np.asarray(jenc.encode(_jx(params), jnp.asarray(x), jcfg,
                                  mask=None if mask is None else jnp.asarray(mask)))
    with torch.no_grad():
        got = enc.encode(_t(params), torch.from_numpy(x), cfg,
                         mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    redrawn = enc.encode(_t(params), torch.from_numpy(x),
                         dataclasses.replace(cfg, performer_seed=cfg.performer_seed + 1))
    assert not torch.allclose(redrawn, got)


def test_performer_only_when_asked_and_graph_base_resolves_to_xla():
    for t in (10, 194, 512):
        for jp, p in ((jenc.FP32, enc.FP32), (jenc.BF16, enc.BF16)):
            assert enc._resolve_impl(enc.GRAPH_BASE, t, p) == jenc._resolve_impl(
                jenc.GRAPH_BASE, t, jp) == "xla"
            cfg = dataclasses.replace(enc.GRAPH_BASE, attn_impl="performer")
            assert enc._resolve_impl(cfg, t, p) == "performer"
            assert enc._resolve_impl(enc.BASE, t, p) != "performer"
    assert enc.GRAPH_BASE.head_dim == 24 and enc.GRAPH_BASE == dataclasses.replace(
        enc.BASE, num_heads=32)


# ---------------------------------------------------------------- collate


def _random_graphs(seed, n=5, f_n=9, f_e=3):
    rng = np.random.default_rng(seed)
    graphs = []
    for i in range(n):
        nodes, edges = int(rng.integers(1, 10)), int(rng.integers(0, 14))
        graphs.append({
            "node_data": rng.integers(1, 32, (nodes, f_n)).astype(np.int32),
            "edge_index": rng.integers(0, nodes, (edges, 2)).astype(np.int32),
            "edge_data": rng.integers(1, 16, (edges, f_e)).astype(np.int32),
        })
    return graphs


@pytest.mark.parametrize("lap_k", [3, 16])
def test_collate_equals_jax(lap_k):
    graphs = _random_graphs(0)
    got = graph_collate.collate(graphs, 12, 16, lap_k=lap_k)
    want = jcollate.collate(graphs, 12, 16, lap_k=lap_k)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError, match="exceeds bucket"):
        graph_collate.collate(graphs, 3, 16)


def test_laplacian_eig_equals_jax():
    edges = np.array([[0, 1], [1, 2], [2, 0], [2, 3]], np.int32)
    for n in (4, 6):  # 6: two isolated nodes
        got, want = graph_collate.laplacian_eig(edges, n), jcollate.laplacian_eig(edges, n)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    tri = graph_collate.laplacian_eig(edges[:3], 3)[1]
    np.testing.assert_allclose(sorted(tri), [0.0, 1.5, 1.5], atol=1e-5)


def test_data2seq_graph_takes_the_collated_batch_as_jax():
    cfg_kw = dict(num_atoms=64, num_edge_types=32, dim=32, lap_node_id_k=3)
    jf = jpipe.Data2Seq("graph", 32, config=jgraph.GraphTokenizerConfig(**cfg_kw))
    f = pipeline.Data2Seq("graph", 32, config=graph_tok.GraphTokenizerConfig(**cfg_kw))
    params = _np(jf.init(jax.random.PRNGKey(0)))
    batch = graph_collate.collate(_random_graphs(1, f_n=2, f_e=2), 12, 16, lap_k=3)
    want = np.asarray(jf(_jx(params), _jx(batch)))
    with torch.no_grad():
        got = f(_t(params), _t(batch))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    with pytest.raises(TypeError, match="graph_collate.collate"):
        f(_t(params), _random_graphs(1))


# ---------------------------------------------------------- graph predictor


def _predictor_cfgs(tok=None, **enc_kw):
    tok_kw = dict(num_atoms=64, num_edge_types=32, dim=32, lap_node_id_k=3)
    tok_kw.update(tok or {})
    enc_args = dict(dim=32, depth=2, num_heads=4)
    enc_args.update(enc_kw)
    layernorm = tok_kw.pop("layernorm_embedding", True)
    return (jgp.GraphPredictorConfig(tokenizer=jgraph.GraphTokenizerConfig(**tok_kw),
                                     encoder=jenc.EncoderConfig(**enc_args),
                                     layernorm_embedding=layernorm),
            gp.GraphPredictorConfig(tokenizer=graph_tok.GraphTokenizerConfig(**tok_kw),
                                    encoder=enc.EncoderConfig(**enc_args),
                                    layernorm_embedding=layernorm))


def _perturbed(params, seed):
    """Move the unit LN scales and zero biases off their init so the
    parity check sees every leaf act."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (a + rng.standard_normal(a.shape).astype(a.dtype) * 0.05)
        if a.dtype == np.float32 else a, params)


def test_init_matches_jax_layout_and_needs_a_device():
    jcfg, cfg = _predictor_cfgs()
    ours = convert.to_numpy(gp.init(cfg, torch.Generator().manual_seed(0), device="cpu"))
    want = _np(jgp.init(jcfg, jax.random.PRNGKey(0)))
    assert jax.tree.map(np.shape, ours) == jax.tree.map(np.shape, want)
    _, no_ln = _predictor_cfgs(tok=dict(layernorm_embedding=False))
    assert "embed_norm_scale" not in gp.init(no_ln, torch.Generator(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA card"):
        gp.init(cfg, torch.Generator().manual_seed(0))


@pytest.mark.parametrize("variant", [
    dict(), dict(tok=dict(layernorm_embedding=False)), dict(num_heads=2),
    dict(attn_impl="performer", performer_features=16), dict(tok=dict(lap_node_id_k=6)),
])
def test_forward_matches_jax(variant):
    jcfg, cfg = _predictor_cfgs(**variant)
    params = _perturbed(_np(jgp.init(jcfg, jax.random.PRNGKey(1))), 2)
    batch = graph_collate.collate(_random_graphs(3, f_n=2, f_e=2), 12, 16, lap_k=3)
    want = np.asarray(jgp.forward(_jx(params), _jx(batch), jcfg))
    with torch.no_grad():
        got = gp.forward(_t(params), batch, cfg)
    assert got.shape == (5, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_forward_with_the_training_sign_flip_matches_jax_given_its_draw():
    jcfg, cfg = _predictor_cfgs()
    params = _perturbed(_np(jgp.init(jcfg, jax.random.PRNGKey(1))), 3)
    batch = graph_collate.collate(_random_graphs(4, f_n=2, f_e=2), 12, 16, lap_k=3)
    key = jax.random.PRNGKey(9)
    want = np.asarray(jgp.forward(_jx(params), _jx(batch), jcfg, rng=key, train=True))
    _, sub = jax.random.split(key)
    signs = np.array(jnp.where(jax.random.uniform(sub, (5, 1, 3)) >= 0.5, 1.0, -1.0))
    with torch.no_grad():
        got = gp.forward(_t(params), batch, cfg, train=True, lap_signs=torch.from_numpy(signs))
        drawn = gp.forward(_t(params), batch, cfg, torch.Generator().manual_seed(0), train=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    assert drawn.shape == got.shape and torch.isfinite(drawn).all()


def test_padding_does_not_change_predictions():
    _, cfg = _predictor_cfgs()
    params = gp.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    graphs = _random_graphs(5, f_n=2, f_e=2)
    with torch.no_grad():
        small = gp.forward(params, graph_collate.collate(graphs, 10, 14, 3), cfg)
        big = gp.forward(params, graph_collate.collate(graphs, 17, 25, 3), cfg)
    torch.testing.assert_close(small, big, rtol=1e-4, atol=1e-5)


def test_l1_loss_matches_jax():
    rng = np.random.default_rng(0)
    pred, target = rng.standard_normal((6, 1)).astype(np.float32), rng.standard_normal(6)
    target = target.astype(np.float32)
    want = float(jgp.l1_loss(jnp.asarray(pred), jnp.asarray(target)))
    got = gp.l1_loss(torch.from_numpy(pred), torch.from_numpy(target)).item()
    assert abs(got - want) < 1e-6


def _eval_batches(seed):
    """Two collated batches; the second has a padding row (node_num 0)."""
    graphs = _random_graphs(seed, n=6, f_n=2, f_e=2)
    a = graph_collate.collate(graphs[:3], 12, 16, 3)
    b = graph_collate.collate(graphs[3:], 12, 16, 3)
    for k in b:
        b[k][2] = 0
    targets = np.random.default_rng(seed).standard_normal(6).astype(np.float32)
    return [(a, targets[:3]), (b, targets[3:])]


def test_evaluate_skips_padding_rows_as_jax():
    jcfg, cfg = _predictor_cfgs()
    params = _perturbed(_np(jgp.init(jcfg, jax.random.PRNGKey(2))), 4)
    batches = _eval_batches(6)
    want = jgp.evaluate(_jx(params), jcfg, [(_jx(b), t) for b, t in batches])
    got = gp.evaluate(_t(params), cfg, batches)
    assert got["n"] == want["n"] == 5
    assert abs(got["mae"] - want["mae"]) < TOL
    with torch.no_grad():
        pred = np.concatenate([gp.forward(_t(params), b, cfg)[:, 0].numpy()
                               for b, _ in batches])
    targets = np.concatenate([t for _, t in batches])
    keep = np.array([True] * 5 + [False])
    assert abs(got["mae"] - np.abs(pred - targets)[keep].mean()) < 1e-6
    assert np.isnan(gp.evaluate(_t(params), cfg, [])["mae"])


def test_evaluate_checkpoint_loads_either_package(tmp_path):
    """The checkpoint entry reads a port-written and a JAX-written trainable
    state (one npz layout) and evaluates as the JAX entry does."""
    jcfg, cfg = _predictor_cfgs()
    params = _perturbed(_np(jgp.init(jcfg, jax.random.PRNGKey(3))), 5)
    batches = _eval_batches(7)
    want = jgp.evaluate(_jx(params), jcfg, [(_jx(b), t) for b, t in batches])
    checkpoint.save_rotating(str(tmp_path / "port"), {"trainable": _t(params)}, epoch=0)
    jckpt.save_rotating(str(tmp_path / "jax"), {"trainable": _jx(params)}, epoch=0)
    for sub in ("port", "jax"):
        got = gp.evaluate_checkpoint(str(tmp_path / sub), cfg, batches, device="cpu")
        assert got["n"] == want["n"] and abs(got["mae"] - want["mae"]) < TOL
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        gp.evaluate_checkpoint(str(tmp_path / "none"), cfg, batches, device="cpu")
