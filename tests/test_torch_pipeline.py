"""The port's ``pipeline.py`` vs the JAX reference: ``Data2Seq`` over all
12 modalities, ``fuse_and_encode`` with masks, the bucket ladder and the
bucketed encoders (ragged keep-masks, the flash path forced, BF16 on the
fused route), and the multimodal classifier built on them.

Inputs come from seeded numpy; weights travel JAX -> numpy ->
``convert.from_numpy``. Encoders are 2 layers of 128 with 2 heads of 64.
On the JAX side flash attention is the Pallas kernel in interpret mode; on
the port's side a CPU tensor runs the plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metatransformer_tpu import pipeline as jpipe
from metatransformer_tpu.core import encoder as jenc
from metatransformer_tpu.models import multimodal_classifier as jmm
from metatransformer_tpu.tokenizers import audio as jaudio
from metatransformer_tpu.tokenizers import time_series as jts
from metatransformer_tpu.tokenizers import video as jvideo
from metatransformer_tpu_torch import pipeline
from metatransformer_tpu_torch.core import convert, encoder as enc
from metatransformer_tpu_torch.models import multimodal_classifier as mm
from metatransformer_tpu_torch.tokenizers import audio, hyper, image, tabular, time_series, video

torch.set_num_threads(1)

DIM, DEPTH, HEADS = 128, 2, 2


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jx(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return convert.from_numpy(tree, "cpu")


def _encs(**kw):
    return (jenc.EncoderConfig(dim=DIM, depth=DEPTH, num_heads=HEADS, **kw),
            enc.EncoderConfig(dim=DIM, depth=DEPTH, num_heads=HEADS, **kw))


def _graph_batch(rng, b=2, max_n=5, max_e=6):
    return {
        "node_data": rng.integers(0, 16, (b, max_n, 3)).astype(np.int32),
        "edge_data": rng.integers(0, 4, (b, max_e, 2)).astype(np.int32),
        "edge_index": rng.integers(0, max_n, (b, max_e, 2)).astype(np.int32),
        "node_num": np.array([max_n, 2], np.int32)[:b],
        "edge_num": np.array([max_e, 1], np.int32)[:b],
        "lap_eigvec": rng.standard_normal((b, max_n, 4)).astype(np.float32),
    }


# modality -> (config kwargs shared by both packages' config class, raw, token count)
def _cases():
    rng = np.random.default_rng(0)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {
        "image": (dict(img_size=32, patch_size=16, dim=DIM), f(2, 32, 32, 3), 4),
        "infrared": (dict(img_size=32, patch_size=16, in_channels=1, dim=DIM), f(2, 32, 32, 1), 4),
        "x-ray": (dict(img_size=32, patch_size=16, dim=DIM), f(2, 32, 32, 3), 4),
        "video": (dict(num_frames=4, img_size=32, dim=DIM), f(2, 4, 32, 32, 3), 8),
        "audio": (dict(num_mel_bins=32, num_frames=36, dim=DIM), f(2, 36, 32), 6),
        "time-series": (dict(c_in=7, dim=DIM), f(2, 24, 7), 24),
        "imu": (dict(c_in=6, dim=DIM), f(2, 20, 6), 20),
        "tabular": (dict(vocab_sizes=(3, 5, 4), dim=DIM),
                    np.array([[0, 4, 3], [2, 1, 0]], np.int32), 3),
        "hyper": (dict(img_size=1, near_band=7, num_tokens=10, dim=DIM), f(2, 10, 7), 11),
        "graph": (dict(num_atoms=16, num_edge_types=8, dim=DIM, lap_node_id_k=4),
                  _graph_batch(rng), 2 + 5 + 6),
        "text": (dict(vocab_size=64, context_length=8, width=32, depth=1, num_heads=4,
                      proj_dim=16, target_dim=DIM, eot_token_id=63),
                 np.concatenate([rng.integers(1, 60, (2, 7)), np.full((2, 1), 63)], 1), 1),
        "point": (dict(sample_ratio=0.25, group_size=4, embed_dim=DIM), f(2, 64, 3), 16),
    }


def test_modalities_and_aliases_equal_jax():
    assert set(pipeline.MODALITIES) == set(jpipe.MODALITIES)
    assert len(pipeline.MODALITIES) == 12
    for name, (mod, cfg_cls) in pipeline.MODALITIES.items():
        jmod, jcfg_cls = jpipe.MODALITIES[name]
        assert mod.__name__.rsplit(".", 1)[-1] == jmod.__name__.rsplit(".", 1)[-1], name
        assert cfg_cls.__name__ == jcfg_cls.__name__
    assert pipeline.MODALITIES["infrared"][0] is image and pipeline.MODALITIES["x-ray"][0] is image
    assert pipeline.MODALITIES["imu"][0] is time_series
    assert pipeline.BUCKETS == (64, 128, 256, 512, 1024, 1600, 2048, 3072)


@pytest.mark.parametrize("modality", sorted(_cases()))
def test_data2seq_builds_and_tokenizes_as_jax(modality):
    kw, raw, t = _cases()[modality]
    jfacade = jpipe.Data2Seq(modality, DIM, config=jpipe.MODALITIES[modality][1](**kw))
    facade = pipeline.Data2Seq(modality, DIM, config=pipeline.MODALITIES[modality][1](**kw))
    np_params = _np(jfacade.init(jax.random.PRNGKey(0)))
    ours = facade.init(torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree.map(np.shape, np_params) == jax.tree.map(np.shape, convert.to_numpy(ours))
    want = np.asarray(jfacade(_jx(np_params), _jx(raw)))
    with torch.no_grad():
        got = facade(_t(np_params), _t(raw))
        mine = facade(ours, _t(raw))  # the port's own seeded weights
    assert got.shape == want.shape == (2, t, DIM) and got.dtype == torch.float32
    assert mine.shape == got.shape and torch.isfinite(mine).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_default_configs_follow_the_width():
    for name in pipeline.MODALITIES:
        cfg, jcfg = pipeline.Data2Seq(name, 48).config, jpipe.Data2Seq(name, 48).config
        width = {"text": "target_dim", "point": "embed_dim"}.get(name, "dim")
        assert getattr(cfg, width) == getattr(jcfg, width) == 48
    assert pipeline.Data2Seq("imu", 16).config.c_in == 1


def test_hyper_takes_a_cls_token_and_graph_needs_a_batch_dict():
    kw, raw, _ = _cases()["hyper"]
    facade = pipeline.Data2Seq("hyper", DIM, config=hyper.HyperTokenizerConfig(**kw))
    params = facade.init(torch.Generator().manual_seed(0), device="cpu")
    cls = torch.randn(1, 1, DIM, generator=torch.Generator().manual_seed(1))
    with_cls = facade(params, torch.tensor(raw), cls_token=cls)
    plain = facade(params, torch.tensor(raw))
    torch.testing.assert_close(with_cls[:, 0] - plain[:, 0], cls[:, 0].expand(2, DIM))
    torch.testing.assert_close(with_cls[:, 1:], plain[:, 1:], rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="graph_collate"):
        pipeline.Data2Seq("graph", DIM)(None, [{"node_data": np.ones((2, 1))}])
    with pytest.raises(ValueError, match="unknown modality"):
        pipeline.Data2Seq("smell")
    with pytest.raises(RuntimeError, match="CUDA card"):
        pipeline.Data2Seq("tabular", 8, tabular.TabularTokenizerConfig((2,), dim=8)).init(
            torch.Generator().manual_seed(0))


# ---------------------------------------------------------- fuse and encode


def test_fuse_and_encode_matches_jax_with_masks():
    jecfg, ecfg = _encs()
    np_params = _np(jenc.init(jecfg, jax.random.PRNGKey(1)))
    rng = np.random.default_rng(2)
    groups = [rng.standard_normal((2, t, DIM)).astype(np.float32) for t in (5, 9, 3)]
    mask = np.ones((2, 9), bool)
    mask[1, 4:] = False
    for masks in (None, [None, mask, None]):
        want = jpipe.fuse_and_encode(
            _jx(np_params), [jnp.asarray(g) for g in groups], jecfg,
            None if masks is None else [None if m is None else jnp.asarray(m) for m in masks])
        got = pipeline.fuse_and_encode(
            _t(np_params), [torch.tensor(g) for g in groups], ecfg,
            None if masks is None else [None if m is None else torch.tensor(m) for m in masks])
        assert got.shape == (2, 17, DIM)
        keep = np.ones((2, 17), bool) if masks is None else np.concatenate(
            [np.ones((2, 5), bool), mask, np.ones((2, 3), bool)], 1)
        np.testing.assert_allclose(got.numpy()[keep], np.asarray(want)[keep], rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("t, bucket", [(1, 64), (63, 64), (64, 64), (65, 128), (128, 128),
                                       (129, 256), (256, 256), (257, 512), (512, 512),
                                       (513, 1024), (1024, 1024), (1025, 1600), (1600, 1600),
                                       (1601, 2048), (2048, 2048), (2049, 3072), (3072, 3072)])
def test_bucket_length_at_every_ladder_edge(t, bucket):
    assert pipeline.bucket_length(t) == jpipe.bucket_length(t) == bucket


def test_bucket_overflow_and_custom_ladder_raise_as_jax():
    for fn in (pipeline.bucket_length, jpipe.bucket_length):
        with pytest.raises(ValueError, match="exceeds largest bucket 3072"):
            fn(3073)
        assert fn(5, (4, 8)) == 8
    with pytest.raises(ValueError, match="exceeds largest bucket"):
        pipeline.pad_to_bucket(torch.zeros(1, 3073, 4))


def test_pad_to_bucket_matches_jax():
    x = np.random.default_rng(3).standard_normal((2, 70, 8)).astype(np.float32)
    m = np.ones((2, 70), bool)
    m[0, 50:] = False
    for mask in (None, m):
        jt, jm = jpipe.pad_to_bucket(jnp.asarray(x), None if mask is None else jnp.asarray(mask))
        t, k = pipeline.pad_to_bucket(torch.tensor(x), None if mask is None else torch.tensor(mask))
        assert t.shape == (2, 128, 8) and k.shape == (2, 128) and k.dtype == torch.bool
        np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(k.numpy(), np.asarray(jm))
    t, k = pipeline.pad_to_bucket(torch.tensor(x[:, :64]))  # already a bucket: unchanged
    assert t.shape == (2, 64, 8) and bool(k.all())


def _ragged(seed, b, t, lengths):
    x = np.random.default_rng(seed).standard_normal((b, t, DIM)).astype(np.float32)
    mask = np.zeros((b, t), bool)
    for i, n in enumerate(lengths):
        mask[i, :n] = True
    return x, mask


@pytest.mark.parametrize("impl", ["auto", "flash"])
def test_encode_bucketed_pooled_with_ragged_masks_matches_jax(impl):
    """FP32; "flash" forced runs the JAX Pallas kernel in interpret mode
    against the port's plain flash version."""
    jecfg, ecfg = _encs(attn_impl=impl)
    np_params = _np(jenc.init(jecfg, jax.random.PRNGKey(3)))
    x, mask = _ragged(4, 3, 40, (40, 17, 1))
    xt, mt = pipeline.pad_to_bucket(torch.tensor(x), torch.tensor(mask))
    jxt, jmt = jpipe.pad_to_bucket(jnp.asarray(x), jnp.asarray(mask))
    want = jpipe.encode_bucketed_pooled(_jx(np_params), jxt, jmt, jecfg, jenc.FP32)
    got = pipeline.encode_bucketed_pooled(_t(np_params), xt, mt, ecfg, enc.FP32)
    assert got.shape == (3, DIM) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    feats = pipeline.encode_bucketed(_t(np_params), xt, mt, ecfg, enc.FP32)
    jfeats = np.asarray(jpipe.encode_bucketed(_jx(np_params), jxt, jmt, jecfg, jenc.FP32))
    keep = np.asarray(jmt)
    np.testing.assert_allclose(feats.numpy()[keep], jfeats[keep], rtol=1e-4, atol=1e-4)


def test_encode_bucketed_pooled_bf16_on_the_fused_route_at_the_drift_bound():
    jecfg, ecfg = _encs()
    assert enc._resolve_impl(ecfg, 64, enc.BF16) == "fused"
    assert jenc._resolve_impl(jecfg, 64, jenc.BF16) == "fused"
    np_params = _np(jenc.init(jecfg, jax.random.PRNGKey(5)))
    x, mask = _ragged(6, 2, 50, (50, 13))
    xt, mt = pipeline.pad_to_bucket(torch.tensor(x), torch.tensor(mask))
    jxt, jmt = jpipe.pad_to_bucket(jnp.asarray(x), jnp.asarray(mask))
    want = jpipe.encode_bucketed_pooled(_jx(np_params), jxt, jmt, jecfg)
    with torch.no_grad():
        got = pipeline.encode_bucketed_pooled(_t(np_params), xt, mt, ecfg)
    assert got.dtype == torch.float32 and got.shape == (2, DIM)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=0.15, rtol=0.1)


# ------------------------------------------------------ multimodal classifier


def _mm_cfgs(num_classes=5):
    jecfg, ecfg = _encs()
    jcfg = jmm.MultimodalClassifierConfig(
        tokenizers=(jvideo.VideoTokenizerConfig(num_frames=4, img_size=32, dim=DIM),
                    jaudio.AudioTokenizerConfig(num_mel_bins=32, num_frames=32, dim=DIM),
                    jts.TimeSeriesConfig(c_in=3, dim=DIM)),
        encoder=jecfg, num_classes=num_classes)
    cfg = mm.MultimodalClassifierConfig(
        tokenizers=(video.VideoTokenizerConfig(num_frames=4, img_size=32, dim=DIM),
                    audio.AudioTokenizerConfig(num_mel_bins=32, num_frames=32, dim=DIM),
                    time_series.TimeSeriesConfig(c_in=3, dim=DIM)),
        encoder=ecfg, num_classes=num_classes)
    return jcfg, cfg


def _mm_inputs(seed, b=2):
    rng = np.random.default_rng(seed)
    return {"video": rng.standard_normal((b, 4, 32, 32, 3)).astype(np.float32),
            "audio": rng.standard_normal((b, 32, 32)).astype(np.float32),
            "time-series": rng.standard_normal((b, 24, 3)).astype(np.float32)}


def test_multimodal_classifier_matches_jax_and_manual_fusion():
    jcfg, cfg = _mm_cfgs()
    np_params = _np(jmm.init(jcfg, jax.random.PRNGKey(0)))
    ours = mm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree.map(np.shape, np_params) == jax.tree.map(np.shape, convert.to_numpy(ours))
    inputs = _mm_inputs(1)
    params = _t(np_params)
    want = np.asarray(jmm.forward(_jx(np_params), _jx(inputs), jcfg))
    with torch.no_grad():
        got = mm.forward(params, _t(inputs), cfg)
        facades = cfg.facades()
        groups = [facades[m](params["tok"][m], torch.tensor(inputs[m])) for m in cfg.modalities]
        fused = torch.cat(groups, dim=1)
        manual = enc.encode(params["encoder"], fused, cfg.encoder).mean(1) @ params["head"]["w"] \
            + params["head"]["b"]
    assert got.shape == (2, 5) and fused.shape[1] == 8 + 4 + 24
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    torch.testing.assert_close(got, manual, rtol=0, atol=1e-6)


def test_multimodal_default_trio_is_2876_tokens_on_flash():
    cfg, jcfg = mm.MultimodalClassifierConfig(), jmm.MultimodalClassifierConfig()
    assert cfg.modalities == jcfg.modalities == ("video", "audio", "time-series")
    toks = [f.config for f in cfg.facades().values()]
    t = toks[0].num_patches + toks[1].num_patches + 96
    assert t == 2876 and pipeline.bucket_length(t) == 3072
    for prec in (enc.BF16, enc.FP32):
        assert enc._resolve_impl(cfg.encoder, t, prec) == "flash"
    with pytest.raises(RuntimeError, match="CUDA card"):
        mm.init(_mm_cfgs()[1], torch.Generator().manual_seed(0))
