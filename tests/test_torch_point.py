"""The point-cloud models of the PyTorch port vs the JAX reference: tokenizer,
classifier, segmenter, masked point ViT, and one training step of each
track.

Inputs come from seeded numpy and weights travel JAX -> numpy ->
``convert.from_numpy``. Sizes are small (128 points -> 32 groups of 8, dim
128, 2 heads of 64, 2 layers). On the JAX side FPS is the XLA twin and, under
BF16, the fused sublayers are the Pallas kernels in interpret mode; on the
port's side every kernel wrapper runs its plain version, which is what a CPU
tensor gets. Dropout and masks are not comparable across frameworks, so
parity runs ``head_dropout=0`` and feeds the masked model its shuffle.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from metatransformer_tpu.core import encoder as jenc
from metatransformer_tpu.models import point_classifier as jpc
from metatransformer_tpu.models import point_mae as jmae
from metatransformer_tpu.models import point_segmenter as jps
from metatransformer_tpu.tokenizers import point as jtok
from metatransformer_tpu.train import optim as joptim
from metatransformer_tpu.train import step as jstep
from metatransformer_tpu_torch.core import convert, encoder as enc
from metatransformer_tpu_torch.core.tree import leaves_with_path
from metatransformer_tpu_torch.models import point_classifier as pc
from metatransformer_tpu_torch.models import point_mae as mae
from metatransformer_tpu_torch.models import point_segmenter as ps
from metatransformer_tpu_torch.tokenizers import point as tok
from metatransformer_tpu_torch.train import optim
from metatransformer_tpu_torch.train import step as step_lib

torch.set_num_threads(1)

N, DIM, DEPTH, HEADS, K, NCLS = 128, 128, 2, 2, 8, 5
# FP32: the same arithmetic in another order of summation, through a conv
# stack with InstanceNorm, 2 blocks and a head.
FP32_ATOL = 1e-4
# BF16: the drift bound of the reference's fused-vs-XLA bf16 encoder test
# (tests/test_fused_block.py).
BF16_ATOL, BF16_RTOL = 0.15, 0.1


def _cloud(seed, b, n=N, c=3):
    return np.random.default_rng(seed).standard_normal((b, n, c)).astype(np.float32)


def _tok_cfgs(**kw):
    kw = {"group_size": K, "embed_dim": DIM, **kw}
    return jtok.PointTokenizerConfig(**kw), tok.PointTokenizerConfig(**kw)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


# ----------------------------------------------------------------- tokenizer


def test_tokenizer_config_matches_jax():
    for kw in ({}, {"feature_type": "dp"}, {"layers": 6, "in_channels": 6}):
        a, b = jtok.PointTokenizerConfig(**kw), tok.PointTokenizerConfig(**kw)
        assert a.channels == b.channels
    assert dataclasses.asdict(jtok.PointTokenizerConfig()) == dataclasses.asdict(
        tok.PointTokenizerConfig())
    assert tok.PointTokenizerConfig().precision == "highest"
    assert tok.PointTokenizerConfig().channels == (6, 768, 768, 1536, 768)


@pytest.mark.parametrize(
    "kw",
    [
        {"feature_type": "dp_fj"},
        {"feature_type": "dp"},
        {"feature_type": "fj"},
        {"feature_type": "df"},
        {"feature_type": "dp_df"},
        {"group": "ballquery", "radius": 0.9},
        {"reduction": "mean"},
        {"norm": "none", "normalize_dp": True},
        {"relative_xyz": False, "sample_ratio": 0.3},  # int(128 * 0.3) = 38: truncates
    ],
    ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()),
)
def test_tokenizer_apply_matches_jax(kw):
    jcfg, cfg = _tok_cfgs(**kw)
    np_params = _np(jtok.init(jcfg, jax.random.PRNGKey(0)))
    pts = _cloud(1, 2)
    jc, jt, jdp = jtok.apply(_jnp(np_params), jnp.asarray(pts), jcfg, return_grouped=True)
    with torch.no_grad():
        c, t, dp = tok.apply(convert.from_numpy(np_params, "cpu"), torch.tensor(pts), cfg,
                             return_grouped=True)
    m = int(N * cfg.sample_ratio)
    assert c.shape == (2, m, 3) and t.shape == (2, m, DIM) and dp.shape == (2, m, K, 3)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))  # same FPS indices
    # the max / mean over K is order-free, so near-tied neighbours cannot show
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=FP32_ATOL)
    if cfg.group == "ballquery":  # exact integer selection: the groups agree slot by slot
        np.testing.assert_allclose(dp.numpy(), np.asarray(jdp), atol=1e-6)


def test_tokenizer_features_random_subsample_and_init():
    _, cfg = _tok_cfgs(in_channels=4, subsample="random")
    params = tok.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert [tuple(params[f"w{i}"].shape) for i in range(4)] == [
        (7, DIM), (DIM, DIM), (2 * DIM, 2 * DIM), (2 * DIM, DIM)]
    assert all(params[f"b{i}"].abs().sum() == 0 for i in range(4))
    pts, feats = torch.tensor(_cloud(2, 2)), torch.tensor(_cloud(3, 2, c=4))
    with pytest.raises(ValueError, match="Generator"):
        tok.apply(params, pts, cfg, feats)
    a = tok.apply(params, pts, cfg, feats, generator=torch.Generator().manual_seed(1))
    b = tok.apply(params, pts, cfg, feats, generator=torch.Generator().manual_seed(1))
    assert a[1].shape == (2, 32, DIM) and torch.equal(a[1], b[1])
    with pytest.raises(RuntimeError, match="CUDA card"):
        tok.init(cfg, torch.Generator().manual_seed(0))  # no device named: the card


def test_tokenizer_matmul_precision_highest_and_default():
    """"highest" is plain fp32; "default" rounds the operands of every
    conv-stage product to bf16, accumulates in fp32 and keeps the sum, the
    bias, InstanceNorm and ReLU in fp32: the result is not rounded. The
    backward's two products round the cotangent to bf16 likewise."""
    _, cfg = _tok_cfgs()
    params = tok.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    pts = torch.tensor(_cloud(4, 2))
    x, w = torch.tensor(_cloud(5, 3, 16, 24)), params["w1"][:24]
    b = torch.tensor(_cloud(6, 1, 1, DIM)[0, 0])
    torch.testing.assert_close(enc.linear_at(x, w, b, "highest"), x @ w + b, atol=1e-5, rtol=0)
    r = lambda t: t.bfloat16().float()
    want = r(x) @ r(w) + b
    got = enc.linear_at(x, w, b, "default")
    # fp32 sums of the same bf16 products: only the order of summation differs
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    assert got.dtype == torch.float32 and got.shape == (3, 16, DIM)
    assert not torch.equal(got, r(got))  # the result keeps its fp32 bits
    xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    cot = torch.tensor(_cloud(7, 3, 16, DIM))
    enc.linear_at(xg, wg, b, "default").backward(cot)
    torch.testing.assert_close(xg.grad, r(cot) @ r(w).t(), atol=1e-4, rtol=0)
    torch.testing.assert_close(
        wg.grad, r(x).reshape(-1, 24).t() @ r(cot).reshape(-1, DIM), atol=1e-4, rtol=0)
    with pytest.raises(ValueError):
        enc.linear_at(x, w, b, "tf32")
    _, hi = tok.apply(params, pts, cfg)
    _, hi2 = tok.apply(params, pts, cfg, mm="highest")
    _, lo = tok.apply(params, pts, cfg, mm="default")
    _, lo2 = tok.apply(params, pts, dataclasses.replace(cfg, precision="default"))
    assert torch.equal(hi, hi2) and torch.equal(lo, lo2) and lo.dtype == torch.float32
    assert not torch.equal(hi, lo)
    torch.testing.assert_close(lo, hi, atol=BF16_ATOL, rtol=BF16_RTOL)
    assert enc.FP32.mm == "highest" and enc.BF16.mm == "default"


# ---------------------------------------------------------------- classifier


def _cls_cfgs(**kw):
    jt, t = _tok_cfgs()
    jcfg = jpc.PointClassifierConfig(
        tokenizer=jt, encoder=jenc.EncoderConfig(dim=DIM, depth=DEPTH, num_heads=HEADS),
        num_classes=NCLS, **kw)
    cfg = pc.PointClassifierConfig(
        tokenizer=t, encoder=enc.EncoderConfig(dim=DIM, depth=DEPTH, num_heads=HEADS),
        num_classes=NCLS, **kw)
    return jcfg, cfg


def test_classifier_config_and_full_width_routes():
    a, b = jpc.PointClassifierConfig(), pc.PointClassifierConfig()
    assert dataclasses.asdict(a.head) == dataclasses.asdict(b.head)
    assert b.head.in_dim == 1536 and b.head.mlps == (512, 256) and not b.head.use_norm
    # 1024 points -> 256 groups + cls = 257 tokens: fused under BF16 in both packages
    assert enc._resolve_impl(b.encoder, 257, enc.BF16) == "fused"
    assert jenc._resolve_impl(a.encoder, 257, jenc.BF16) == "fused"
    # 2048 points -> 513 tokens: past the fused gate, into flash
    assert enc._resolve_impl(b.encoder, 513, enc.BF16) == "flash"
    assert jenc._resolve_impl(a.encoder, 513, jenc.BF16) == "flash"


@pytest.mark.parametrize("global_feat", ["cls,max", "cls,avg", "max"])
def test_classifier_forward_fp32_matches_jax(global_feat):
    jcfg, cfg = _cls_cfgs(global_feat=global_feat)
    np_params = _np(jpc.init(jcfg, jax.random.PRNGKey(0)))
    pts = _cloud(6, 2)
    want = jpc.forward(_jnp(np_params), jnp.asarray(pts), jcfg)
    with torch.no_grad():
        got = pc.forward(convert.from_numpy(np_params, "cpu"), torch.tensor(pts), cfg)
    assert got.shape == (2, NCLS) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FP32_ATOL)


def test_classifier_forward_with_features_matches_jax():
    jt, t = _tok_cfgs(in_channels=6)
    jcfg = dataclasses.replace(_cls_cfgs()[0], tokenizer=jt)
    cfg = dataclasses.replace(_cls_cfgs()[1], tokenizer=t)
    np_params = _np(jpc.init(jcfg, jax.random.PRNGKey(1)))
    pts, feats = _cloud(7, 2), _cloud(8, 2, c=6)
    want = jpc.forward(_jnp(np_params), jnp.asarray(pts), jcfg, jnp.asarray(feats))
    with torch.no_grad():
        got = pc.forward(convert.from_numpy(np_params, "cpu"), torch.tensor(pts), cfg,
                         torch.tensor(feats))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FP32_ATOL)


def test_classifier_forward_bf16_matches_jax_at_drift_bound():
    """BF16: the JAX side runs the fused Pallas sublayers in interpret mode
    and, on the CPU, its tokenizer in fp32; the port runs the plain versions
    and the tokenizer at "default" (bf16 operands). Logits are fp32."""
    jcfg, cfg = _cls_cfgs()
    np_params = _np(jpc.init(jcfg, jax.random.PRNGKey(2)))
    pts = _cloud(9, 2)
    want = jpc.forward(_jnp(np_params), jnp.asarray(pts), jcfg, precision=jenc.BF16)
    with torch.no_grad():
        got = pc.forward(convert.from_numpy(np_params, "cpu"), torch.tensor(pts), cfg,
                         precision=enc.BF16)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=BF16_ATOL, rtol=BF16_RTOL)


def test_classifier_head_dropout_draws_from_the_generator():
    _, cfg = _cls_cfgs()
    params = pc.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    pts = torch.tensor(_cloud(10, 2))
    with torch.no_grad():
        ev = pc.forward(params, pts, cfg)
        a = pc.forward(params, pts, cfg, train=True, generator=torch.Generator().manual_seed(1))
        b = pc.forward(params, pts, cfg, train=True, generator=torch.Generator().manual_seed(1))
        c = pc.forward(params, pts, cfg, train=True, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, ev)
    with pytest.raises(ValueError, match="Generator"):
        pc.forward(params, pts, cfg, train=True)


def test_point_classifier_module_holds_cast_params_on_its_device():
    _, cfg = _cls_cfgs()
    params = pc.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    model = pc.PointClassifier(cfg, params, precision=enc.BF16, device="cpu")
    tree = model.params()
    assert tree["encoder"]["qkv_w"].dtype == torch.bfloat16
    assert tree["encoder"]["norm1_scale"].dtype == torch.float32
    assert tree["tokenizer"]["w0"].dtype == torch.float32
    assert set(tree) == set(params) and set(tree["head"]) == set(params["head"])
    pts = torch.tensor(_cloud(11, 3))
    got = model(pts)
    assert got.shape == (3, NCLS) and not got.requires_grad
    torch.testing.assert_close(got, pc.forward(params, pts, cfg, precision=enc.BF16).detach(),
                               rtol=0, atol=0)
    with pytest.raises(RuntimeError, match="CUDA card"):
        pc.init(cfg, torch.Generator().manual_seed(0))  # no device named: the card
    with pytest.raises(RuntimeError, match="CUDA card"):
        pc.PointClassifier(cfg, params)


def test_convert_round_trips_the_nested_point_trees():
    jcfg = jmae.MaskedPointViTConfig(dim=64, depth=1, num_heads=1, decoder_dim=64,
                                     decoder_depth=1, decoder_heads=1, group_size=K)
    np_params = _np(jmae.init(jcfg, jax.random.PRNGKey(0)))
    tree = convert.from_numpy(np_params, "cpu", requires_grad=True)
    assert set(tree["pos_mlp"]) == {"w1", "b1", "w2", "b2"}
    assert tree["decoder_embed"]["w"].requires_grad and tree["tokenizer"]["w0"].is_leaf
    back = convert.to_numpy(tree)
    flat, flat_back = dict(leaves_with_path(np_params)), dict(
        leaves_with_path(back))
    assert set(flat) == set(flat_back)
    for path, leaf in flat.items():
        np.testing.assert_array_equal(flat_back[path], leaf)


# ----------------------------------------------------------------- segmenter


def _seg_cfgs():
    jt, t = _tok_cfgs()
    kw = dict(num_classes=NCLS, head_hidden=32)
    return (
        jps.PointSegmenterConfig(
            tokenizer=jt, encoder=jenc.EncoderConfig(dim=DIM, depth=DEPTH, num_heads=HEADS), **kw),
        ps.PointSegmenterConfig(
            tokenizer=t, encoder=enc.EncoderConfig(dim=DIM, depth=DEPTH, num_heads=HEADS), **kw),
    )


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_segmenter_forward_matches_jax(precision):
    jcfg, cfg = _seg_cfgs()
    np_params = _np(jps.init(jcfg, jax.random.PRNGKey(3)))
    pts = _cloud(12, 2)
    jprec, prec = (jenc.FP32, enc.FP32) if precision == "fp32" else (jenc.BF16, enc.BF16)
    want = jps.forward(_jnp(np_params), jnp.asarray(pts), jcfg, precision=jprec)
    with torch.no_grad():
        got = ps.forward(convert.from_numpy(np_params, "cpu"), torch.tensor(pts), cfg,
                         precision=prec)
    assert got.shape == (2, N, NCLS) and got.dtype == torch.float32
    if precision == "fp32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FP32_ATOL)
    else:
        np.testing.assert_allclose(
            got.numpy(), np.asarray(want, np.float32), atol=BF16_ATOL, rtol=BF16_RTOL)


def test_segmenter_init_and_module():
    _, cfg = _seg_cfgs()
    params = ps.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert params["head_w0"].shape == (DIM + 3, 32) and params["head_w1"].shape == (32, NCLS)
    assert "head" not in params
    model = ps.PointSegmenter(cfg, params, precision=enc.FP32, device="cpu")
    pts = torch.tensor(_cloud(13, 1))
    torch.testing.assert_close(model(pts), ps.forward(params, pts, cfg).detach(), rtol=0, atol=0)
    assert ps.PointSegmenterConfig().num_classes == 13


# ------------------------------------------------------------ masked point ViT


def _mae_cfgs():
    kw = dict(dim=DIM, depth=DEPTH, num_heads=HEADS, decoder_dim=64, decoder_depth=1,
              decoder_heads=2, sample_ratio=0.125, group_size=K)
    return jmae.MaskedPointViTConfig(**kw), mae.MaskedPointViTConfig(**kw)


def test_point_mae_config_matches_jax():
    a, b = jmae.MaskedPointViTConfig(), mae.MaskedPointViTConfig()
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert dataclasses.asdict(a.tokenizer) == dataclasses.asdict(b.tokenizer)
    assert (b.encoder.dim, b.encoder.num_heads, b.decoder.dim, b.decoder.num_heads) == (
        384, 6, 192, 16)
    # 16 visible of 64 groups: both stacks materialise their attention under FP32
    assert enc._resolve_impl(b.encoder, 17, enc.FP32) == "xla"
    assert enc._resolve_impl(b.decoder, 65, enc.FP32) == "xla"


def test_point_mae_loss_matches_jax_with_shared_shuffle():
    """JAX draws the masking noise inside forward; the same key gives the
    shuffle, which goes to the port's forward_at."""
    jcfg, cfg = _mae_cfgs()
    np_params = _np(jmae.init(jcfg, jax.random.PRNGKey(0)))
    pts = _cloud(14, 3)
    key = jax.random.PRNGKey(5)
    shuffle = np.asarray(jnp.argsort(jax.random.uniform(key, (3, 16)), axis=1))
    want, want_pred = jmae.forward(_jnp(np_params), jnp.asarray(pts), key, jcfg)

    params = convert.from_numpy(np_params, "cpu", requires_grad=True)
    loss, pred = mae.forward_at(params, torch.tensor(pts), torch.tensor(shuffle).long(), cfg)
    assert pred.shape == (3, 16, K * 3)
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-4)
    np.testing.assert_allclose(pred.detach().numpy(), np.asarray(want_pred), atol=FP32_ATOL)
    loss.backward()  # every leaf takes a gradient
    for path, leaf in leaves_with_path(params):
        assert leaf.grad is not None and torch.isfinite(leaf.grad).all(), path
    # drawing from a generator gives a loss of the same kind, repeatably
    with torch.no_grad():
        a, _ = mae.forward(params, torch.tensor(pts), torch.Generator().manual_seed(0), cfg)
        b, _ = mae.forward(params, torch.tensor(pts), torch.Generator().manual_seed(0), cfg)
    assert a.dim() == 0 and torch.isfinite(a) and torch.equal(a, b)


def test_point_mae_pos_mlp_is_tanh_gelu_and_classifier_pos_mlp_is_erf():
    """The reference's masked model calls jax.nn.gelu with its default (the
    tanh form); its classifier asks for the exact form. The port follows each."""
    jcfg, _ = _mae_cfgs()
    p = _np(jmae.init(jcfg, jax.random.PRNGKey(1)))["pos_mlp"]
    xyz = 2.0 * _cloud(15, 2, 16)
    got = mae._pos_mlp(convert.from_numpy(p, "cpu"), torch.tensor(xyz)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmae._pos_mlp(_jnp(p), jnp.asarray(xyz))), atol=1e-5)
    erf = (torch.nn.functional.gelu(torch.tensor(xyz @ p["w1"] + p["b1"])) @ torch.tensor(p["w2"])
           + torch.tensor(p["b2"])).numpy()
    assert np.abs(got - erf).max() > 1e-4  # the two forms do differ at this scale

    jc, _ = _cls_cfgs()
    q = _np(jpc.init(jc, jax.random.PRNGKey(2)))
    want = jpc._pos_mlp(_jnp(q), jnp.asarray(xyz), jax.lax.Precision.HIGHEST)
    got = pc._pos_mlp(convert.from_numpy(q, "cpu"), torch.tensor(xyz)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)


# ------------------------------------------------------------------ training


def _step_both(track, jprec, prec, tx, spec, steps):
    jcfg, cfg = _cls_cfgs(head_dropout=0.0)
    np_params = _np(jpc.init(jcfg, jax.random.PRNGKey(3)))
    pts = _cloud(16, 4)
    labels = (np.arange(4) % NCLS).astype(np.int64)
    frozen_keys = jstep.FROZEN_KEYS if track == "frozen" else ()

    jtr, jfr = jstep.split_params(_jnp(np_params), frozen_keys)
    jstep_fn = jax.jit(jstep.make_train_step(
        lambda p, x, r: jpc.forward(p, x, jcfg, precision=jprec, train=True), tx))
    opt_state = tx.init(jtr)

    tr_np, fr_np = step_lib.split_params(np_params, frozen_keys)
    tr = convert.from_numpy(tr_np, "cpu", requires_grad=True)
    fr = convert.from_numpy(fr_np, "cpu")
    step_fn = step_lib.make_train_step(
        lambda p, x, g: pc.forward(p, x, cfg, precision=prec, train=True, generator=g),
        spec.init(tr))
    losses = []
    for _ in range(steps):
        jtr, opt_state, jm = jstep_fn(
            jtr, jfr, opt_state,
            {"input": jnp.asarray(pts), "label": jnp.asarray(labels.astype(np.int32))}, None)
        m = step_fn(tr, fr, {"input": torch.tensor(pts), "label": torch.tensor(labels)})
        losses.append((m["loss"].item(), float(jm["loss"])))
    return losses, tr, fr, _np(jtr), fr_np


@pytest.mark.parametrize("track", ["frozen", "full"])
def test_point_train_step_fp32_matches_jax_step(track):
    """One SGD step under FP32: the loss and every updated leaf against the
    JAX step. (SGD is linear in the gradient; Adam's first update is
    g / |g|, which cannot show that two gradients agree.) The frozen track
    trains tokenizer, positional MLP, cls token and position, final
    LayerNorm and head."""
    losses, tr, fr, jtr, fr_np = _step_both(
        track, jenc.FP32, enc.FP32, joptim.make_optimizer("sgd", lr=0.1),
        optim.make_optimizer("sgd", lr=0.1), 1)
    assert abs(losses[0][0] - losses[0][1]) <= 1e-4
    got = dict(leaves_with_path(tr))
    want = dict(leaves_with_path(jtr))
    assert set(got) == set(want)
    assert (("encoder", "qkv_w") in got) == (track == "full")
    for name in ("cls_token", "cls_pos", "posmlp_w0", "norm_scale"):
        assert (name,) in got
    assert ("tokenizer", "w0") in got and ("head", "w2") in got
    for path, leaf in got.items():
        np.testing.assert_allclose(
            leaf.detach().numpy(), want[path], rtol=1e-4, atol=2e-5, err_msg="/".join(path))
    for k, v in fr.get("encoder", {}).items():  # frozen leaves: untouched, no grad
        np.testing.assert_array_equal(v.numpy(), fr_np["encoder"][k])
        assert v.grad is None


def test_point_train_bf16_adamw_losses_match_jax():
    """Three AdamW steps of the full track under BF16, per-step losses
    within 0.05. The rate is 1e-4: at 1e-3 the loss of four fixed clouds
    swings in both packages (1.67, 2.15, 1.6), which amplifies the bf16
    difference between them instead of measuring it."""
    losses, tr, *_ = _step_both(
        "full", jenc.BF16, enc.BF16, optax.adamw(1e-4, weight_decay=0.05),
        optim.make_optimizer("adamw", lr=1e-4, weight_decay=0.05), 3)
    for got, want in losses:
        assert np.isfinite(got) and abs(got - want) <= 0.05
    assert all(b[0] < a[0] for a, b in zip(losses, losses[1:]))
    assert tr["encoder"]["qkv_w"].dtype == torch.float32
