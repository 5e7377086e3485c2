"""The port's Mask2Former (heads/mask2former.py), matching (ops/matching.py),
MaskFormer head (heads/maskformer.py), the Mask2Former segmentor
(models/segmentor.py) against the JAX package on the CPU, FP32, at the JAX
recipes' smoke geometry (32
channels, 8 queries, 1 encoder layer; the head alone also with 3 decoder
layers, so that the decoder cycles through all three levels).

Every parameter tree is perturbed with seeded noise before it is carried
across. The random points of the losses are JAX's own draws, reproduced from
its key by the reference's split sequence and passed in (``draws``).

Tolerances: the head's ``all_cls`` / ``all_masks`` 1e-4, after the attention
masks are found equal; the assignment exactly; ``loss`` relative 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metatransformer_tpu.heads import mask2former as jm2f
from metatransformer_tpu.heads import maskformer as jmaskformer
from metatransformer_tpu.models import segmentor as jseg
from metatransformer_tpu.models import time_series as jts
from metatransformer_tpu.ops import matching as jmatching
from metatransformer_tpu_torch.core import convert
from metatransformer_tpu_torch.heads import mask2former as m2f
from metatransformer_tpu_torch.heads import maskformer
from metatransformer_tpu_torch.models import segmentor
from metatransformer_tpu_torch.models import time_series
from metatransformer_tpu_torch.ops import matching
from tests.test_torch_vit_adapter import close, images, perturb, smoke_adapter

torch.set_num_threads(1)
TOL = 1e-4
CLASSES = 7


def _host_lsa_on_host_arrays(cost, valid):
    """The reference's ``_host_lsa`` on numpy copies of its arguments. On
    this JAX a ``pure_callback`` hands its function ``jax.Array``s, and
    ``_host_lsa`` indexes them: each index is a JAX dispatch from inside the
    running callback, which can deadlock when the host is loaded. The
    arrays become host arrays first; the assignment is the same."""
    return _HOST_LSA(np.asarray(cost), np.asarray(valid))


_HOST_LSA = jm2f._host_lsa


@pytest.fixture(scope="module", autouse=True)
def host_lsa_on_host_arrays():
    """Every call of the reference's ``match`` in the module runs
    :func:`_host_lsa_on_host_arrays`. ``pure_callback`` reads ``_host_lsa``
    when it traces, so the patch is in place before the module's first trace
    and the jit caches are cleared on both sides of it: no program traced
    before (another module in the same worker) is reused."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jm2f, "_host_lsa", _host_lsa_on_host_arrays)
        jax.clear_caches()
        yield
    jax.clear_caches()


def head_cfgs(decoder_layers=3):
    """(JAX, port) Mask2Former configs of the smoke segmentor (dim 32)."""
    kw = dict(num_classes=CLASSES, head_channels=32, num_queries=8,
              num_decoder_layers=decoder_layers, num_encoder_layers=1, num_heads=4)
    return (jseg.Mask2FormerSegmentorConfig(backbone=smoke_adapter(True), **kw),
            segmentor.Mask2FormerSegmentorConfig(backbone=smoke_adapter(False), **kw))


def pyramid(b=2, c=32, seed=8):
    """Random NHWC features at 1/4 ... 1/32 of a 64 px image."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, s, c)).astype(np.float32) for s in (16, 8, 4, 2)]


def jax_loss_draws(key, n_layers, b, g, num_points, cfg):
    """The uniforms ``jm2f.loss`` draws from ``key``, by its split sequence:
    per layer the match points [B, 1, P, 2] and the oversampled and fill
    uniforms of ``uncertain_point_coords``."""
    p_match = num_points or min(cfg.num_points, 2048)
    p = num_points or cfg.num_points
    n_unc = int(cfg.importance_sample_ratio * p)
    draws, rng = [], key
    for _ in range(n_layers):
        rng, k1, k2 = jax.random.split(rng, 3)
        ka, kb = jax.random.split(k2)
        layer = (jax.random.uniform(k1, (b, 1, p_match, 2)),
                 jax.random.uniform(ka, (b * g, int(p * cfg.oversample_ratio), 2)),
                 jax.random.uniform(kb, (b * g, p - n_unc, 2)) if p - n_unc else None)
        draws.append(tuple(None if a is None else torch.tensor(np.asarray(a)) for a in layer))
    return draws


def targets(b=2, g=3, hw=16, seed=9):
    """Padded gt: labels [B, G], masks [B, G, hw, hw] of rectangles, the
    last slot of the last image invalid."""
    rng = np.random.default_rng(seed)
    masks = np.zeros((b, g, hw, hw), np.float32)
    for i in range(b):
        for j in range(g):
            y0, x0 = rng.integers(0, hw // 2, 2)
            masks[i, j, y0: y0 + hw // 2, x0: x0 + hw // 2] = 1.0
    valid = np.ones((b, g), bool)
    valid[-1, -1] = False
    return rng.integers(0, CLASSES, (b, g)).astype(np.int32), masks, valid


# --------------------------------------------------------------------------
# The head
# --------------------------------------------------------------------------


def test_sine_positional_encoding_matches():
    want = jm2f.sine_positional_encoding(5, 7, 16)
    close(m2f.sine_positional_encoding(5, 7, 16), want, 1e-6)


def test_pixel_decoder_matches():
    jcfg, cfg = head_cfgs()
    params = perturb(jm2f.pixel_decoder_init(jcfg.head.pixel_decoder, jax.random.PRNGKey(1)),
                     seed=1)
    feats = pyramid()
    want_mf, want_ms = jm2f.pixel_decoder_apply(
        jax.tree.map(jnp.asarray, params), [jnp.asarray(f) for f in feats],
        jcfg.head.pixel_decoder)
    got_mf, got_ms = m2f.pixel_decoder_apply(convert.from_numpy(params, "cpu"),
                                             [torch.tensor(f) for f in feats],
                                             cfg.head.pixel_decoder)
    close(got_mf, want_mf, TOL, "mask feature")
    for i, (g, w) in enumerate(zip(got_ms, want_ms)):
        close(g, w, TOL, f"level {i}")


@pytest.fixture(scope="module")
def head_run():
    """(port config, numpy params, feats, JAX all_cls, all_masks, masks)."""
    jcfg, cfg = head_cfgs()
    params = perturb(jm2f.init(jcfg.head, jax.random.PRNGKey(2)), seed=2)
    feats = pyramid()
    masks = []
    orig = jm2f._forward_head

    def forward_head(*a):
        out = orig(*a)
        masks.append(np.asarray(out[2]))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jm2f, "_forward_head", forward_head)
        all_cls, all_masks = jm2f.apply(jax.tree.map(jnp.asarray, params),
                                        [jnp.asarray(f) for f in feats], jcfg.head)
    return cfg, params, feats, np.asarray(all_cls), np.asarray(all_masks), masks


def test_head_matches_jax_with_its_attention_masks(head_run, monkeypatch):
    cfg, params, feats, want_cls, want_masks, want_am = head_run
    got_am = []
    orig = m2f.attention_mask
    monkeypatch.setattr(m2f, "attention_mask",
                        lambda *a: got_am.append(orig(*a)) or got_am[-1])
    tree = convert.from_numpy(params, "cpu")
    assert isinstance(tree["layers"], list) and len(tree["layers"]) == 3
    all_cls, all_masks = m2f.apply(tree, [torch.tensor(f) for f in feats], cfg.head)
    assert len(got_am) == len(want_am) == 4
    for i, (g, w) in enumerate(zip(got_am, want_am)):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"attention mask {i}")
    assert any(w.any() and not w.all() for w in want_am)  # the masks mask something
    close(all_cls, want_cls, TOL, "all_cls")
    close(all_masks, want_masks, TOL, "all_masks")
    want_sem = jm2f.semantic_inference(jnp.asarray(want_cls[-1]), jnp.asarray(want_masks[-1]))
    close(m2f.semantic_inference(all_cls[-1], all_masks[-1]), want_sem, TOL, "semantic")


def test_head_tree_matches_and_every_leaf_gets_a_gradient(head_run):
    cfg, params, feats, *_ = head_run
    fresh = m2f.init(cfg.head, torch.Generator().manual_seed(0), "cpu")
    shapes = lambda t: jax.tree.map(lambda a: tuple(np.shape(a)), t)  # noqa: E731
    assert shapes(convert.to_numpy(fresh)) == shapes(params)
    tree = convert.from_numpy(params, "cpu", requires_grad=True)
    all_cls, all_masks = m2f.apply(tree, [torch.tensor(f) for f in feats], cfg.head)
    (all_cls.square().mean() + all_masks.square().mean()).backward()
    missing = [p for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]
               if leaf.grad is None or not torch.isfinite(leaf.grad).all()]
    assert not missing, missing


def test_an_all_masked_query_attends_everywhere():
    mask = torch.full((1, 2, 8, 8), -5.0)  # query 0 below 0.5 everywhere
    mask[0, 1, :4] = 5.0
    am = m2f.attention_mask(mask, (4, 4))
    assert not am[0, 0].any()
    assert am[0, 1].sum() == 8


# --------------------------------------------------------------------------
# Point sampling, matching and the losses
# --------------------------------------------------------------------------


def test_point_sample_and_uncertain_points_match():
    rng = np.random.default_rng(10)
    logits = rng.standard_normal((4, 8, 8)).astype(np.float32) * 3
    key = jax.random.PRNGKey(11)
    want = jm2f.uncertain_point_coords(jnp.asarray(logits), 16, 3.0, 0.75, key)
    ka, kb = jax.random.split(key)
    draws = tuple(torch.tensor(np.asarray(jax.random.uniform(k, s)))
                  for k, s in ((ka, (4, 48, 2)), (kb, (4, 4, 2))))
    got = m2f.uncertain_point_coords(torch.tensor(logits), 16, 3.0, 0.75, draws=draws)
    close(got, want, 1e-6, "points")
    close(m2f.point_sample(torch.tensor(logits), got),
          jm2f.point_sample(jnp.asarray(logits), want), 1e-5, "sampled")


def predictions():
    """Per-layer class and mask logits of 4 layers, b = 2, 8 queries."""
    rng = np.random.default_rng(12)
    return (rng.standard_normal((4, 2, 8, CLASSES + 1)).astype(np.float32) * 2,
            rng.standard_normal((4, 2, 8, 16, 16)).astype(np.float32) * 3)


@pytest.fixture(scope="module")
def loss_inputs():
    return (*predictions(), *targets())


def test_match_equals_jax_assignment(loss_inputs):
    all_cls, all_masks, labels, masks, valid = loss_inputs
    _, cfg = head_cfgs()
    jcfg = jm2f.Mask2FormerConfig(num_classes=CLASSES, num_queries=8)
    key = jax.random.PRNGKey(13)
    for li in range(all_cls.shape[0]):
        want = jm2f.match(jnp.asarray(all_cls[li]), jnp.asarray(all_masks[li]),
                          jnp.asarray(labels), jnp.asarray(masks), jnp.asarray(valid), jcfg,
                          key, num_match_points=64)
        coords = torch.tensor(np.asarray(jax.random.uniform(key, (2, 1, 64, 2))))
        got = m2f.match(torch.tensor(all_cls[li]), torch.tensor(all_masks[li]),
                        torch.tensor(labels), torch.tensor(masks), torch.tensor(valid),
                        cfg.head, num_match_points=64, coords=coords)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"layer {li}")
        assert (got.numpy()[~valid] == -1).all()


def test_loss_matches_jax_on_its_draws(loss_inputs):
    all_cls, all_masks, labels, masks, valid = loss_inputs
    _, cfg = head_cfgs()
    jcfg = jm2f.Mask2FormerConfig(num_classes=CLASSES, num_queries=8)
    key = jax.random.PRNGKey(14)
    want, want_logs = jm2f.loss(jnp.asarray(all_cls), jnp.asarray(all_masks), labels, masks,
                                valid, jcfg, key, num_points=32)
    draws = jax_loss_draws(key, all_cls.shape[0], 2, 3, 32, jcfg)
    got, logs = m2f.loss(torch.tensor(all_cls), torch.tensor(all_masks), labels, masks, valid,
                         cfg.head, num_points=32, draws=draws)
    assert set(logs) == set(want_logs)
    for k in want_logs:
        np.testing.assert_allclose(logs[k].item(), float(want_logs[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


def test_loss_draws_from_a_generator_and_trains():
    """Without draws the points come from the generator: seeded, repeatable,
    and the loss has a gradient for every prediction."""
    all_cls, all_masks = predictions()
    labels, masks, valid = targets()
    _, cfg = head_cfgs()
    cls = torch.tensor(all_cls, requires_grad=True)
    mk = torch.tensor(all_masks, requires_grad=True)
    runs = [m2f.loss(cls, mk, labels, masks, valid, cfg.head,
                     torch.Generator().manual_seed(0), num_points=32)[0] for _ in range(2)]
    assert runs[0].item() == runs[1].item() and np.isfinite(runs[0].item())
    runs[0].backward()
    assert cls.grad.abs().sum() > 0 and mk.grad.abs().sum() > 0


def test_scatter_rows_drops_invalid_slots():
    dest = torch.full((2, 4), 9)
    idx = torch.tensor([[1, 3], [0, 0]])
    upd = torch.tensor([[5, 6], [7, 8]])
    valid = torch.tensor([[True, True], [True, False]])
    want = jm2f._scatter_rows(jnp.asarray(dest.numpy()), jnp.asarray(idx.numpy()),
                              jnp.asarray(upd.numpy()), jnp.asarray(valid.numpy()))
    np.testing.assert_array_equal(m2f._scatter_rows(dest, idx, upd, valid).numpy(), want)


def test_matching_costs_and_assignments_match():
    rng = np.random.default_rng(15)
    logits = rng.standard_normal((6, 5)).astype(np.float32)
    labels = np.array([0, 3, 3, 1])
    pred = rng.standard_normal((6, 20)).astype(np.float32)
    gt = (rng.uniform(size=(4, 20)) > 0.5).astype(np.float32)
    boxes_p, boxes_g = (rng.uniform(size=(n, 4)).astype(np.float32) for n in (6, 4))
    t = torch.tensor
    close(matching.classification_cost(t(logits), t(labels)),
          jmatching.classification_cost(jnp.asarray(logits), jnp.asarray(labels)), 1e-6)
    close(matching.bbox_l1_cost(t(boxes_p), t(boxes_g)),
          jmatching.bbox_l1_cost(jnp.asarray(boxes_p), jnp.asarray(boxes_g)), 1e-6)
    close(matching.focal_mask_cost(t(pred), t(gt)),
          jmatching.focal_mask_cost(jnp.asarray(pred), jnp.asarray(gt)), 1e-5)
    close(matching.dice_cost(t(pred), t(gt)),
          jmatching.dice_cost(jnp.asarray(pred), jnp.asarray(gt)), 1e-6)
    cost = rng.standard_normal((6, 4)).astype(np.float32)
    for got, want in zip(matching.hungarian_assign(t(cost)), jmatching.hungarian_assign(cost)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(matching.greedy_assign(t(cost)),
                         jmatching.greedy_assign(jnp.asarray(cost))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------------------
# The compact MaskFormer head
# --------------------------------------------------------------------------


def test_maskformer_head_matches():
    dec = dict(dim=32, d_ff=64, num_heads=4, depth=2)
    jcfg = jmaskformer.MaskFormerConfig(in_dim=24, num_queries=6, num_classes=CLASSES,
                                        decoder=jts.DecoderConfig(**dec), mask_dim=16)
    cfg = maskformer.MaskFormerConfig(in_dim=24, num_queries=6, num_classes=CLASSES,
                                      decoder=time_series.DecoderConfig(**dec), mask_dim=16)
    params = perturb(jmaskformer.init(jcfg, jax.random.PRNGKey(16)), seed=16)
    x = np.random.default_rng(17).standard_normal((2, 5, 6, 24)).astype(np.float32)
    want_cls, want_masks = jmaskformer.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x),
                                             jcfg)
    got_cls, got_masks = maskformer.apply(convert.from_numpy(params, "cpu"), torch.tensor(x), cfg)
    close(got_cls, want_cls, TOL, "cls")
    close(got_masks, want_masks, TOL, "masks")
    close(maskformer.semantic_inference(got_cls, got_masks),
          jmaskformer.semantic_inference(want_cls, want_masks), TOL, "semantic")
    fresh = maskformer.init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert jax.tree.map(np.shape, convert.to_numpy(fresh)) == jax.tree.map(np.shape, params)


# --------------------------------------------------------------------------
# The segmentor
# --------------------------------------------------------------------------


def test_mask2former_segmentor_matches_jax():
    jcfg, cfg = head_cfgs(decoder_layers=1)
    params = perturb(jseg.init_mask2former(jcfg, jax.random.PRNGKey(3)), seed=3)
    x = images()
    want_cls, want_masks = jseg.forward_mask2former(jax.tree.map(jnp.asarray, params),
                                                    jnp.asarray(x), jcfg)
    got_cls, got_masks = segmentor.forward_mask2former(convert.from_numpy(params, "cpu"),
                                                       torch.tensor(x), cfg)
    assert tuple(got_masks.shape) == (2, 2, 8, 16, 16)
    close(got_cls, want_cls, TOL, "all_cls")
    close(got_masks, want_masks, TOL, "all_masks")
    want = jseg.mask2former_semantic(want_cls, want_masks, (64, 64))
    close(segmentor.mask2former_semantic(got_cls, got_masks, (64, 64)), want, TOL, "semantic")
