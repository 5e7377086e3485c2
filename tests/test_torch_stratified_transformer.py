"""The port's Stratified Transformer (models/stratified_transformer.py)
against the JAX package on the CPU, FP32, at the recipe's smoke geometry
(tests/point_seg_parity.py): logits, every gradient leaf, the FPS indices
(TransitionDown and the stratified keys) and the init's shapes.

Also the port's choices one by one: the cRPE bias as a gather equals the
reference's one-hot form exactly (each one-hot product has one non-zero
term); the window masks (``window_masks``) and the cRPE index
(``crpe_index``) equal the reference's; the tanh GELU and the -1e9 fill.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from metatransformer_tpu.models import stratified_transformer as jst
from metatransformer_tpu_torch.models import stratified_transformer as st
from tests import point_seg_parity as psp

torch.set_num_threads(1)
SMOKE = dict(num_classes=psp.NUM_CLASSES, in_channels=3, channels=(8, 8, 16), depths=(1, 1, 2),
             num_heads=(1, 2, 2), k=8, n_kernel_pts=5)
CFG, JCFG = st.StratifiedConfig(**SMOKE), jst.StratifiedConfig(**SMOKE)


def run():
    return psp.seg_pair(jst, st, CFG, JCFG)


def test_forward_matches_jax():
    psp.check_forward(st, CFG, run())


def test_gradients_match_jax():
    psp.check_gradients(st, CFG, run())


def test_init_tree_has_jax_keys_and_shapes():
    psp.check_tree(st, CFG, run())


def test_fps_draws_index_equal():
    """TransitionDown 64 -> 16, then a stage's stratified keys and its
    TransitionDown, the last stage's keys alone."""
    assert [(p.shape[1], n) for p, n, _ in run()["calls"]] == [(64, 16), (16, 4), (16, 4), (4, 1)]


def onehot_bias(q, k, rel_q, rel_k, idx):
    """The reference's cRPE: one-hot einsums over the table axis, [B, H, N, M]."""
    l2 = rel_q.shape[0]
    qdot = torch.einsum("bnhd,lhda->bnhla", q, rel_q)
    kdot = torch.einsum("bmhd,lhda->bmhla", k, rel_k)
    bias = 0
    for a in range(3):
        oh = F.one_hot(idx[..., a], l2).to(q.dtype)
        bias = bias + torch.einsum("bnhl,bnml->bhnm", qdot[..., a], oh)
        bias = bias + torch.einsum("bmhl,bnml->bhnm", kdot[..., a], oh)
    return bias


@pytest.mark.parametrize("heads, n", [(2, 24), (3, 40)])
def test_gathered_crpe_equals_the_one_hot_form(heads, n):
    rng = np.random.default_rng(heads)
    l2 = 2 * CFG.quant_len
    q, k = (torch.tensor(rng.standard_normal((2, n, heads, 4)), dtype=torch.float32)
            for _ in range(2))
    rel_q, rel_k = (torch.tensor(rng.standard_normal((l2, heads, 4, 3)), dtype=torch.float32)
                    for _ in range(2))
    xyz = torch.tensor(rng.uniform(0, 0.3, (2, n, 3)), dtype=torch.float32)
    idx = st.crpe_index(xyz, CFG.window_size, CFG.quant_size, l2)
    assert idx.min() >= 0 and idx.max() < l2 and len(idx.unique()) > 4
    got = st.crpe_bias(q, k, rel_q, rel_k, idx)
    assert torch.equal(got, onehot_bias(q, k, rel_q, rel_k, idx))


@pytest.mark.parametrize("shifted", [False, True])
def test_window_masks_and_crpe_index_equal_jax(shifted):
    pts = psp.cloud(11, n=48) * 0.4
    b, n = pts.shape[:2]
    down = np.zeros((b, n), bool)
    down[:, ::4] = True
    ws, quant, l2 = CFG.window_size, CFG.quant_size, 2 * CFG.quant_len
    want = np.asarray(jst._window_masks(jnp.asarray(pts), ws, shifted, jnp.asarray(down)))
    got = st.window_masks(torch.tensor(pts), ws, shifted, torch.tensor(down))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.mean() < 1
    # the reference's index lines (its _window_attention), on the same points
    rel = jnp.asarray(pts)[:, :, None, :] - jnp.asarray(pts)[:, None, :, :]
    rel = jnp.round(rel * 1e5) / 1e5
    jidx = jnp.clip(jnp.floor((rel + 2.0 * ws - 1e-4) / quant), 0, l2 - 1).astype(jnp.int32)
    np.testing.assert_array_equal(st.crpe_index(torch.tensor(pts), ws, quant, l2).numpy(),
                                  np.asarray(jidx))


def test_gelu_is_tanh_and_masked_logits_are_filled_with_minus_1e9():
    x = torch.linspace(-3, 3, 13)
    np.testing.assert_allclose(st._gelu(x).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x.numpy()))), rtol=1e-6,
                               atol=1e-7)
    # one query allowed only itself: its weights are exactly one-hot
    p = {"qkv": {"w": torch.randn(4, 12), "b": torch.zeros(12)},
         "proj": {"w": torch.eye(4), "b": torch.zeros(4)},
         "rel_q": torch.zeros(16, 1, 4, 3), "rel_k": torch.zeros(16, 1, 4, 3)}
    feats = torch.randn(1, 5, 4)
    allowed = torch.eye(5, dtype=torch.bool)[None]
    out = st._window_attention(p, feats, allowed, torch.zeros(1, 5, 5, 3, dtype=torch.long), 1)
    np.testing.assert_allclose(out.numpy(), (feats @ p["qkv"]["w"][:, 8:]).numpy(), rtol=1e-6)


def test_init_takes_the_card_or_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        st.init(CFG, torch.Generator().manual_seed(0))
