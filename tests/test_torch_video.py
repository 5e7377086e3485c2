"""The video slice of the PyTorch port vs the JAX reference: tokenizer,
positional table, classifier forward, multi-view aggregation, one training
step of each track, and the video-MAE loss.

Inputs come from seeded numpy and weights travel JAX -> numpy ->
``convert.from_numpy``. Sizes are small (8 frames of 64^2, tubelet 2, patch
16: 64 tokens; dim 128, 2 heads of 64, 3 layers) with ``attn_impl="flash"``
forced, plus one case that crosses T = 512 under "auto". On the JAX side
flash attention is the Pallas kernel in interpret mode; on the port's side
it is the plain version, which is what a CPU tensor runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from metatransformer_tpu.core import encoder as jenc
from metatransformer_tpu.models import video_classifier as jvc
from metatransformer_tpu.models import video_eval as jve
from metatransformer_tpu.models import video_pretrain as jvp
from metatransformer_tpu.tokenizers import video as jtok
from metatransformer_tpu.train import optim as joptim
from metatransformer_tpu.train import step as jstep
from metatransformer_tpu_torch.core import convert, encoder as enc
from metatransformer_tpu_torch.core.tree import leaves_with_path
from metatransformer_tpu_torch.models import video_classifier as vc
from metatransformer_tpu_torch.models import video_eval as ve
from metatransformer_tpu_torch.models import video_pretrain as vp
from metatransformer_tpu_torch.tokenizers import video as tok
from metatransformer_tpu_torch.train import optim
from metatransformer_tpu_torch.train import step as step_lib

torch.set_num_threads(1)

FRAMES, IMG, PATCH, TUBE, DIM, DEPTH, HEADS, NCLS = 8, 64, 16, 2, 128, 3, 2, 7
TOK_ARGS = (FRAMES, IMG, PATCH, TUBE, 3, DIM)


def _cfgs(pos_embed="sincos", impl="flash", depth=DEPTH, tok_args=TOK_ARGS):
    jcfg = jvc.VideoClassifierConfig(
        tokenizer=jtok.VideoTokenizerConfig(*tok_args),
        encoder=jenc.EncoderConfig(dim=DIM, depth=depth, num_heads=HEADS, attn_impl=impl),
        num_classes=NCLS, pos_embed=pos_embed,
    )
    cfg = vc.VideoClassifierConfig(
        tokenizer=tok.VideoTokenizerConfig(*tok_args),
        encoder=enc.EncoderConfig(dim=DIM, depth=depth, num_heads=HEADS, attn_impl=impl),
        num_classes=NCLS, pos_embed=pos_embed,
    )
    return jcfg, cfg


def _np_params(jcfg, seed=0):
    return jax.tree.map(np.asarray, jvc.init(jcfg, jax.random.PRNGKey(seed)))


def _clips(seed, b, tok_args=TOK_ARGS, uint8=False):
    rng = np.random.default_rng(seed)
    shape = (b, tok_args[0], tok_args[1], tok_args[1], 3)
    if uint8:
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return rng.standard_normal(shape).astype(np.float32)


# ----------------------------------------------------------------- tokenizer


def test_tokenizer_config_matches_jax():
    a, b = jtok.VideoTokenizerConfig(), tok.VideoTokenizerConfig()
    for name in ("grid", "t_patches", "num_patches", "patch_dim"):
        assert getattr(a, name) == getattr(b, name)
    assert b.num_patches == 1568 and b.patch_dim == 1536


def test_tubelets_order_matches_jax():
    x = np.arange(2 * 4 * 8 * 12 * 3, dtype=np.float32).reshape(2, 4, 8, 12, 3)
    got = tok.tubelets(torch.tensor(x), 2, 4).numpy()
    np.testing.assert_array_equal(got, np.asarray(jtok.tubelets(jnp.asarray(x), 2, 4)))
    assert got.shape == (2, 2 * 2 * 3, 2 * 4 * 4 * 3)


@pytest.mark.parametrize("uint8", [False, True], ids=["float", "uint8"])
def test_tokenizer_apply_matches_jax(uint8):
    jcfg, cfg = _cfgs()
    np_params = _np_params(jcfg)["tokenizer"]
    clips = _clips(1, 2, uint8=uint8)
    want = np.asarray(jtok.apply(jax.tree.map(jnp.asarray, np_params), jnp.asarray(clips),
                                 jcfg.tokenizer))
    got = tok.apply(convert.from_numpy(np_params, "cpu"), torch.tensor(clips), cfg.tokenizer)
    assert got.dtype == torch.float32 and got.shape == (2, 64, DIM)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_uint8_clip_equals_scaled_float_clip():
    _, cfg = _cfgs()
    params = tok.init(cfg.tokenizer, torch.Generator().manual_seed(0), device="cpu")
    clips = torch.tensor(_clips(2, 1, uint8=True))
    a = tok.apply(params, clips, cfg.tokenizer)
    b = tok.apply(params, clips.float() * (1.0 / 255.0), cfg.tokenizer)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_convert_torch_conv3d_matches_conv3d():
    conv = torch.nn.Conv3d(3, 32, kernel_size=(2, 8, 8), stride=(2, 8, 8))
    torch.manual_seed(0)
    torch.nn.init.normal_(conv.weight, std=0.05)
    torch.nn.init.normal_(conv.bias, std=0.05)
    w, b = conv.weight.detach().numpy(), conv.bias.detach().numpy()
    params = tok.convert_torch_conv3d(w, b, device="cpu")
    jparams = jtok.convert_torch_conv3d(w, b)
    np.testing.assert_array_equal(params["w"].numpy(), np.asarray(jparams["w"]))
    clips = torch.tensor(_clips(3, 2, (4, 16, 8, 2, 3, 32)))  # [B, T, H, W, C]
    cfg = tok.VideoTokenizerConfig(4, 16, 8, 2, 3, 32)
    got = tok.apply(params, clips, cfg)
    with torch.no_grad():
        want = conv(clips.permute(0, 4, 1, 2, 3))  # [B, D, t, h, w]
    want = want.flatten(2).transpose(1, 2)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dim, length", [(128, 64), (768, 1568), (384, 1568)])
def test_sincos_pos_embed_equals_jax_table(dim, length):
    want = jtok.sincos_pos_embed(dim, length)
    np.testing.assert_array_equal(tok.sincos_pos_embed(dim, length), want)
    on = tok.sincos_pos_embed_on(dim, length, "cpu")
    assert on.shape == (1, length, dim) and on.dtype == torch.float32
    np.testing.assert_array_equal(on.numpy(), want)
    assert tok.sincos_pos_embed_on(dim, length, "cpu") is on  # built once, kept


# ---------------------------------------------------------------- classifier


def _forward_both(jcfg, cfg, np_params, clips, jprec, prec):
    want = jvc.forward(jax.tree.map(jnp.asarray, np_params), jnp.asarray(clips), jcfg, jprec)
    with torch.no_grad():
        got = vc.forward(convert.from_numpy(np_params, "cpu"), torch.tensor(clips), cfg, prec)
    return got, np.asarray(want, np.float32)


@pytest.mark.parametrize("pos_embed", ["sincos", "learned"])
def test_video_forward_fp32_matches_jax(pos_embed):
    jcfg, cfg = _cfgs(pos_embed)
    np_params = _np_params(jcfg)
    assert ("pos_embed" in np_params) == (pos_embed == "learned")
    got, want = _forward_both(jcfg, cfg, np_params, _clips(4, 2), jenc.FP32, enc.FP32)
    assert got.shape == (2, NCLS) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_video_forward_uint8_bf16_matches_jax_at_drift_bound():
    jcfg, cfg = _cfgs()
    np_params = _np_params(jcfg, seed=1)
    got, want = _forward_both(
        jcfg, cfg, np_params, _clips(5, 2, uint8=True), jenc.BF16, enc.BF16)
    np.testing.assert_allclose(got.float().numpy(), want, atol=0.15, rtol=0.1)


def test_video_forward_auto_crosses_into_flash_at_512_tokens():
    """16 frames of 128^2 are 8 * 8 * 8 = 512 tokens: "auto" resolves to
    flash in both packages under FP32."""
    tok_args = (16, 128, 16, 2, 3, DIM)
    jcfg, cfg = _cfgs(impl="auto", depth=1, tok_args=tok_args)
    assert cfg.tokenizer.num_patches == 512
    assert enc._resolve_impl(cfg.encoder, 512, enc.FP32) == "flash"
    assert jenc._resolve_impl(jcfg.encoder, 512, jenc.FP32) == "flash"
    got, want = _forward_both(
        jcfg, cfg, _np_params(jcfg), _clips(6, 1, tok_args), jenc.FP32, enc.FP32)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("precision", [enc.FP32, enc.BF16], ids=["fp32", "bf16"])
def test_encoder_flash_matches_xla_in_the_port(precision):
    """The counterpart of tests/test_flash_attention.py's encoder test,
    with a ragged mask: kept rows agree between the two attention paths."""
    cfg_f = enc.EncoderConfig(dim=64, depth=2, num_heads=2, attn_impl="flash")
    cfg_x = enc.EncoderConfig(dim=64, depth=2, num_heads=2, attn_impl="xla")
    params = enc.init(cfg_f, torch.Generator().manual_seed(0), device="cpu")
    x = torch.tensor(np.random.default_rng(4).standard_normal((2, 197, 64), np.float32))
    mask = torch.ones(2, 197, dtype=torch.bool)
    mask[1, 120:] = False
    got = enc.encode(params, x, cfg_f, mask=mask, precision=precision).float()
    want = enc.encode(params, x, cfg_x, mask=mask, precision=precision).float()
    if precision.is_bf16:
        torch.testing.assert_close(got[mask], want[mask], atol=0.15, rtol=0.1)
    else:
        torch.testing.assert_close(got[mask], want[mask], atol=2e-3, rtol=2e-3)


def test_remat_save_keeps_flash_and_remat_true_checkpoints_it():
    """remat="save" resolves only "fused" away; gradients with remat off,
    True and "save" agree on the flash path."""
    cfg = enc.EncoderConfig(dim=64, depth=2, num_heads=2, attn_impl="flash")
    params = enc.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    x = torch.tensor(np.random.default_rng(5).standard_normal((1, 40, 64), np.float32))
    grads = []
    for remat in (False, True, "save"):
        leaf = params["qkv_w"].clone().requires_grad_(True)
        out = enc.encode({**params, "qkv_w": leaf}, x, cfg, remat=remat)
        out.square().sum().backward()
        grads.append(leaf.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=0)
    torch.testing.assert_close(grads[0], grads[2], rtol=0, atol=0)


def test_video_classifier_module_holds_cast_params_on_its_device():
    _, cfg = _cfgs()
    params = vc.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    model = vc.VideoClassifier(cfg, params, precision=enc.BF16, device="cpu")
    tree = model.params()
    assert tree["encoder"]["qkv_w"].dtype == torch.bfloat16
    assert tree["encoder"]["norm1_scale"].dtype == torch.float32
    assert tree["tokenizer"]["w"].dtype == torch.float32
    clips = torch.tensor(_clips(7, 2, uint8=True))
    got = model(clips)
    assert got.shape == (2, NCLS) and not got.requires_grad
    want = vc.forward(params, clips, cfg, enc.BF16)
    torch.testing.assert_close(got, want.detach(), rtol=0, atol=0)
    with pytest.raises(RuntimeError, match="CUDA card"):
        vc.init(cfg, torch.Generator().manual_seed(0))  # no device named: the card


# ------------------------------------------------------------ multi-view eval


def test_view_cutting_matches_jax():
    video = np.random.default_rng(8).integers(0, 256, (21, 40, 52, 3), dtype=np.uint8)
    for frames in (video, video[:5]):  # longer and shorter than a clip
        np.testing.assert_array_equal(
            ve.temporal_segments(frames, 8, 5), jve.temporal_segments(frames, 8, 5))
    for clip in (video[:8], video[:8].transpose(0, 2, 1, 3)):  # wide and tall
        np.testing.assert_array_equal(ve.spatial_crops(clip, 32), jve.spatial_crops(clip, 32))


def test_multiview_logits_match_jax():
    jcfg, cfg = _cfgs(depth=1)
    np_params = _np_params(jcfg, seed=2)
    video = np.random.default_rng(9).standard_normal((19, 72, 90, 3)).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, np_params)
    want, n_want = jve.multiview_logits(
        lambda c: jvc.forward(jparams, c, jcfg), video, num_frames=FRAMES, crop=IMG)
    params = convert.from_numpy(np_params, "cpu")
    seen = []

    def forward(batch):
        seen.append(tuple(batch.shape))
        with torch.no_grad():
            return vc.forward(params, batch, cfg)

    got, n = ve.multiview_logits(forward, video, num_frames=FRAMES, crop=IMG)
    assert n == n_want == 15 and seen == [(15, FRAMES, IMG, IMG, 3)]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


# ------------------------------------------------------------------ training


def _step_both(track, jprec, prec, tx, spec, steps):
    jcfg, cfg = _cfgs(depth=2)
    np_params = _np_params(jcfg, seed=3)
    clips = _clips(10, 4)
    labels = (np.arange(4) % NCLS).astype(np.int64)
    frozen_keys = jstep.FROZEN_KEYS if track == "frozen" else ()

    jtr, jfr = jstep.split_params(jax.tree.map(jnp.asarray, np_params), frozen_keys)
    jstep_fn = jax.jit(jstep.make_train_step(
        lambda p, x, r: jvc.forward(p, x, jcfg, precision=jprec), tx))
    opt_state = tx.init(jtr)

    tr_np, fr_np = step_lib.split_params(np_params, frozen_keys)
    tr = convert.from_numpy(tr_np, "cpu", requires_grad=True)
    fr = convert.from_numpy(fr_np, "cpu")
    step_fn = step_lib.make_train_step(
        lambda p, x, g: vc.forward(p, x, cfg, prec), spec.init(tr))
    losses = []
    for _ in range(steps):
        jtr, opt_state, jm = jstep_fn(
            jtr, jfr, opt_state,
            {"input": jnp.asarray(clips), "label": jnp.asarray(labels.astype(np.int32))}, None)
        m = step_fn(tr, fr, {"input": torch.tensor(clips), "label": torch.tensor(labels)})
        losses.append((m["loss"].item(), float(jm["loss"])))
    return losses, tr, fr, jax.tree.map(np.asarray, jtr), fr_np


@pytest.mark.parametrize("track", ["frozen", "full"])
def test_video_train_step_fp32_matches_jax_step(track):
    """One SGD step under FP32 through flash attention, forward and
    backward: the loss and every updated leaf against the JAX step. (SGD is
    linear in the gradient; Adam's first update is g / |g|, which cannot
    show that two gradients agree.)"""
    losses, tr, fr, jtr, fr_np = _step_both(
        track, jenc.FP32, enc.FP32, joptim.make_optimizer("sgd", lr=0.1),
        optim.make_optimizer("sgd", lr=0.1), 1)
    assert abs(losses[0][0] - losses[0][1]) <= 1e-4
    got = dict(leaves_with_path(tr))
    want = dict(leaves_with_path(jtr))
    assert set(got) == set(want)
    assert (("encoder", "qkv_w") in got) == (track == "full")
    for path, leaf in got.items():
        np.testing.assert_allclose(
            leaf.detach().numpy(), want[path], rtol=1e-4, atol=2e-5, err_msg="/".join(path))
    for k, v in fr.get("encoder", {}).items():  # frozen leaves: untouched, no grad
        np.testing.assert_array_equal(v.numpy(), fr_np["encoder"][k])
        assert v.grad is None


def test_video_train_bf16_adamw_losses_match_jax():
    losses, tr, *_ = _step_both(
        "full", jenc.BF16, enc.BF16, optax.adamw(1e-3, weight_decay=0.05),
        optim.make_optimizer("adamw", lr=1e-3, weight_decay=0.05), 3)
    for got, want in losses:
        assert np.isfinite(got) and abs(got - want) <= 0.05
    assert losses[-1][0] < losses[0][0]
    assert tr["encoder"]["qkv_w"].dtype == torch.float32


# ------------------------------------------------------------------ video MAE


def _mae_cfgs():
    kw = dict(mask_ratio=0.75)
    jcfg = jvp.VideoMAEConfig(
        tokenizer=jtok.VideoTokenizerConfig(*TOK_ARGS),
        encoder=jenc.EncoderConfig(dim=DIM, depth=2, num_heads=HEADS),
        decoder=jenc.EncoderConfig(dim=64, depth=1, num_heads=1, attn_impl="flash"), **kw)
    cfg = vp.VideoMAEConfig(
        tokenizer=tok.VideoTokenizerConfig(*TOK_ARGS),
        encoder=enc.EncoderConfig(dim=DIM, depth=2, num_heads=HEADS),
        decoder=enc.EncoderConfig(dim=64, depth=1, num_heads=1, attn_impl="flash"), **kw)
    return jcfg, cfg


def test_video_mae_config_and_default_routes():
    a, b = jvp.VideoMAEConfig(), vp.VideoMAEConfig()
    assert (a.num_tokens, a.num_visible) == (b.num_tokens, b.num_visible) == (1568, 157)
    # the recipe's FP32 policy: 152 visible tokens materialise, the decoder's 1568 flash
    assert enc._resolve_impl(b.encoder, 152, enc.FP32) == "xla"
    assert enc._resolve_impl(b.decoder, 1568, enc.FP32) == "flash"
    assert b.decoder.head_dim == 64


def test_tube_mask_shares_one_spatial_mask_across_frames():
    _, cfg = _mae_cfgs()
    visible, masked = vp.tube_mask(torch.Generator().manual_seed(0), cfg, 3)
    t, spatial = cfg.tokenizer.t_patches, cfg.tokenizer.grid**2
    assert visible.shape == (3, cfg.num_visible) and masked.shape == (3, 64 - cfg.num_visible)
    both = torch.cat([visible, masked], dim=1).sort(dim=1).values
    assert torch.equal(both, torch.arange(64).expand(3, 64))  # a partition of the tokens
    per_frame = visible.reshape(3, t, -1) % spatial
    assert torch.equal(per_frame, per_frame[:, :1].expand_as(per_frame))
    again, _ = vp.tube_mask(torch.Generator().manual_seed(0), cfg, 3)
    other, _ = vp.tube_mask(torch.Generator().manual_seed(1), cfg, 3)
    assert torch.equal(visible, again) and not torch.equal(visible, other)


def test_video_mae_loss_matches_jax_with_shared_indices():
    """JAX draws the tube mask inside forward_loss; the same key gives the
    indices, which go to the port's forward_loss_at."""
    jcfg, cfg = _mae_cfgs()
    np_params = jax.tree.map(np.asarray, jvp.init(jcfg, jax.random.PRNGKey(0)))
    clips = np.random.default_rng(11).random((2, FRAMES, IMG, IMG, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    visible, masked = (np.asarray(a) for a in jvp.tube_mask(key, jcfg, 2))
    want, aux = jvp.forward_loss(
        jax.tree.map(jnp.asarray, np_params), jnp.asarray(clips), key, jcfg)
    np.testing.assert_array_equal(np.asarray(aux["masked_idx"]), masked)

    params = convert.from_numpy(np_params, "cpu", requires_grad=True)
    loss, got_aux = vp.forward_loss_at(
        params, torch.tensor(clips), torch.tensor(visible).long(),
        torch.tensor(masked).long(), cfg)
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-4)
    np.testing.assert_allclose(
        got_aux["pred"].detach().numpy(), np.asarray(aux["pred"]), atol=1e-4)
    loss.backward()  # every leaf takes a gradient, through flash in the decoder
    for path, leaf in leaves_with_path(params):
        assert leaf.grad is not None and torch.isfinite(leaf.grad).all(), path
    # drawing from a generator gives a loss of the same kind
    drawn, _ = vp.forward_loss(params, torch.tensor(clips), torch.Generator().manual_seed(0), cfg)
    assert drawn.dim() == 0 and torch.isfinite(drawn)
