"""The port's UperNet segmentor (heads/upernet.py, models/segmentor.py) and
its ADE20K recipe against the JAX package on the CPU at smoke geometry, with
perturbed JAX weights carried across: logits and ``seg_loss`` at 1e-4,
``tta_inference`` at 1e-4, and one training step of the recipe as the CLI
builds it (its optimizer, frozen keys and layer decay) at 1e-5.

The UperNet step is held against the reference run in float64 (its encoder
under a float64 precision policy), with the
port's ReLU gates (``gates.act_gate``) taken from its own float64 run
of the same loss and replayed in its fp32 step: one of the 262,144 gates of
``fpn0`` flips in the port's fp32 on some CPUs, which alone moved the
``fpn0/w`` gradient 3.1e-3 of its largest from float64 (the reference's
fp32 stood 8.2e-7 off; with the gates replayed the port's fp32 stands
8.7e-6 from the float64 reference, its furthest leaf).

The step runs under the FP32 policy in both packages (``enc.BF16`` patched
to ``enc.FP32`` where the recipes read it): bf16 rounds differently in XLA
and in torch, so only FP32 can be held at 1e-5.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metatransformer_tpu import recipes as jrecipes
from metatransformer_tpu.configs import load_config as jload_config
from metatransformer_tpu.core import encoder as jenc
from metatransformer_tpu.heads import upernet as jupernet
from metatransformer_tpu.models import segmentor as jseg
from metatransformer_tpu.train import optim as joptim
from metatransformer_tpu.train import step as jstep
from metatransformer_tpu_torch import train_cli
from metatransformer_tpu_torch.configs import CONFIG_DIR
from metatransformer_tpu_torch.core import convert
from metatransformer_tpu_torch.core import encoder as enc
from metatransformer_tpu_torch.core.tree import leaves_with_path
from metatransformer_tpu_torch.heads import upernet
from metatransformer_tpu_torch.models import segmentor
from metatransformer_tpu_torch.ops import gates
from tests.test_torch_vit_adapter import close, images, perturb, smoke_adapter

torch.set_num_threads(1)
TOL = 1e-4
STEP_TOL = 1e-5
GRAD_TOL = 1e-4  # of each leaf's own largest gradient
CLASSES = 7


@pytest.fixture(scope="module")
def seg_run():
    """(port config, perturbed numpy params, images, JAX logits)."""
    jcfg = jseg.SegmentorConfig(backbone=smoke_adapter(True), num_classes=CLASSES)
    cfg = segmentor.SegmentorConfig(backbone=smoke_adapter(False), num_classes=CLASSES)
    params = perturb(jseg.init(jcfg, jax.random.PRNGKey(0)), seed=1)
    x = images()
    want = np.asarray(jseg.forward(jax.tree.map(jnp.asarray, params), jnp.asarray(x), jcfg))
    return jcfg, cfg, params, x, want


def test_segmentor_logits_match_jax(seg_run):
    _, cfg, params, x, want = seg_run
    got = segmentor.forward(convert.from_numpy(params, "cpu"), torch.tensor(x), cfg)
    assert tuple(got.shape) == (2, 64, 64, CLASSES)
    close(got, want, TOL)


def test_upernet_head_matches_on_its_own():
    jcfg = jupernet.UperNetConfig(in_dim=32, channels=16, num_classes=CLASSES)
    cfg = upernet.UperNetConfig(in_dim=32, channels=16, num_classes=CLASSES)
    params = perturb(jupernet.init(jcfg, jax.random.PRNGKey(4)), seed=4)
    rng = np.random.default_rng(5)
    feats = [rng.standard_normal((2, s, s, 32)).astype(np.float32) for s in (24, 12, 6, 3)]
    want = jupernet.apply(jax.tree.map(jnp.asarray, params), [jnp.asarray(f) for f in feats], jcfg)
    got = upernet.apply(convert.from_numpy(params, "cpu"), [torch.tensor(f) for f in feats], cfg)
    close(got, want, TOL)
    fresh = upernet.init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert jax.tree.map(lambda a: tuple(np.shape(a)), convert.to_numpy(fresh)) == jax.tree.map(
        lambda a: tuple(np.shape(a)), params)


def test_seg_loss_ignores_255():
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((2, 9, 9, CLASSES)).astype(np.float32) * 3
    labels = rng.integers(0, CLASSES, (2, 9, 9)).astype(np.int32)
    labels[:, :3] = 255
    want = float(jseg.seg_loss(jnp.asarray(logits), jnp.asarray(labels)))
    got = segmentor.seg_loss(torch.tensor(logits), torch.tensor(labels)).item()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    everything_ignored = torch.full((2, 9, 9), 255)
    assert segmentor.seg_loss(torch.tensor(logits), everything_ignored).item() == 0.0


def test_tta_inference_matches_jax(seg_run):
    jcfg, cfg, params, x, _ = seg_run
    want = np.asarray(jseg.tta_inference(jax.tree.map(jnp.asarray, params), jnp.asarray(x[:1]),
                                         jcfg))
    got = segmentor.tta_inference(convert.from_numpy(params, "cpu"), torch.tensor(x[:1]), cfg)
    close(got, want, TOL)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)


# --------------------------------------------------------------------------
# One recipe step as the CLI builds it, against JAX
# --------------------------------------------------------------------------


def float64_gates(recipe, start, batch):
    """The ReLU gates (``gates.act_gate``) of the port's recipe loss
    and its gradient at the numpy parameters ``start`` on ``batch``,
    computed in float64 (parameters, inputs and the precision policy), in
    the order the forward asks for them."""
    def wide(a):
        a = np.asarray(a)
        return a.astype(np.float64) if a.dtype == np.float32 else a

    params = convert.from_numpy(jax.tree.map(wide, start), "cpu")
    for _, leaf in leaves_with_path(params):
        leaf.requires_grad_(True)
    x = {k: torch.tensor(wide(v)) for k, v in batch["input"].items()}
    kept, gate = [], gates.act_gate
    with mock.patch.object(gates, "act_gate", lambda t, slope: kept.append(
            gate(t, slope)) or kept[-1]), mock.patch.object(enc, "BF16", enc.Precision(
                torch.float64)):
        recipe.forward(params, x, torch.Generator().manual_seed(0)).backward()
    assert kept
    return kept


def replay(monkeypatch, module, name, kept):
    """``module.name`` answers each call with the next of ``kept`` (same
    shape); returns a check that every one was taken."""
    it = iter(kept)

    def next_kept(t, *_):
        got = next(it)
        assert got.shape == t.shape, (name, got.shape, t.shape)
        return got

    monkeypatch.setattr(module, name, next_kept)
    return lambda: next(it, None) is None


def recipe_step(name: str, monkeypatch, wrap_port_forward=None, f64: bool = False):
    """One AdamW step of the YAML's smoke recipe at batch 2 under FP32: the
    port's through ``train_cli.setup`` (its Trainer, optimizer, schedule,
    frozen keys), JAX's as its CLI composes ``optim.build`` and
    ``make_train_step``, from the same perturbed weights and batch. Returns
    (port loss, JAX loss, port trainer, port start, JAX grads, JAX updates,
    the config) with trees as numpy. With ``f64`` JAX's loss, gradients and
    update are float64's (its encoder under a float64 precision policy), and the port's fp32 step replays the ReLU gates of
    its own float64 run (:func:`float64_gates`)."""
    monkeypatch.setattr(enc, "BF16", enc.FP32)
    monkeypatch.setattr(jenc, "BF16", jenc.Precision(jnp.float64, jax.lax.Precision.HIGHEST)
                        if f64 else jenc.FP32)
    path = f"{CONFIG_DIR}/{name}"
    cfg = jload_config(path)
    jrec = jrecipes.build(cfg, jax.random.PRNGKey(0), smoke=True)
    np_params = perturb(jrec.params, seed=2, scale=0.05)
    session = train_cli.setup(["--cfg", path, "--smoke", "--device", "cpu", "--epochs", "1",
                               "--steps-per-epoch", "1", "train.batch_size=2"])
    trainer = session.trainer
    batch = next(iter(session.recipe.synth(2, 1, 3)))
    for (p, leaf), (_, src) in zip(leaves_with_path(trainer.trainable),
                                   leaves_with_path(np_params)):
        with torch.no_grad():
            leaf.copy_(torch.tensor(src))
    assert trainer.optimizer.learning_rate() == pytest.approx(cfg.train.lr)
    start = convert.to_numpy(trainer.trainable)
    if wrap_port_forward is not None:
        wrap_port_forward()
    if f64:
        all_taken = replay(monkeypatch, gates, "act_gate",
                           float64_gates(session.recipe, start, batch))
    port_loss = trainer.train_epoch([batch], torch.Generator().manual_seed(0))["loss"]
    if f64:
        assert all_taken()

    tx = joptim.build(cfg.train.optimizer, cfg.train.lr, weight_decay=cfg.train.weight_decay,
                      layer_decay=cfg.train.get("layer_decay"), encoder_depth=12)
    dtype = np.float64 if f64 else np.float32

    def as_jax(a):
        a = np.asarray(a)
        return jnp.asarray(a, dtype if a.dtype == np.float32 else a.dtype)

    with jax.enable_x64(f64):
        trainable, frozen = jstep.split_params(jax.tree.map(as_jax, np_params), ("encoder",))
        jx = jax.tree.map(as_jax, batch["input"])
        key = jax.random.PRNGKey(7)
        loss, grads = jax.jit(jax.value_and_grad(
            lambda tr: jrec.forward(jstep.merge_params(tr, frozen), jx, key)))(trainable)
        updates, _ = jax.jit(tx.update)(grads, tx.init(trainable), trainable)
        grads, updates = (jax.tree.map(lambda a: np.asarray(a, np.float32), t)
                          for t in (grads, updates))
    return (port_loss, float(loss), trainer, start, grads, updates, cfg)


def check_step(port_loss, jax_loss, trainer, start, grads, updates):
    """Loss at STEP_TOL; every leaf's gradient at GRAD_TOL of that leaf's
    own largest; the update at STEP_TOL wherever JAX's gradient decides it.

    A leaf whose whole JAX gradient lies below 1e-6 of the tree's largest
    is zero but for rounding (a conv bias that a GroupNorm cancels, an
    attention key bias that the softmax cancels): the port must find it so
    too. AdamW's first update is about lr * sign(g), so an update is held
    where JAX's gradient alone fixes its sign: |g| above its leaf's
    gradient bound (GRAD_TOL of the leaf's largest) and above 1e-6 of the
    tree's largest (the rounding floor that the zero leaves show). Of the
    elements whose JAX gradient is not exactly zero, those left out (the
    zero leaves' included) are counted and must stay under 10%."""
    np.testing.assert_allclose(port_loss, jax_loss, rtol=STEP_TOL, atol=STEP_TOL)
    flat = [leaves_with_path(t) for t in
            (trainer.trainable, start, convert.to_numpy(trainer.trainable), grads, updates)]
    assert len({len(f) for f in flat}) == 1
    largest = max(np.abs(g).max() for _, g in flat[3])
    n_zero = n_nonzero = n_unchecked = 0
    for (path, leaf), (_, s), (_, new), (_, g), (_, u) in zip(*flat):
        port_g, top = leaf.grad.numpy(), np.abs(g).max()
        nonzero = g != 0
        n_nonzero += int(nonzero.sum())
        if top < 1e-6 * largest:
            assert np.abs(port_g).max() < 1e-6 * largest, f"grad {path}"
            n_zero, n_unchecked = n_zero + 1, n_unchecked + int(nonzero.sum())
            continue
        np.testing.assert_allclose(port_g, g, rtol=0, atol=GRAD_TOL * top, err_msg=f"grad {path}")
        determined = np.abs(g) > max(GRAD_TOL * top, 1e-6 * largest)
        n_unchecked += int((nonzero & ~determined).sum())
        np.testing.assert_allclose((new - s)[determined], u[determined], rtol=0, atol=STEP_TOL,
                                   err_msg=f"update {path}")
    assert n_zero < len(flat[0]) // 10, (n_zero, len(flat[0]))
    assert n_unchecked < 0.1 * n_nonzero, (n_unchecked, n_nonzero)


@pytest.fixture(scope="module")
def upernet_step():
    with pytest.MonkeyPatch.context() as mp:
        return recipe_step("ade20k_upernet_metatransformer.yaml", mp, f64=True)


def test_ade20k_upernet_recipe_step_matches_jax(upernet_step):
    port_loss, jax_loss, trainer, start, grads, updates, _ = upernet_step
    check_step(port_loss, jax_loss, trainer, start, grads, updates)


def test_the_backbone_trains_undecayed_as_in_the_reference(upernet_step):
    """Reference caveat kept: the recipe's tree is {"backbone": {...,
    "encoder"}, "head"}, and the CLI freezes and layer-decays only a
    top-level "encoder". So despite ``frozen: true`` and ``layer_decay:
    0.95`` nothing is frozen and every leaf's rate factor is 1: the ViT
    blocks under backbone/encoder move after one step, by JAX's update."""
    _, _, trainer, start, _, updates, cfg = upernet_step
    assert cfg.encoder.frozen and cfg.train.layer_decay == 0.95
    assert trainer.frozen == {} and set(trainer.trainable) == {"backbone", "head"}
    assert trainer.optimizer.lr_scales and all(s == 1.0 for s in trainer.optimizer.lr_scales)
    starts = dict(leaves_with_path(start))
    jax_updates = dict(leaves_with_path(updates))
    enc_leaves = [(p, leaf) for p, leaf in leaves_with_path(trainer.trainable)
                  if p[:2] == ("backbone", "encoder")]
    assert len(enc_leaves) == 12
    for path, leaf in enc_leaves:
        moved = leaf.detach().numpy() - starts[path]
        assert np.abs(moved).max() > 0.5 * cfg.train.lr, path
        # the same factor as JAX's: the largest steps agree
        np.testing.assert_allclose(np.abs(moved).max(), np.abs(jax_updates[path]).max(),
                                   rtol=1e-3, err_msg=str(path))
