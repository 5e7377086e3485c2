"""Training modules of the PyTorch port vs the JAX reference: schedules,
losses, optimizers, the train step (frozen and full tracks) and the image
slice as a whole under BF16.

Inputs, weights and gradients come from seeded numpy and go through both
packages. The JAX fused sublayers run in Pallas interpret mode."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from metatransformer_tpu.core import encoder as jenc
from metatransformer_tpu.models import image_classifier as jic
from metatransformer_tpu.tokenizers import image as jtok
from metatransformer_tpu.train import losses as jlosses
from metatransformer_tpu.train import optim as joptim
from metatransformer_tpu.train import schedules as jsched
from metatransformer_tpu.train import step as jstep
from metatransformer_tpu_torch.core import convert, encoder as enc
from metatransformer_tpu_torch.core.tree import leaves_with_path
from metatransformer_tpu_torch.models import image_classifier as ic
from metatransformer_tpu_torch.tokenizers import image as tok
from metatransformer_tpu_torch.train import losses, optim, schedules
from metatransformer_tpu_torch.train import step as step_lib

torch.set_num_threads(1)

# ---------------------------------------------------------------- schedules

TOTAL, WARM, BASE = 200, 20, 5e-3
POINTS = [0, 1, WARM - 1, WARM, WARM + 1, TOTAL // 2, TOTAL, TOTAL + 10]

SCHEDULES = {
    "cosine_warmup": lambda m: m.cosine_with_warmup(BASE, TOTAL, WARM, 1e-6, 1e-6),
    "cosine": lambda m: m.cosine_with_warmup(BASE, TOTAL, 0, 1e-5),
    "multistep": lambda m: m.multistep(BASE, [WARM, 100], gamma=0.5),
    "step_decay": lambda m: m.step_decay(BASE, WARM, gamma=0.1),
    "poly": lambda m: m.poly(BASE, TOTAL, power=0.9, min_lr=1e-5),
    "one_cycle": lambda m: m.one_cycle(BASE, TOTAL),
    "type1_halving": lambda m: m.type1_halving(BASE, WARM),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_optax(name):
    got, want = SCHEDULES[name](schedules), SCHEDULES[name](jsched)
    for step in POINTS:
        # rtol 1e-6, plus the optax side's own fp32 rounding of a value of
        # the size of the base rate (it computes the cosine in fp32).
        np.testing.assert_allclose(
            got(step), float(want(jnp.asarray(step))), rtol=1e-6, atol=BASE * 2e-7,
            err_msg=f"{name} at step {step}",
        )
        assert isinstance(got(step), float)


def test_linear_scaled_lr_matches():
    assert schedules.linear_scaled_lr(1e-3, 512) == jsched.linear_scaled_lr(1e-3, 512)


# ------------------------------------------------------------------- losses


def _loss_case(name):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((6, 5)).astype(np.float32) * 2
    labels = rng.integers(0, 5, 6).astype(np.int32)
    probs = rng.dirichlet(np.ones(5), 6).astype(np.float32)
    multi = (rng.random((6, 5)) > 0.5).astype(np.float32)
    target = rng.standard_normal((6, 5)).astype(np.float32)
    mask = (rng.random((6, 5)) > 0.3).astype(np.float32)
    return {
        "cross_entropy": ((logits, labels), {}),
        "cross_entropy_smoothed": ((logits, labels), {"label_smoothing": 0.2}),
        "soft_cross_entropy": ((logits, probs), {}),
        "bce_with_logits": ((logits, multi), {}),
        "focal": ((logits, labels), {}),
        "dice": ((logits, labels), {}),
        "l1": ((logits, target), {}),
        "mse": ((logits, target), {}),
        "masked_mse": ((logits, target, mask), {}),
    }[name]


@pytest.mark.parametrize(
    "name",
    ["cross_entropy", "cross_entropy_smoothed", "soft_cross_entropy", "bce_with_logits",
     "focal", "dice", "l1", "mse", "masked_mse"],
)
def test_loss_matches_jax(name):
    args, kw = _loss_case(name)
    fn = name.replace("_smoothed", "")
    want = getattr(jlosses, fn)(*map(jnp.asarray, args), **kw)
    torch_args = [torch.tensor(a).long() if a.dtype == np.int32 else torch.tensor(a) for a in args]
    got = getattr(losses, fn)(*torch_args, **kw)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


def test_step_cross_entropy_and_accuracy_match_jax():
    (logits, labels), _ = _loss_case("cross_entropy")
    got = step_lib.cross_entropy_loss(torch.tensor(logits), torch.tensor(labels).long())
    np.testing.assert_allclose(
        got.item(), float(jstep.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels))),
        rtol=1e-5,
    )
    acc = step_lib._accuracy(torch.tensor(logits), torch.tensor(labels).long())
    np.testing.assert_allclose(
        acc.item(), float(jstep._accuracy(jnp.asarray(logits), jnp.asarray(labels))), rtol=1e-6
    )
    # structured tasks (float labels, no labels) report no accuracy
    assert step_lib._accuracy(torch.tensor(logits), torch.tensor(logits)).item() == 0.0
    assert step_lib._accuracy(torch.tensor(logits), None).item() == 0.0


def test_split_and_merge_params():
    params = {"encoder": {"w": 1}, "head": {"w": 2}, "tokenizer": {"w": 3}}
    tr, fr = step_lib.split_params(params)
    assert set(tr) == {"head", "tokenizer"} and set(fr) == {"encoder"}
    assert step_lib.merge_params(tr, fr) == params
    assert step_lib.FROZEN_KEYS == jstep.FROZEN_KEYS
    tr, fr = step_lib.split_params(params, ())
    assert fr == {} and tr == params


# --------------------------------------------------------------- optimizers

DEPTH = 3


def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {
        "encoder": {"qkv_w": f(DEPTH, 4, 6), "norm1_scale": f(DEPTH, 4)},
        "tokenizer": {"w": f(5, 4), "b": f(4)},
        "head": {"w0": f(4, 3)},
        "pos_embed": f(1, 2, 4),
    }


@pytest.mark.parametrize("layer_decay", [None, 0.75])
@pytest.mark.parametrize("grad_clip", [None, 0.5])
@pytest.mark.parametrize("name", ["adamw", "adam", "sgd", "lamb", "lars", "adabelief", "radam"])
def test_optimizer_matches_optax(name, grad_clip, layer_decay):
    """20 updates on seeded random gradients over a tree with a stacked
    encoder subtree, under a warm-up + cosine schedule."""
    sched_args = (3e-2, 20, 5, 1e-4, 1e-4)
    kw = dict(weight_decay=0.05, layer_decay=layer_decay, encoder_depth=DEPTH,
              grad_clip=grad_clip)
    tx = joptim.build(name, jsched.cosine_with_warmup(*sched_args), **kw)
    spec = optim.build(name, schedules.cosine_with_warmup(*sched_args), **kw)
    np_params = _opt_tree(0)
    jparams = jax.tree.map(jnp.asarray, np_params)
    state = tx.init(jparams)
    params = convert.from_numpy(np_params, "cpu", requires_grad=True)
    opt = spec.init(params)
    # jitted, as the reference's Trainer runs it: RAdam's fp32 rho rounds
    # differently eagerly (b2**count by repeated products, not exp/log)
    update = jax.jit(tx.update)
    for step in range(20):
        grads = _opt_tree(100 + step)
        updates, state = update(jax.tree.map(jnp.asarray, grads), state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for (_, p), (_, g) in zip(leaves_with_path(params), leaves_with_path(grads)):
            p.grad = torch.tensor(g)
        opt.step()
    for (path, p), (_, want) in zip(
        leaves_with_path(params), leaves_with_path(jax.tree.map(np.asarray, jparams))
    ):
        np.testing.assert_allclose(
            p.detach().numpy(), want, rtol=1e-5, atol=1e-6, err_msg="/".join(path)
        )
    # the state as a flat list of leaves is the optax state's leaves
    jleaves = jax.tree_util.tree_leaves(state)
    leaves = opt.state_leaves()
    assert len(leaves) == len(jleaves)
    for a, b in zip(leaves, jleaves):
        a = a.numpy() if isinstance(a, torch.Tensor) else a
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name", ["lamb", "lars", "adabelief", "radam"])
def test_unported_optimizers_raise(name):
    """The four optimizers that once raised (ROADMAP queue 1 item 4) are
    ported: both factories build them, as the reference's zoo does."""
    assert optim.make_optimizer(name).name == name
    assert optim.build(name, 1e-3, layer_decay=0.75).lr_scale_fn is not None


@pytest.mark.parametrize("name", ["lamb", "lars", "adabelief", "radam"])
def test_optimizer_state_crosses_packages(name):
    """8 optax updates, the state carried into the port through
    ``state_from_optax``, then 3 updates in both packages: parameters at
    1e-5, and ``state_to_optax`` equal to optax's state (step count and
    moments). RAdam's rectified branch starts at the 6th update."""
    tx = joptim.build(name, 1e-2, weight_decay=0.05)
    np_params = _opt_tree(2)
    jparams = jax.tree.map(jnp.asarray, np_params)
    state = tx.init(jparams)

    update = jax.jit(tx.update)  # as the reference's Trainer runs it

    def optax_step(seed):
        nonlocal state, jparams
        g = jax.tree.map(jnp.asarray, _opt_tree(seed))
        updates, state = update(g, state, jparams)
        jparams = optax.apply_updates(jparams, updates)

    def moments():
        if name == "lars":  # chain(decay, trust ratio, rate, trace)
            return np.int32(0), state[0][3].trace, {}
        inner = state[0][0]  # chain(scale_by_adam / scale_by_belief, ...)
        return inner.count, inner.mu, inner.nu

    for step in range(8):
        optax_step(400 + step)
    params = convert.from_numpy(jax.tree.map(np.asarray, jparams), "cpu", requires_grad=True)
    opt = optim.build(name, 1e-2, weight_decay=0.05).init(params)
    count, mu, nu = moments()
    optim.state_from_optax(opt, np.asarray(count), jax.tree.map(np.asarray, mu),
                           jax.tree.map(np.asarray, nu))
    for step in range(3):
        optax_step(500 + step)
        grads = _opt_tree(500 + step)
        for (_, p), (_, g) in zip(leaves_with_path(params), leaves_with_path(grads)):
            p.grad = torch.tensor(g)
        opt.step()
    for (path, p), (_, want) in zip(
        leaves_with_path(params), leaves_with_path(jax.tree.map(np.asarray, jparams))
    ):
        np.testing.assert_allclose(
            p.detach().numpy(), want, rtol=1e-5, atol=1e-5, err_msg="/".join(path))
    count, mu, nu = moments()
    got_count, got_mu, got_nu = optim.state_to_optax(opt)
    if name != "lars":
        assert int(got_count) == int(count) == 11
    for got, want in ((got_mu, mu), (got_nu, nu)):
        for (path, a), (_, b) in zip(leaves_with_path(got), leaves_with_path(
                jax.tree.map(np.asarray, want))):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg="/".join(path))


def test_unknown_optimizer_raises_value_error():
    with pytest.raises(ValueError, match="unknown optimizer"):
        optim.make_optimizer("nope")


def test_missing_gradient_counts_as_zero_and_still_decays():
    """optax sees zeros for an unused leaf and AdamW still decays it."""
    p = {"a": torch.ones(3, requires_grad=True), "b": torch.ones(3, requires_grad=True)}
    opt = optim.make_optimizer("adamw", lr=0.1, weight_decay=0.5).init(p)
    p["a"].grad = torch.ones(3)
    opt.step()
    np.testing.assert_allclose(p["b"].detach().numpy(), 1.0 - 0.1 * 0.5, rtol=1e-6)


def test_layer_decay_factors_match_jax():
    e, layers, h = optim.layer_decay_factors(12, 0.75)
    je, jlayers, jh = joptim.layer_decay_factors(12, 0.75)
    assert (e, h) == (je, jh)
    np.testing.assert_allclose(layers.numpy(), np.asarray(jlayers), rtol=1e-6)


def test_adamw_state_crosses_packages_mid_training():
    """Start both packages from one mid-training optax state."""
    tx = joptim.build("adamw", 1e-2, weight_decay=0.05)
    np_params = _opt_tree(1)
    jparams = jax.tree.map(jnp.asarray, np_params)
    state = tx.init(jparams)
    for step in range(5):
        g = jax.tree.map(jnp.asarray, _opt_tree(200 + step))
        updates, state = tx.update(g, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
    adam = state[0][0]  # chain(adamw) -> chain(scale_by_adam, ...)
    params = convert.from_numpy(jax.tree.map(np.asarray, jparams), "cpu", requires_grad=True)
    opt = optim.build("adamw", 1e-2, weight_decay=0.05).init(params)
    optim.state_from_optax(
        opt, np.asarray(adam.count), jax.tree.map(np.asarray, adam.mu),
        jax.tree.map(np.asarray, adam.nu),
    )
    count, mu, nu = optim.state_to_optax(opt)
    assert int(count) == 5
    np.testing.assert_array_equal(mu["encoder"]["qkv_w"], np.asarray(adam.mu["encoder"]["qkv_w"]))
    np.testing.assert_array_equal(nu["head"]["w0"], np.asarray(adam.nu["head"]["w0"]))
    grads = _opt_tree(300)
    updates, state = tx.update(jax.tree.map(jnp.asarray, grads), state, jparams)
    jparams = optax.apply_updates(jparams, updates)
    for (_, p), (_, g) in zip(leaves_with_path(params), leaves_with_path(grads)):
        p.grad = torch.tensor(g)
    opt.step()
    for (path, p), (_, want) in zip(
        leaves_with_path(params), leaves_with_path(jax.tree.map(np.asarray, jparams))
    ):
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------- train step
# The recipe of tests/test_train_equivalence.py: linear embed -> encoder ->
# mean pool -> linear head, AdamW + cosine warm-up.

DIM, EDEPTH, HEADS = 64, 2, 2
FEAT, T, CLASSES, BATCH = 24, 12, 10, 16
BASE_LR, WD = 5e-3, 0.05


def _recipe_params(seed):
    jcfg = jenc.EncoderConfig(dim=DIM, depth=EDEPTH, num_heads=HEADS, attn_impl="xla")
    rng = np.random.default_rng(seed)
    f = lambda *s, scale: (rng.standard_normal(s) * scale).astype(np.float32)
    return {
        "encoder": jax.tree.map(np.asarray, jenc.init(jcfg, jax.random.PRNGKey(seed))),
        "tok": {"w": f(FEAT, DIM, scale=FEAT**-0.5), "b": np.zeros(DIM, np.float32)},
        "head": {"w": f(DIM, CLASSES, scale=DIM**-0.5), "b": np.zeros(CLASSES, np.float32)},
    }


def _recipe_data(seed):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((10, BATCH, T, FEAT), dtype=np.float32)
    probe = rng.standard_normal((FEAT, CLASSES), dtype=np.float32)
    ys = np.argmax(xs.mean(axis=2) @ probe, axis=-1).astype(np.int64)
    return xs, ys


def _jax_forward():
    cfg = jenc.EncoderConfig(dim=DIM, depth=EDEPTH, num_heads=HEADS, attn_impl="xla")

    def forward(p, x, rng):
        h = x @ p["tok"]["w"] + p["tok"]["b"]
        h = jenc.encode(p["encoder"], h, cfg)
        return h.mean(axis=1) @ p["head"]["w"] + p["head"]["b"]

    return forward


def _port_forward():
    cfg = enc.EncoderConfig(dim=DIM, depth=EDEPTH, num_heads=HEADS, attn_impl="xla")

    def forward(p, x, generator):
        h = x @ p["tok"]["w"] + p["tok"]["b"]
        h = enc.encode(p["encoder"], h, cfg)
        return h.mean(dim=1) @ p["head"]["w"] + p["head"]["b"]

    return forward


def _train_both(frozen_keys, steps, warmup):
    np_params = _recipe_params(0)
    xs, ys = _recipe_data(1)
    sched_args = (BASE_LR, steps, warmup, 1e-6, 1e-6)

    tx = joptim.make_optimizer(
        "adamw", lr=jsched.cosine_with_warmup(*sched_args), weight_decay=WD
    )
    jstep_fn = jax.jit(jstep.make_train_step(_jax_forward(), tx))
    jtr, jfr = jstep.split_params(jax.tree.map(jnp.asarray, np_params), frozen_keys)
    opt_state = tx.init(jtr)

    tr_np, fr_np = step_lib.split_params(np_params, frozen_keys)
    tr = convert.from_numpy(tr_np, "cpu", requires_grad=True)
    fr = convert.from_numpy(fr_np, "cpu")
    spec = optim.make_optimizer(
        "adamw", lr=schedules.cosine_with_warmup(*sched_args), weight_decay=WD
    )
    step_fn = step_lib.make_train_step(_port_forward(), spec.init(tr))

    j_losses, p_losses = [], []
    for s in range(steps):
        x, y = xs[s % len(xs)], ys[s % len(ys)]
        jtr, opt_state, jm = jstep_fn(
            jtr, jfr, opt_state,
            {"input": jnp.asarray(x), "label": jnp.asarray(y.astype(np.int32))}, None,
        )
        m = step_fn(tr, fr, {"input": torch.tensor(x), "label": torch.tensor(y)})
        assert m["loss"].dim() == 0 and m["acc"].dim() == 0
        j_losses.append(float(jm["loss"]))
        p_losses.append(m["loss"].item())
    return np.asarray(j_losses), np.asarray(p_losses), fr_np, fr


def _assert_curves_match(j_losses, p_losses):
    assert p_losses[-1] < 0.5 * p_losses[0], p_losses[[0, -1]]
    tol = 1e-3 + 2e-3 * np.abs(j_losses)  # tests/test_train_equivalence.py:175
    diff = np.abs(p_losses - j_losses)
    worst = int(np.argmax(diff - tol))
    assert (diff <= tol).all(), (
        f"step {worst}: port {p_losses[worst]:.6f} vs jax {j_losses[worst]:.6f}"
    )


def test_frozen_track_matches_jax_train_step_200_steps():
    j_losses, p_losses, fr_np, fr = _train_both(jstep.FROZEN_KEYS, 200, 20)
    _assert_curves_match(j_losses, p_losses)
    for k, v in fr["encoder"].items():  # frozen leaves: untouched, no grad
        np.testing.assert_array_equal(v.numpy(), fr_np["encoder"][k])
        assert v.grad is None


def test_full_track_matches_jax_train_step_50_steps():
    j_losses, p_losses, _, fr = _train_both((), 50, 5)
    assert fr == {}
    _assert_curves_match(j_losses, p_losses)


def _one_step(accum, batch, seed=0):
    np_params = _recipe_params(seed)
    tr = convert.from_numpy(np_params, "cpu", requires_grad=True)
    # SGD: the update is linear in the gradient. (Adam's first update is
    # g / |g|, which turns rounding noise on a near-zero gradient into a
    # full-size step, so it cannot show that two gradients agree.)
    opt = optim.make_optimizer("sgd", lr=1e-2).init(tr)
    step_fn = step_lib.make_train_step(_port_forward(), opt, accum_steps=accum)
    metrics = step_fn(tr, {}, batch)
    return tr, metrics


def test_accumulation_equals_one_step_on_the_same_batch():
    xs, ys = _recipe_data(2)
    batch = {"input": torch.tensor(xs[0]), "label": torch.tensor(ys[0])}
    p1, m1 = _one_step(1, batch)
    p4, m4 = _one_step(4, batch)
    np.testing.assert_allclose(m4["loss"].item(), m1["loss"].item(), atol=1e-5)
    np.testing.assert_allclose(m4["acc"].item(), m1["acc"].item(), atol=1e-5)
    for (path, a), (_, b) in zip(leaves_with_path(p1), leaves_with_path(p4)):
        np.testing.assert_allclose(
            a.detach().numpy(), b.detach().numpy(), atol=1e-5, err_msg="/".join(path)
        )
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), atol=1e-5)


def test_accumulation_refuses_a_remainder():
    xs, ys = _recipe_data(2)
    batch = {"input": torch.tensor(xs[0][:6]), "label": torch.tensor(ys[0][:6])}
    with pytest.raises(ValueError, match="not divisible"):
        _one_step(4, batch)


# ------------------------------------------------ the slice as a whole, BF16

IMG, PATCH, SDIM, SDEPTH, SHEADS, NCLS = 32, 8, 128, 2, 2, 10


@pytest.mark.parametrize("track", ["frozen", "full"])
def test_image_slice_bf16_training_matches_jax(track):
    jcfg = jic.ImageClassifierConfig(
        tokenizer=jtok.ImageTokenizerConfig(IMG, PATCH, 3, SDIM),
        encoder=jenc.EncoderConfig(dim=SDIM, depth=SDEPTH, num_heads=SHEADS),
        num_classes=NCLS,
    )
    cfg = ic.ImageClassifierConfig(
        tokenizer=tok.ImageTokenizerConfig(IMG, PATCH, 3, SDIM),
        encoder=enc.EncoderConfig(dim=SDIM, depth=SDEPTH, num_heads=SHEADS),
        num_classes=NCLS,
    )
    assert enc._resolve_impl(cfg.encoder, 17, enc.BF16) == "fused"
    np_params = jax.tree.map(np.asarray, jic.init(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(4)
    images = rng.standard_normal((8, IMG, IMG, 3)).astype(np.float32)
    labels = (np.arange(8) % NCLS).astype(np.int64)
    frozen_keys = jstep.FROZEN_KEYS if track == "frozen" else ()

    tx = optax.adamw(1e-3, weight_decay=0.05)
    jtr, jfr = jstep.split_params(jax.tree.map(jnp.asarray, np_params), frozen_keys)
    jstep_fn = jax.jit(jstep.make_train_step(
        lambda p, x, r: jic.forward(p, x, jcfg, precision=jenc.BF16), tx
    ))
    opt_state = tx.init(jtr)

    tr_np, fr_np = step_lib.split_params(np_params, frozen_keys)
    tr = convert.from_numpy(tr_np, "cpu", requires_grad=True)
    fr = convert.from_numpy(fr_np, "cpu")
    if "encoder" in fr:  # a frozen encoder is cast once, outside the step
        fr["encoder"] = enc.cast_params(fr["encoder"], enc.BF16)
    before = {k: v.clone() for k, v in fr.get("encoder", {}).items()}
    opt = optim.make_optimizer("adamw", lr=1e-3, weight_decay=0.05).init(tr)
    step_fn = step_lib.make_train_step(
        lambda p, x, g: ic.forward(p, x, cfg, enc.BF16, train=True, generator=g), opt
    )
    gen = torch.Generator().manual_seed(0)
    for _ in range(5):
        jtr, opt_state, jm = jstep_fn(
            jtr, jfr, opt_state,
            {"input": jnp.asarray(images), "label": jnp.asarray(labels.astype(np.int32))}, None,
        )
        m = step_fn(tr, fr, {"input": torch.tensor(images), "label": torch.tensor(labels)}, gen)
        assert math.isfinite(m["loss"].item())
        assert abs(m["loss"].item() - float(jm["loss"])) <= 0.05
    for k, v in before.items():
        assert torch.equal(fr["encoder"][k], v), k
        assert fr["encoder"][k].grad is None
    if track == "full":
        moved = (tr["encoder"]["qkv_w"].detach() - torch.tensor(np_params["encoder"]["qkv_w"]))
        assert moved.abs().max() > 0


def test_image_forward_is_differentiable_in_every_leaf_and_the_image():
    cfg = ic.ImageClassifierConfig(
        tokenizer=tok.ImageTokenizerConfig(IMG, PATCH, 3, SDIM),
        encoder=enc.EncoderConfig(dim=SDIM, depth=SDEPTH, num_heads=SHEADS),
        num_classes=NCLS,
    )
    params = ic.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    leaves = leaves_with_path(params)
    for _, leaf in leaves:
        leaf.requires_grad_(True)
    images = torch.randn(2, IMG, IMG, 3, generator=torch.Generator().manual_seed(1))
    images.requires_grad_(True)
    for precision in (enc.FP32, enc.BF16):
        logits = ic.forward(params, images, cfg, precision, train=True,
                            generator=torch.Generator().manual_seed(2))
        logits.square().sum().backward()
        assert images.grad is not None and images.grad.abs().max() > 0
        for path, leaf in leaves:
            assert leaf.grad is not None and torch.isfinite(leaf.grad).all(), path
            assert leaf.grad.dtype == leaf.dtype == torch.float32
            leaf.grad = None
        images.grad = None
    # the serving wrapper stays under no_grad
    model = ic.ImageClassifier(cfg, params, device="cpu")
    assert not model(images.detach()).requires_grad
