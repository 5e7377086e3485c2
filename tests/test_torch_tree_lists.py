"""Parameter trees that hold lists (Mask2Former keeps one dict per decoder
layer in a list) through the port's tree helpers (``core/tree.py``) and
their callers, against jax.tree_util and optax: ``convert.from_numpy`` /
``to_numpy``, the leaf order and the optimizer state, the ``Trainer``'s
device copies and checkpoint resume, micro-batches, and ``ema``. FP32 on
the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metatransformer_tpu.train import optim as joptim
from metatransformer_tpu.train import step as jstep
from metatransformer_tpu_torch.core import convert
from metatransformer_tpu_torch.core.tree import leaves, leaves_with_path, tree_map, unflatten_like
from metatransformer_tpu_torch.train import ema, optim
from metatransformer_tpu_torch.train import step as step_lib
from metatransformer_tpu_torch.train.trainer import Trainer, TrainerConfig
from metatransformer_tpu_torch.utils import checkpoint

torch.set_num_threads(1)
LR, WD = 1e-2, 0.05


def _tree():
    rng = np.random.default_rng(5)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"b": [{"w": f(3, 4)}, {"w": f(4, 2), "v": f(2)}], "a": f(2)}


def _batches():
    rng = np.random.default_rng(6)
    return [{"input": rng.standard_normal((4, 3)).astype(np.float32),
             "label": rng.integers(0, 2, 4).astype(np.int64)} for _ in range(2)]


def _forward(p, x, gen):
    return x @ p["b"][0]["w"] @ p["b"][1]["w"] + p["b"][1]["v"] * p["a"]


def _jforward(p, x, rng):
    return x @ p["b"][0]["w"] @ p["b"][1]["w"] + p["b"][1]["v"] * p["a"]


def _jax_paths(tree):
    keys = lambda path: tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)  # noqa: E731
    return [keys(path) for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def test_convert_carries_lists_both_ways():
    tree = _tree()
    got = convert.from_numpy(tree, "cpu")
    assert isinstance(got["b"], list) and len(got["b"]) == 2
    assert isinstance(got["b"][1]["v"], torch.Tensor)
    back = convert.to_numpy(got)
    for (pa, a), (pb, b) in zip(leaves_with_path(back), leaves_with_path(tree)):
        assert pa == pb
        np.testing.assert_array_equal(a, b)


def test_leaf_order_is_jax_tree_util_order():
    tree = _tree()
    paths = [p for p, _ in leaves_with_path(tree)]
    assert paths == _jax_paths(tree) == [("a",), ("b", 0, "w"), ("b", 1, "v"), ("b", 1, "w")]
    leaves = [leaf for _, leaf in leaves_with_path(tree)]
    rebuilt = unflatten_like(tree, leaves)
    assert isinstance(rebuilt["b"], list) and rebuilt["b"][1]["v"] is tree["b"][1]["v"]


def test_none_is_an_empty_subtree_and_containers_keep_their_types():
    """As in jax.tree_util: None holds no leaf and maps to None; tuples stay
    tuples; a tree_map over two trees pairs their leaves."""
    tree = {"z": None, "t": (np.ones(2), [np.zeros(1)]), "a": np.float32(3)}
    assert [p for p, _ in leaves_with_path(tree)] == _jax_paths(tree)
    assert len(leaves(tree)) == len(jax.tree_util.tree_leaves(tree)) == 3
    doubled = tree_map(lambda x: x * 2, tree)
    assert doubled["z"] is None and isinstance(doubled["t"], tuple)
    assert isinstance(doubled["t"][1], list)
    summed = tree_map(lambda x, y: x + y, tree, doubled)
    np.testing.assert_array_equal(summed["t"][0], 3 * np.ones(2))
    assert summed["a"] == 9
    with pytest.raises(ValueError):
        unflatten_like(tree, leaves(tree) + [0])


def test_micro_batches_split_every_leaf_of_lists_and_keep_none():
    batch = {"x": [torch.arange(4.0), torch.arange(8.0).reshape(4, 2)], "m": None}
    micro = step_lib._to_micro(batch, 2)
    assert len(micro) == 2 and micro[1]["m"] is None and isinstance(micro[1]["x"], list)
    torch.testing.assert_close(micro[1]["x"][0], torch.tensor([2.0, 3.0]))
    torch.testing.assert_close(micro[0]["x"][1], torch.arange(4.0).reshape(2, 2))
    with pytest.raises(ValueError, match="accum_steps=3"):
        step_lib._to_micro(batch, 3)


def _trainer(tree):
    return Trainer(_forward, optim.build("adamw", LR, weight_decay=WD), tree,
                   cfg=TrainerConfig(use_ema=True, ema_decay=0.5), frozen_keys=(),
                   device="cpu")


def test_two_adamw_steps_and_a_checkpoint_round_trip_match_optax(tmp_path):
    tree = _tree()
    trainer = _trainer(convert.from_numpy(tree, "cpu"))
    assert isinstance(trainer.trainable["b"], list)
    trainer.train_epoch(_batches())

    tx = joptim.build("adamw", LR, weight_decay=WD)
    step = jax.jit(jstep.make_train_step(_jforward, tx))
    jparams = jax.tree.map(jnp.asarray, tree)
    state = tx.init(jparams)
    jema = jparams
    for batch in _batches():
        jparams, state, _ = step(jparams, {}, state, jax.tree.map(jnp.asarray, batch), None)
        jema = jax.tree.map(lambda e, p: e * 0.5 + p * 0.5, jema, jparams)
    for (path, got), (_, want) in zip(leaves_with_path(trainer.trainable),
                                      leaves_with_path(jax.tree.map(np.asarray, jparams))):
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6, atol=1e-6,
                                   err_msg=str(path))
    for (path, got), (_, want) in zip(leaves_with_path(trainer.ema_params),
                                      leaves_with_path(jax.tree.map(np.asarray, jema))):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6, err_msg=str(path))
    # the optimizer state as jax.tree_util.tree_leaves of optax's, leaf for leaf
    got_state = trainer.optimizer.state_leaves()
    want_state = jax.tree_util.tree_leaves(state)
    assert len(got_state) == len(want_state) == 1 + 2 * 4
    for got, want in zip(got_state, want_state):
        got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        assert got.shape == np.shape(want)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-7)

    path = str(tmp_path / "ckpt.npz")
    checkpoint.save(path, trainer._ckpt_state())
    resumed = _trainer(convert.from_numpy(_tree(), "cpu"))
    resumed._load_state(checkpoint.load(path, "cpu"), epoch=0)
    for tree_a, tree_b in ((resumed.trainable, trainer.trainable),
                           (resumed.ema_params, trainer.ema_params)):
        for (pa, a), (pb, b) in zip(leaves_with_path(tree_a),
                                    leaves_with_path(tree_b)):
            assert pa == pb
            assert torch.equal(a.detach(), b.detach())
    assert resumed.optimizer.count == trainer.optimizer.count == 2
    for a, b in zip(resumed.optimizer.state_leaves()[1:], got_state[1:]):
        assert torch.equal(a, b)


def test_ema_maps_over_lists():
    params = convert.from_numpy(_tree(), "cpu")
    avg = ema.init(params)
    assert isinstance(avg["b"], list) and avg["b"][0]["w"] is not params["b"][0]["w"]
    bumped = {"a": params["a"] + 2.0, "b": [{"w": params["b"][0]["w"] + 2.0},
                                           {"w": params["b"][1]["w"], "v": params["b"][1]["v"]}]}
    ema.update(avg, bumped, decay=0.75)
    torch.testing.assert_close(avg["a"], params["a"] + 0.5)
    torch.testing.assert_close(avg["b"][0]["w"], params["b"][0]["w"] + 0.5)
    torch.testing.assert_close(avg["b"][1]["v"], params["b"][1]["v"])
