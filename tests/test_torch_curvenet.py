"""The port's CurveNet (models/curvenet.py) against the JAX package on the
CPU, FP32, at the recipe's smoke geometry (64 points, one curve stage of 8
curves of 3 steps), with the port's seeded weights, perturbed, carried
across: the walk's curves at 1e-5 on a kNN graph the test builds, and the
logits, gradients and tree as in tests/test_torch_point_baselines.py
(FWD_TOL 1e-5, ZOO_GRAD_TOL 1e-3). The walk's choices (``walk_choice``) and
the curves' starts (``curve_starts``) are equal between the packages on
these inputs; a near-tie could choose differently on another device, which
is why the card check replays them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metatransformer_tpu.models import curvenet as jcn
from metatransformer_tpu.ops import point_ops as jpo
from metatransformer_tpu_torch.core import convert
from metatransformer_tpu_torch.models import curvenet as cn
from metatransformer_tpu_torch.ops import point_ops as po
from tests.test_torch_point_baselines import check_forward, check_gradients, check_tree

torch.set_num_threads(1)
WALK_TOL = 1e-5


@pytest.mark.parametrize("curve_length", [1, 4])
def test_walk_matches_jax(curve_length):
    """Curves of 3 agents over a 16-node kNN graph, with perturbed agent
    and momentum weights (BatchNorm scales away from 1)."""
    rng = np.random.default_rng(curve_length)
    x = rng.standard_normal((2, 16, 4)).astype(np.float32)
    xyz = rng.standard_normal((2, 16, 3)).astype(np.float32)
    adj = np.asarray(jpo.knn(jnp.asarray(xyz), jnp.asarray(xyz), 5)[1])[..., 1:]
    np.testing.assert_array_equal(po.knn(torch.tensor(xyz), torch.tensor(xyz), 5)[1][..., 1:],
                                  adj)
    params = {k: {"w": rng.standard_normal((8, c)).astype(np.float32),
                  "bn_scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                  "bn_bias": rng.standard_normal(c).astype(np.float32) * 0.1}
              for k, c in (("agent", 1), ("momentum", 2))}
    start = np.asarray([[0, 5, 9], [3, 3, 12]])
    want = jcn._walk(jax.tree.map(jnp.asarray, params), jnp.asarray(x), jnp.asarray(adj),
                     jnp.asarray(start, jnp.int32), curve_length)
    got = cn._walk(convert.from_numpy(params, "cpu"), torch.tensor(x), torch.tensor(adj).long(),
                   torch.tensor(start), curve_length)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=WALK_TOL, atol=WALK_TOL)
    # every step lands on a node's own features
    d = (got[..., None, :] - torch.tensor(x)[:, None, None]).abs().sum(-1)
    assert (d.amin(-1) < 1e-6).all()


def test_the_walk_choice_and_starts_are_the_argmax_and_top_k():
    soft = torch.tensor([[[0.2, 0.5, 0.5, 0.1]]])
    assert cn.walk_choice(soft).tolist() == [[1]]  # ties to the first
    score = torch.tensor([[0.1, 0.9, 0.3, 0.7]])
    assert cn.curve_starts(score, 2).tolist() == [[1, 3]]


def test_forward_matches_jax():
    check_forward("CurveNet")


def test_gradients_match_jax():
    """The straight-through one-hot carries the softmax's gradient into the
    agent and momentum MLPs, as the reference's."""
    check_gradients("CurveNet")


def test_init_tree_has_jax_keys_and_shapes():
    check_tree("CurveNet")


def test_init_takes_the_card_or_raises(monkeypatch):
    from metatransformer_tpu_torch import recipes

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cn.init(recipes._point_zoo_smoke_cfg("CurveNet", 4), torch.Generator().manual_seed(0))
