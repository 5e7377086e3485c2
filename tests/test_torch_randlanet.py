"""The port's RandLA-Net (models/randlanet.py) against the JAX package on
the CPU, FP32, at the recipe's smoke geometry (tests/point_seg_parity.py):
logits, every gradient leaf and the init's shapes.

The reference draws its decimation permutation from
``jax.random.PRNGKey(0)`` when no key is passed, as its recipe does; the
port takes the permutation as ``perm``, and here JAX's draw is passed in.
Without one the port draws its own from a ``torch.Generator`` seeded 0
(``default_perm``), a fixed permutation as the reference's is.
"""

import functools

import jax
import pytest
import torch

from metatransformer_tpu.models import randlanet as jrl
from metatransformer_tpu_torch.models import randlanet as rl
from tests import point_seg_parity as psp

torch.set_num_threads(1)
SMOKE = dict(num_classes=psp.NUM_CLASSES, d_in=3, num_neighbors=8, enc_dims=(8, 16),
             head_dims=(16,))
CFG, JCFG = rl.RandLANetConfig(**SMOKE), jrl.RandLANetConfig(**SMOKE)


@functools.lru_cache(maxsize=None)
def jax_perm(n=psp.N_POINTS):
    return tuple(int(i) for i in jax.random.permutation(jax.random.PRNGKey(0), n))


def run():
    return psp.seg_pair(jrl, rl, CFG, JCFG, perm=jax_perm())


def test_forward_matches_jax_with_its_permutation():
    psp.check_forward(rl, CFG, run())


def test_gradients_match_jax():
    psp.check_gradients(rl, CFG, run())


def test_init_tree_has_jax_keys_and_shapes():
    psp.check_tree(rl, CFG, run())


def test_the_default_permutation_is_fixed_and_used():
    """Without ``perm`` the port draws one fixed permutation (a generator
    seeded 0), the same at every call, and decimates by it."""
    a, b = rl.default_perm(psp.N_POINTS, "cpu"), rl.default_perm(psp.N_POINTS, "cpu")
    assert torch.equal(a, b) and sorted(a.tolist()) == list(range(psp.N_POINTS))
    r = run()
    params = psp.convert.from_numpy(r["tree"], "cpu")
    with torch.no_grad():
        got = rl.forward(params, torch.tensor(r["pts"]), CFG)
        want = rl.forward(params, torch.tensor(r["pts"]), CFG, perm=a)
    assert torch.equal(got, want)


def test_the_leaky_slopes_replay_their_gates():
    """Both leaky slopes (0.2 and 0.01) and the ReLUs take their gradient
    through ``gates.act_gate``: every gate the forward asks for
    is one of the activations' inputs."""
    from unittest import mock

    from metatransformer_tpu_torch.ops import gates

    slopes, gate = [], gates.act_gate
    r = run()
    params = psp.convert.from_numpy(r["tree"], "cpu")
    for leaf in psp.leaves_with_path(params):
        leaf[1].requires_grad_(True)
    with mock.patch.object(gates, "act_gate", lambda x, s: slopes.append(s) or gate(x, s)):
        psp.port_forward(rl, CFG, r, params).sum().backward()
    assert set(slopes) == {0.0, 0.2, 0.01}


@pytest.mark.parametrize("features", [None, 3])
def test_init_takes_the_card_or_raises(features, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        rl.init(rl.RandLANetConfig(d_in=features or 3), torch.Generator().manual_seed(0))


def test_registered():
    from metatransformer_tpu_torch.utils.registry import MODELS

    entry = MODELS.get("RandLANet")
    assert entry.forward is rl.forward and entry.Config is rl.RandLANetConfig
