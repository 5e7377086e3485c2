"""The port's SimpleView (models/simpleview.py) against the JAX package on
the CPU, FP32, at the recipe's smoke geometry (32 x 32 depth images, one
BasicBlock a stage, 4 channels), with the port's seeded weights, perturbed,
carried across: the six depth projections at PROJ_TOL (1e-5, the zoo's
forward tolerance) with the same pixels hit, and the logits, gradients and
tree as in tests/test_torch_point_baselines.py (FWD_TOL 1e-5, ZOO_GRAD_TOL
1e-3). Its convs run on the library conv with XLA's "SAME" padding
(asymmetric at stride 2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metatransformer_tpu.models import simpleview as jsv
from metatransformer_tpu_torch import recipes
from metatransformer_tpu_torch.models import simpleview as sv
from tests.test_torch_point_baselines import check_forward, check_gradients, check_tree

torch.set_num_threads(1)
PROJ_TOL = 1e-5


@pytest.mark.parametrize("resolution, size_xy, scale", [(32, 1, 0.4), (128, 1, 0.5),
                                                         (16, 4, 0.8)])
def test_projection_matches_jax(resolution, size_xy, scale):
    """Depth images of clouds that reach behind a camera and past the
    canvas at ``scale`` 0.8; a 4 x 4 splat patch at size_xy 4."""
    pts = (np.random.default_rng(resolution).standard_normal((2, 200, 3)) * scale).astype(
        np.float32)
    got = sv.project_views(torch.tensor(pts), resolution, size_xy)
    want = np.asarray(jsv.project_views(jnp.asarray(pts), resolution, size_xy))
    assert got.shape == want.shape == (12, resolution, resolution)
    np.testing.assert_array_equal(got.numpy() != 0, want != 0)
    np.testing.assert_allclose(got.numpy(), want, rtol=PROJ_TOL, atol=PROJ_TOL)
    assert ((got != 0).reshape(12, -1).sum(-1) > 0).all()


def test_forward_matches_jax():
    check_forward("SimpleView")


def test_gradients_match_jax():
    check_gradients("SimpleView")


def test_init_tree_has_jax_keys_and_shapes():
    check_tree("SimpleView")


def test_init_takes_the_card_or_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        sv.init(recipes._point_zoo_smoke_cfg("SimpleView", 4), torch.Generator().manual_seed(0))
