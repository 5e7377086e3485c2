"""One training step of the ADE20K and COCO Mask2Former recipes as the CLI
builds them (their optimizer, frozen keys and layer decay), against the JAX
package's on the CPU at smoke geometry under FP32, from the same perturbed
weights and batch: loss and update at 1e-5 (``check_step``,
tests/test_torch_segmentor.py). The port's loss takes JAX's random points,
reproduced from the step's key."""

import jax
import pytest
import torch

from metatransformer_tpu.heads import mask2former as jm2f
from metatransformer_tpu_torch.heads import mask2former as m2f
from tests.test_torch_mask2former import host_lsa_on_host_arrays  # noqa: F401 (autouse)
from tests.test_torch_mask2former import jax_loss_draws
from tests.test_torch_segmentor import check_step, recipe_step

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["ade20k_mask2former_metatransformer.yaml",
                                  "coco_mask2former_metatransformer.yaml"])
def test_mask2former_recipe_step_matches_jax(name, monkeypatch):
    """One step of the recipe as the CLI builds it, the port's loss on
    JAX's draws (recipe_step's key, 2 layers, 3 gt slots, 64 points)."""
    draws = jax_loss_draws(jax.random.PRNGKey(7), 2, 2, 3, 64, jm2f.Mask2FormerConfig())
    loss = m2f.loss

    def wrap():
        monkeypatch.setattr(m2f, "loss", lambda *a, **k: loss(*a, **k, draws=draws))

    check_step(*recipe_step(name, monkeypatch, wrap)[:6])
