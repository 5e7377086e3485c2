"""The port's BAAF-Net (models/baafnet.py) against the JAX package on the
CPU, FP32, at the recipe's smoke geometry (tests/point_seg_parity.py):
logits, every gradient leaf, the FPS indices of its two downsamplings and
the init's shapes. The two fp32 runs stand equally far from float64 here
(logits 1.8e-6 port, 1.7e-6 reference), so the reference runs in fp32.
"""

import pytest
import torch

from metatransformer_tpu.models import baafnet as jbf
from metatransformer_tpu_torch.models import baafnet as bf
from tests import point_seg_parity as psp

torch.set_num_threads(1)
SMOKE = dict(num_classes=psp.NUM_CLASSES, d_in=3, k=8, dims=(4, 8, 16))
CFG, JCFG = bf.BAAFNetConfig(**SMOKE), jbf.BAAFNetConfig(**SMOKE)


def run():
    return psp.seg_pair(jbf, bf, CFG, JCFG)


def test_forward_matches_jax():
    psp.check_forward(bf, CFG, run())


def test_gradients_match_jax():
    psp.check_gradients(bf, CFG, run())


def test_init_tree_has_jax_keys_and_shapes():
    psp.check_tree(bf, CFG, run())


def test_fps_draws_each_level_index_equal():
    """Two levels, FPS 4x each (64 -> 16 -> 4), equal to the reference's
    (held in ``seg_pair``)."""
    assert [(p.shape[1], n) for p, n, _ in run()["calls"]] == [(64, 16), (16, 4)]


def test_init_takes_the_card_or_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bf.init(CFG, torch.Generator().manual_seed(0))
