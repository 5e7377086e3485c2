"""The port's PointTransformerSeg (models/point_transformer_seg.py) against
the JAX package on the CPU at the recipe's smoke geometry
(tests/point_seg_parity.py), in float64 on both sides: the reference's
fp32 logits stand 5.1e-6 of the largest from float64, the port's 1.7e-6,
so the reference's fp32 is the less exact (its fp32 gradients 6.9e-5 of a
leaf's largest, the port's 5.8e-5). The FPS indices of the two strided
stages are held equal to the reference's in fp32 and replayed in its
float64 run. Also with the recipe's 6 feature channels.
"""

import pytest
import torch

from metatransformer_tpu.models import point_transformer_seg as jpt
from metatransformer_tpu_torch.models import point_transformer_seg as pt
from tests import point_seg_parity as psp

torch.set_num_threads(1)
SMOKE = dict(num_classes=psp.NUM_CLASSES, width=8, blocks=(2, 2, 2), strides=(1, 4, 4),
             nsample=(8, 8, 8), share_planes=4)


def run(channels):
    cfg = pt.PointTransformerSegConfig(in_channels=channels, **SMOKE)
    jcfg = jpt.PointTransformerSegConfig(in_channels=channels, **SMOKE)
    return cfg, psp.seg_pair(jpt, pt, cfg, jcfg, in64=True,
                             features=channels if channels != 3 else 0)


@pytest.mark.parametrize("channels", [3, 6])
def test_forward_matches_jax(channels):
    cfg, r = run(channels)
    psp.check_forward(pt, cfg, r)


@pytest.mark.parametrize("channels", [3, 6])
def test_gradients_match_jax(channels):
    cfg, r = run(channels)
    psp.check_gradients(pt, cfg, r)


def test_init_tree_has_jax_keys_and_shapes():
    cfg, r = run(6)
    psp.check_tree(pt, cfg, r)


def test_fps_draws_each_strided_stage_index_equal():
    _, r = run(3)
    assert [(p.shape[1], n) for p, n, _ in r["calls"]] == [(64, 16), (16, 4)]


def test_init_takes_the_card_or_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.init(pt.PointTransformerSegConfig(), torch.Generator().manual_seed(0))
