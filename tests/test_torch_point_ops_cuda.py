"""The port's furthest-point-sampling kernel against its plain PyTorch
version, on a card: index for index, no tolerance.

Without a CUDA card every test here skips. The card's machine has no JAX,
and tests/conftest.py imports it, so there this file runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_point_ops_cuda.py
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from metatransformer_tpu_torch import ops
from metatransformer_tpu_torch.ops import point_ops as po

torch.set_num_threads(1)


def _plan_changes(top=po.FPS_CLUSTER_MAX + 1):
    """Every N at which the launch plan changes its route or its cluster
    size, with the N just below it (a pure function of N: no card needed)."""
    out, prev = [], po._fps_plan(1)
    for n in range(2, top + 1):
        plan = po._fps_plan(n)
        if (plan.route, plan.cluster) != (prev.route, prev.cluster):
            out += [n - 1, n]
        prev = plan
    return out


PLAN_CHANGES = _plan_changes()


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _cloud(seed, b, n, dev, kind="normal"):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (b, n, 3)) if kind == "uniform" else rng.standard_normal((b, n, 3))
    return torch.tensor(pts.astype(np.float32)).to(dev)


def _check(pts, g):
    got = po.fps_cuda(pts, g)
    torch.cuda.synchronize()
    want = po.furthest_point_sample_plain(pts, g)
    assert got.dtype == torch.int64 and got.shape == want.shape
    assert torch.equal(got, want), (got != want).nonzero()[:4].tolist()
    assert torch.equal(po.fps_cuda(pts, g), got)  # repeats bit for bit


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b, n, g",
    [(1, 1024, 256), (64, 1024, 256), (8, 2048, 512), (32, 1024, 64), (3, 1, 1), (2, 33, 33),
     (2, 5, 9), (2, 14336, 64), (2, 14337, 64), (2, 16384, 1024), (1, 20000, 300)],
)
def test_fps_kernel_equals_plain_on_both_routes(b, n, g):
    dev = _card()
    _check(_cloud(b * 7 + n, b, n, dev, "uniform" if n % 2 else "normal"), g)


@pytest.mark.cuda
@pytest.mark.parametrize("n", PLAN_CHANGES)
def test_fps_kernel_equals_plain_at_each_change_of_plan(n):
    """Just below and just above each change of cluster size and of route:
    one block -> clusters of 3 to 8 blocks -> the device-memory route."""
    dev = _card()
    _check(_cloud(n, 2, n, dev), 48)


@pytest.mark.cuda
@settings(max_examples=40, deadline=None)
@given(b=st.integers(1, 5), n=st.integers(1, 1500), g=st.integers(1, 96),
       seed=st.integers(0, 2**16))
def test_fps_kernel_equals_plain_over_a_grid(b, n, g, seed):
    """N from 1 to 1500 gives blocks of 1 to 12 warps, whole and ragged."""
    dev = _card()
    _check(_cloud(seed, b, n, dev), g)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 16384, po.FPS_CLUSTER_MAX + 4])
def test_fps_kernel_ties_duplicates_and_masks(n):
    """Every point four times and more samples than distinct points (at
    16384 the copies of a point lie in four blocks of a cluster); then
    masked_fps, which collapses invalid points onto the first valid one."""
    dev = _card()
    base = _cloud(1, 2, n // 4, dev)
    pts = torch.cat([base] * 4, dim=1)
    _check(pts, min(n // 4 + 9, 200))
    cloud = _cloud(2, 3, n, dev)
    mask = torch.zeros(3, n, dtype=torch.bool, device=dev)
    mask[0, : n // 2] = True
    mask[1, 5:23] = True
    mask[2, ::3] = True
    ops.reset_launch_counts()
    got = po.masked_fps(cloud, mask, 40)
    assert ops.launch_counts()["fps"] == 1
    want = po.masked_fps(cloud.cpu(), mask.cpu(), 40)  # the plain version
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1024, 16384])
def test_fps_kernel_ties_across_the_blocks_of_a_cluster(n):
    """64 distinct points, each repeated n / 64 times, so every point has a
    copy in every block: the first copies win (smallest index), then every
    minimum is +0 and index 0 wins every round; a cloud of one repeated
    point gives +0 everywhere from round 1."""
    dev = _card()
    base = _cloud(7, 2, 64, dev)
    pts = base.repeat(1, n // 64, 1)
    got = po.fps_cuda(pts, 80)
    assert torch.equal(got, po.furthest_point_sample_plain(pts, 80))
    assert (got[:, :64] < 64).all() and (got[:, 64:] == 0).all()
    same = _cloud(8, 2, 1, dev).expand(2, n, 3)
    assert torch.equal(po.fps_cuda(same, 20), torch.zeros(2, 20, dtype=torch.int64, device=dev))


@pytest.mark.cuda
def test_fps_kernel_takes_strided_input_and_casts():
    dev = _card()
    pts = _cloud(3, 4, 500, dev)
    want = po.furthest_point_sample_plain(pts, 50)
    wide = torch.zeros(4, 500, 7, device=dev)
    wide[..., 2:5] = pts
    assert torch.equal(po.furthest_point_sample(wide[..., 2:5], 50), want)
    planes = pts.permute(2, 0, 1).contiguous().permute(1, 2, 0)  # [B, N, 3] view of [3, B, N]
    assert not planes.is_contiguous()
    assert torch.equal(po.furthest_point_sample(planes, 50), want)
    assert torch.equal(po.furthest_point_sample(pts.double(), 50), want)
    every_other = _cloud(4, 2, 600, dev)[:, ::2]
    assert torch.equal(po.furthest_point_sample(every_other, 30),
                       po.furthest_point_sample_plain(every_other.contiguous(), 30))
    for n in (16384, po.FPS_CLUSTER_MAX + 100):  # a cluster and the device-memory route
        big = _cloud(9, 2, n, dev)
        wide = torch.zeros(2, n, 5, device=dev)
        wide[..., 1:4] = big
        assert torch.equal(po.furthest_point_sample(wide[..., 1:4], 64),
                           po.furthest_point_sample_plain(big, 64))
    leaf = pts.clone().requires_grad_(True)
    assert not po.furthest_point_sample(leaf, 8).requires_grad


@pytest.mark.cuda
def test_fps_wrapper_raises_on_what_the_kernel_does_not_take():
    dev = _card()
    pts = _cloud(5, 2, 64, dev)
    with pytest.raises(TypeError):
        po.fps_cuda(pts.double(), 8)
    with pytest.raises(ValueError):
        po.fps_cuda(pts[..., :2], 8)
    with pytest.raises(ValueError):
        po.fps_cuda(pts, 0)
    with pytest.raises(ValueError):
        po.fps_cuda(pts.cpu(), 8)


@pytest.mark.cuda
@pytest.mark.parametrize("plan", [
    po.FpsPlan("block", 1, 48, 4),  # not whole warps
    po.FpsPlan("cluster", 2, 32, 4),  # two blocks where one holds the cloud
    po.FpsPlan("cluster", 9, 32, 1),  # past the largest cluster
    po.FpsPlan("block", 1, 64, 3),  # no kernel for 3 points a thread
    po.FpsPlan("device", 0, 1024, 0),  # the device route below its limit
])
def test_fps_refused_launch_raises_and_counts_nothing(monkeypatch, plan):
    """A plan the C function refuses comes back as an error code, and the
    wrapper raises on it: no other route is tried."""
    dev = _card()
    monkeypatch.setattr(po, "_fps_plan", lambda n: plan)
    before = ops.launch_counts()["fps"]
    with pytest.raises(RuntimeError, match="launch failed"):
        po.fps_cuda(_cloud(6, 2, 64, dev), 8)
    assert ops.launch_counts()["fps"] == before
