"""Point-cloud core ops: furthest-point sampling, kNN, ball query, gather.

Port of ``metatransformer_tpu/ops/point_ops.py``. Furthest-point sampling
(FPS) is the one op the reference wrote as a Pallas kernel (``_fps_kernel``,
``ops/point_ops.py:67``); here it is a hand-written CUDA kernel
(``csrc/point_ops.cu``, ``mt_fps``) beside its plain PyTorch version. kNN,
ball query and the gathers were XLA programs in the reference and are plain
torch here (``topk``, advanced indexing, one small matmul).

Dispatch of :func:`furthest_point_sample` depends only on where ``points``
lies: a CPU tensor runs :func:`furthest_point_sample_plain`, a CUDA tensor
launches the kernel (:func:`fps_cuda`) or raises. There is no fallback
between the two and no switch. The kernel's launch plan comes from N alone
(:func:`_fps_plan`): the cloud in the registers of one block, in those of a
thread block cluster of up to 8 blocks (N > 2,048), or, past the largest
cluster's 65,536 points, read from device memory every round.

FPS returns integers, so kernel and plain version agree index for index, not
within a tolerance. Both compute ``d = (dx*dx + dy*dy) + dz*dz`` with every
operation rounded on its own, start the running minimum at +inf, put index 0
in slot 0, and take the first index among equal maxima. Coordinates must be
finite.

Index dtype: every index this module returns is ``torch.int64``, which
torch's gathers and advanced indexing take (the reference returns int32;
the kernel writes int32 and the wrapper widens it).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from metatransformer_tpu_torch.ops import fused_block as _fb


def square_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[B, M, 3], [B, N, 3] -> [B, M, N] squared euclidean distances, as
    ``aa + bb - 2 ab`` clamped at 0. The ``ab`` product is a library fp32
    matmul: on a CUDA card ``torch.backends.cuda.matmul.allow_tf32`` must be
    False (PyTorch's default), or near neighbours change order."""
    aa = (a * a).sum(dim=-1)[:, :, None]
    bb = (b * b).sum(dim=-1)[:, None, :]
    ab = a @ b.transpose(1, 2)
    return (aa + bb - 2.0 * ab).clamp_min(0.0)


# --------------------------------------------------------------------------
# Furthest-point sampling: plain version, CUDA wrapper, dispatch
# --------------------------------------------------------------------------


def furthest_point_sample_plain(points: torch.Tensor, n_samples: int) -> torch.Tensor:
    """Plain version of the FPS kernel: [B, N, 3] -> [B, n_samples] int64.

    Works on the three coordinate planes and sums the squares left to right,
    which fixes the rounding (a sum over the last axis would leave its order
    to the library)."""
    b, n, _ = points.shape
    x, y, z = points.detach().float().unbind(-1)  # [B, N] each
    min_d = torch.full((b, n), float("inf"), dtype=torch.float32, device=points.device)
    idx = torch.zeros((b, n_samples), dtype=torch.int64, device=points.device)
    last = idx[:, :1]  # slot 0 holds index 0
    for i in range(1, n_samples):
        dx, dy, dz = x - x.gather(1, last), y - y.gather(1, last), z - z.gather(1, last)
        d = dx * dx + dy * dy + dz * dz
        min_d = torch.minimum(min_d, d)
        last = min_d.argmax(dim=-1, keepdim=True)  # first index among equal maxima
        idx[:, i] = last[:, 0]
    return idx


# The launch plan of the FPS kernel (csrc/point_ops.cu). A block holds up to
# FPS_BLOCK_MAX points in registers (1024 threads x 8 or 512 x 16); a cloud
# runs on one block up to _FPS_ONE_BLOCK points, on a thread block cluster of
# at most FPS_MAX_CLUSTER blocks of about _FPS_CLUSTER_SHARE points each up to
# FPS_CLUSTER_MAX points, and past that on the device-memory route. A block
# takes the fewest points a thread of _FPS_PPT (at least _FPS_CLUSTER_MIN_PPT
# in a cluster, where every warp also waits for and reduces the blocks'
# messages) that keeps it within _FPS_THREADS threads: the fastest plans on
# an H100 (``chip_smoke.py --fps-plans``, PERF.md).
FPS_BLOCK_MAX = 8192
FPS_MAX_CLUSTER = 8
FPS_CLUSTER_MAX = FPS_MAX_CLUSTER * FPS_BLOCK_MAX  # 65,536
_FPS_PPT = (4, 8, 16)  # points a thread the kernel is compiled for
_FPS_CLUSTER_MIN_PPT = 8
_FPS_THREADS = 512
_FPS_ONE_BLOCK = 2048
_FPS_CLUSTER_SHARE = 1024
_FPS_DEVICE_THREADS = 1024


class FpsPlan(NamedTuple):
    route: str  # "block", "cluster" or "device"
    cluster: int  # blocks a cloud (0 on the device route)
    threads: int  # threads a block
    ppt: int  # points a thread (0 on the device route)


def _fps_plan(n: int) -> FpsPlan:
    """The launch plan of the FPS kernel for a cloud of n points."""
    if n > FPS_CLUSTER_MAX:
        return FpsPlan("device", 0, _FPS_DEVICE_THREADS, 0)
    blocks = 1 if n <= _FPS_ONE_BLOCK else min(FPS_MAX_CLUSTER, -(-n // _FPS_CLUSTER_SHARE))
    share = -(-n // blocks)
    least = _FPS_PPT[0] if blocks == 1 else _FPS_CLUSTER_MIN_PPT
    ppt = next((p for p in _FPS_PPT if p >= least and -(-share // p) <= _FPS_THREADS),
               _FPS_PPT[-1])
    threads = max(32, -(-share // (32 * ppt)) * 32)
    cluster = -(-n // (threads * ppt))
    return FpsPlan("block" if cluster == 1 else "cluster", cluster, threads, ppt)


def fps_cuda(points: torch.Tensor, n_samples: int) -> torch.Tensor:
    """Launch the FPS kernel. points: [B, N, 3] fp32 on a CUDA device, any
    strides; returns [B, n_samples] int64."""
    from metatransformer_tpu_torch.ops import _build

    if points.dim() != 3 or points.shape[-1] != 3:
        raise ValueError(f"points must be [B, N, 3], got {tuple(points.shape)}")
    if points.device.type != "cuda":
        raise ValueError(f"points is on {points.device}, the kernel needs a CUDA device")
    if points.dtype != torch.float32:
        raise TypeError(f"points has dtype {points.dtype}, the kernel takes float32")
    b, n, _ = points.shape
    if min(b, n, n_samples) < 1 or n >= 2**31:
        raise ValueError(f"empty or oversized problem: B={b}, N={n}, n_samples={n_samples}")
    if points.data_ptr() % 4:
        raise ValueError("points must be 4-byte aligned")
    lib = _build.library()
    plan = _fps_plan(n)
    out = torch.empty((b, n_samples), dtype=torch.int32, device=points.device)
    scratch = None
    if plan.route == "device":  # the running minimum lives in device memory
        scratch = torch.empty((b, n), dtype=torch.float32, device=points.device)
    with torch.cuda.device(points.device):  # the launch goes to its current stream
        rc = lib.mt_fps(
            points.data_ptr(), *points.stride(),
            None if scratch is None else scratch.data_ptr(), out.data_ptr(),
            b, n, n_samples, plan.cluster, plan.threads, plan.ppt,
            torch.cuda.current_stream().cuda_stream,
        )
    _fb._raise_on(rc, "fps")
    fps_cuda.launches += 1
    return out.long()


fps_cuda.launches = 0


def launch_counts() -> dict:
    return {"fps": fps_cuda.launches}


def reset_launch_counts() -> None:
    fps_cuda.launches = 0


def furthest_point_sample(points: torch.Tensor, n_samples: int) -> torch.Tensor:
    """FPS indices [B, n_samples] (int64). Starts at index 0.

    ``points`` is [B, N, 3] of any float dtype and any strides; it is
    computed in fp32. Indices carry no gradient: training differentiates
    through the gathers that follow."""
    if points.dim() != 3 or points.shape[-1] != 3:
        raise ValueError(f"points must be [B, N, 3], got {tuple(points.shape)}")
    if not points.is_floating_point():
        raise TypeError(f"points must be floating point, got {points.dtype}")
    fn = _fb._route(points, furthest_point_sample_plain, fps_cuda)
    with torch.no_grad():
        return fn(points.detach().float(), int(n_samples))


def masked_fps(points: torch.Tensor, mask: torch.Tensor, n_samples: int) -> torch.Tensor:
    """FPS over a masked point set -> idx [B, n_samples]. Invalid points
    are collapsed onto the first valid point's coordinates so FPS never
    prefers them (a far sentinel would be maximally distant and get
    picked first: the opposite of ignoring it)."""
    first_valid = mask.to(torch.uint8).argmax(dim=-1)  # [B], first True
    anchor = gather_points(points, first_valid[:, None])  # [B, 1, 3]
    safe = torch.where(mask[..., None], points, anchor)
    return furthest_point_sample(safe, n_samples)


def random_sample(
    generator: torch.Generator, points: torch.Tensor, n_samples: int
) -> torch.Tensor:
    """Random subsample indices without replacement, [B, n_samples] on
    ``points``' device: the first n_samples of a per-sample permutation,
    drawn from ``generator`` on its own device."""
    b, n, _ = points.shape
    noise = torch.rand(b, n, generator=generator, device=generator.device)
    return noise.argsort(dim=-1)[:, :n_samples].to(points.device)


# --------------------------------------------------------------------------
# Neighbourhoods
# --------------------------------------------------------------------------


def knn(
    centers: torch.Tensor, points: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest neighbors of each center, nearest first.
    -> (dists [B, M, k], idx [B, M, k])."""
    d = square_dists(centers, points)
    neg, idx = torch.topk(-d, k, dim=-1)
    return -neg, idx


def ball_query(
    centers: torch.Tensor, points: torch.Tensor, radius: float, k: int
) -> torch.Tensor:
    """First k in-radius neighbor indices; empty slots repeat the first hit,
    a center with no hit at all gets index 0. -> idx [B, M, k]."""
    d = square_dists(centers, points)  # [B, M, N]
    n = points.shape[1]
    inside = d < radius * radius
    # Prefer in-radius points in original order: key = -index for inside,
    # -(index + n) for outside, so topk picks in-radius ascending-index first.
    # The keys are floats and exact while 2 n < 2**24.
    order = torch.arange(n, dtype=torch.float32, device=d.device)
    key = torch.where(inside, -order, -(order + n))
    idx = torch.topk(key, k, dim=-1).indices
    count = inside.sum(dim=-1, keepdim=True)
    slot = torch.arange(k, device=d.device)
    idx = torch.where(slot < count, idx, idx[..., :1])
    return torch.where(count > 0, idx, 0)


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points [B, N, C], idx [B, ...] int -> [B, ..., C]."""
    batch = torch.arange(points.shape[0], device=points.device)
    return points[batch.view(-1, *([1] * (idx.dim() - 1))), idx]


def group_points(
    centers: torch.Tensor,
    points: torch.Tensor,
    idx: torch.Tensor,
    features: Optional[torch.Tensor] = None,
    relative_xyz: bool = True,
    normalize_dp: bool = False,
):
    """Gather neighborhoods. -> (dp [B, M, K, 3], fj [B, M, K, C] or None).

    dp = neighbor - center when relative_xyz, optionally normalized by the
    sample's max |dp|.
    """
    grouped_p = gather_points(points, idx)  # [B, M, K, 3]
    dp = grouped_p - centers[:, :, None, :] if relative_xyz else grouped_p
    if normalize_dp:
        scale = dp.abs().amax(dim=(1, 2, 3), keepdim=True)
        dp = dp / scale.clamp_min(1e-8)
    fj = gather_points(features, idx) if features is not None else None
    return dp, fj
