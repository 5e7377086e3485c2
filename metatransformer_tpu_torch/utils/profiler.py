"""Profiling harness: parameter count and throughput of a forward.

Port of ``metatransformer_tpu/utils/profiler.py`` (the reference's
``PointCloud/examples/profile.py`` surface). The time is taken where the
inputs live: on the card with CUDA events after a warm-up call, on the CPU
with the host clock; each call's input depends on the last call's output,
so no call can be skipped or overlapped with the next.

``cost_analysis`` has no counterpart: the reference reads XLA's count of
the compiled program, and the port's hand-written kernels are called
through ``ctypes`` (``ops/_build.py``), where ``torch.utils.flop_counter``
cannot see them.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import torch

from metatransformer_tpu_torch.core.tree import leaves, tree_map

COST_ANALYSIS_ITEM = "ROADMAP.md queue 1, item 10 (a FLOP count of the port's programs)"


def count_params(params: Any) -> int:
    return int(sum(int(torch.as_tensor(x).numel()) for x in leaves(params)))


def cost_analysis(fn: Callable, *args) -> Dict[str, float]:
    """The reference's compiled-program FLOP / byte count; not ported."""
    raise NotImplementedError(f"profiler.cost_analysis is not ported yet: {COST_ANALYSIS_ITEM}")


def _scale(tree: Any, factor: torch.Tensor) -> Any:
    """Every floating leaf times ``factor`` (integer leaves as they are)."""
    return tree_map(lambda t: t * factor.to(t.dtype)
                    if isinstance(t, torch.Tensor) and t.is_floating_point() else t, tree)


def _device_of(tree: Any) -> torch.device:
    for leaf in leaves(tree):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


def throughput(
    fn: Callable,
    args: tuple,
    batch_size: int,
    iters: int = 10,
    perturb: Optional[Callable] = None,
) -> Dict[str, float]:
    """ms per batch and seq/s of ``fn(*args) -> tensor``, over ``iters``
    chained calls after one warm-up call. ``perturb(args, c)`` makes a
    call's input depend on ``c``, the mean of the previous output (default:
    scale the floating leaves of the last argument by ``1 + 1e-9 * c``)."""
    if perturb is None:
        def perturb(a, c):
            return (*a[:-1], _scale(a[-1], 1 + 1e-9 * c))

    device = _device_of(args[-1])
    cuda = device.type == "cuda"

    def chained(c):
        for _ in range(iters):
            c = fn(*perturb(args, c)).float().mean()
        return c

    with torch.no_grad():
        c0 = torch.zeros((), device=device)
        float(chained(c0))  # warm-up (kernel builds, allocator) and sync
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            c = chained(c0)
            end.record()
            end.synchronize()
            float(c)
            dt = start.elapsed_time(end) / 1e3 / iters
        else:
            t0 = time.perf_counter()
            float(chained(c0))
            dt = (time.perf_counter() - t0) / iters
    return {"ms_per_batch": dt * 1e3, "seq_per_s": batch_size / dt}


def profile_model(fn: Callable, params: Any, example: Any, batch_size: int) -> Dict[str, float]:
    """Parameters (millions) and throughput (the profile.py equivalent).
    No ``flops`` / ``gflops_per_seq``: the reference leaves them out where
    its cost analysis fails, and the port has none (:func:`cost_analysis`)."""
    out = {"params_m": count_params(params) / 1e6}
    out.update(throughput(fn, (params, example), batch_size))
    return out
