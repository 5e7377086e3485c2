"""Chip smoke test of the PyTorch/CUDA port: drives the ViT-B16 image
serving path, the ViT-B16 image training step, the ViT-B16 video classifier
(16 x 224^2 clip, 1568 tokens; served and trained, frozen-encoder and full
fine-tune) and the ViT-B16 point-cloud models (classifier served and
trained, segmenter served, masked point ViT trained) on one NVIDIA GPU
through the hand-written kernels.

    python3 chip_smoke.py [--seed N] [--profile]

Phases (any failed check raises, so the process exits non-zero):

1. device: require a CUDA card, print its name and power limit, turn TF32
   off for fp32 matmuls and convolutions;
2. build the kernels from ``metatransformer_tpu_torch/ops/csrc``;
3. hold each kernel against its plain PyTorch version, computed in fp32
   from the same bf16 inputs, at the shapes of the image path (T = 197) and
   of the point classifier (T = 257); the backward kernel is launched twice
   and must repeat bit for bit;
4. hold both autograd Functions (attention and MLP sublayer) against
   autograd through the plain versions in fp32;
5. serve a few uint8 image batches (b = 1, 8, 128) through a full-width
   ViT-B16 classifier (seeded random weights, 1000 classes), count the
   kernel launches of that run, and hold the logits against the same model
   run with the plain versions on the card;
6. time each kernel, its plain version and the library composition of the
   same function, and the whole forward;
7. train: for each track build the full-width model through
   ``image_classifier.init`` and ``Trainer`` (no device named: both land on
   the card), take 6 AdamW steps on one fixed batch of 128, count the kernel
   launches and weight-gradient products of each step, and hold the first 2
   steps (losses, the first gradient and the update of the largest leaf)
   against the same run with the plain versions on the card;
8. time one optimizer step of each track, with its peak memory; with
   ``--profile``, device time by kernel of a full-track step;
9. video: hold the three flash-attention kernels (forward, dq, dk/dv)
   against their plain versions at B*H = 12 and 96, T = 1568, head_dim 64,
   dense and ragged, at the segmenter's T = 513 (a last tile of one row),
   at head_dim 32 and 128, in bf16 and fp32, and the autograd Function against fp32 autograd; serve uint8 clips of b = 1 and 8
   and one 15-view request through a full-width ``VideoClassifier``; take 4
   AdamW steps of each track at batch 8 through ``Trainer``; take 2 steps of
   the video-MAE loss at batch 4 (the fp32 kernel route); each against the
   plain versions on the card; then time the kernels, the clip forward and
   one step of each track;
10. point clouds: hold the furthest-point-sampling kernel against its plain
    version index for index (both routes, duplicated points, ragged masks,
    a second launch); serve float clouds of b = 1, 8, 64 (1024 points, 257
    tokens, fused sublayers) through a full-width ``PointClassifier`` and of
    b = 1, 8 (2048 points, 513 tokens, flash attention) through a
    full-width ``PointSegmenter``; take 4 AdamW steps of both classifier
    tracks at batch 32 through ``Trainer`` and 2 steps of the masked point
    ViT at batch 32 (FP32); each against the plain versions on the card;
    then time the kernel, the forwards and one step of each track;
11. print one JSON line describing the kernels, then the result line.

It imports nothing of JAX. Without a CUDA card it raises before printing
any result.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

D, HEADS, T, MLP = 768, 12, 197, 3072
HD = D // HEADS
LN_EPS = 1e-5
KERNEL_BATCHES = (1, 8, 128)
SERVE_BATCHES = (1, 8, 128)
TRAIN_BATCH, TRAIN_STEPS, COMPARE_STEPS = 128, 6, 2
# Kernel vs its plain version computed in fp32 from the same bf16 inputs:
# max abs error 3e-2, about 4 bf16 ulps at |x| ~ 1. It covers the kernel's
# own bf16 roundings (LN output, q/k/v, P, the attention output, the GELU
# output and the result); outputs reach |x| ~ 7, where rounding the
# result alone costs up to 1.6e-2.
KERNEL_TOL = 3e-2
# The backward kernel's six outputs span |x| from ~1 (o) to several
# hundred (dbeta summed over 25216 rows), so its bound is relative: max abs
# error over max |value| of the fp32 plain version. The card measures at
# most 0.0078 at these shapes (o under the ragged mask; dqkv, three bf16
# roundings deep, 0.0077); the bound is about twice that, and six times
# tighter than the 0.1 of the reference's own bf16 backward test.
BWD_REL_TOL = 1.6e-2
# Gradients of the two autograd Functions vs autograd through the fp32 plain
# versions, relative to each gradient's max |value|: the weight gradients add
# a bf16 library matmul over bf16-rounded xn, dqkv, o to the kernel's error.
# The card measures at most 0.0049; the bound is about twice that.
GRAD_REL_TOL = 1e-2
# Served logits vs the plain-version model: the drift bound of the
# reference's fused-vs-XLA bf16 encoder test (tests/test_fused_block.py).
LOGIT_ATOL, LOGIT_RTOL = 0.15, 0.1
# Training, kernels vs plain versions on the card: per-step losses within
# LOSS_TOL. The update of the largest trainable leaf after COMPARE_STEPS
# steps is held elementwise at rtol 0.1 and an atol of one bf16 ulp of the
# largest weight. AdamW's first updates are lr * g / |g| per element, so
# where a gradient element is smaller than its own bf16 rounding noise the
# two runs take full-size steps in opposite directions; the check therefore
# asks for UPDATE_MIN_FRACTION of the elements inside the bound and for the
# whole update within UPDATE_REL_L2 in relative L2 norm. The card measures
# 0.9993 / 0.028 on the frozen track and 0.9944 / 0.094 on the full track.
LOSS_TOL = 0.05
UPDATE_RTOL, UPDATE_MIN_FRACTION, UPDATE_REL_L2 = 0.1, 0.98, 0.2
# The first step's gradient of that leaf, before AdamW normalises it, is held
# to the plain run's within GRAD_STEP_REL_L2 in relative L2 norm on every
# path and at every rate: it is what the backward kernels hand the optimizer.
GRAD_STEP_REL_L2 = 0.2
# AdamW rates of the training check. The frozen track runs the recipe of
# scripts/bench_train.py, 1e-3. Full fine-tuning at 1e-3 with no warm-up
# swings on one fixed batch (6 steps on an H100: 7.38 5.41 7.03 4.78 2.73
# 6.05), so its check runs at 1e-4, where the loss falls at every step. The
# timed steps use 1e-3 on both tracks: the rate does not change the work.
CHECK_LR = {"frozen": 1e-3, "full": 1e-4}
TIMING_REPS = 20
# Published dense peaks of one H100 SXM: bf16 tensor-core rate, HBM rate,
# and the fp32 rate outside the tensor cores (the fp32 kernel route).
PEAK_FLOPS, PEAK_BYTES, PEAK_FLOPS_FP32 = 989e12, 3.35e12, 67e12

# Video path: VideoMAE geometry on ViT-B16, 8 * 14 * 14 = 1568 tokens.
VT, VIDEO_CLASSES = 1568, 400
VIDEO_SERVE_BATCHES = (1, 8)
VIDEO_TRAIN_BATCH, VIDEO_TRAIN_STEPS = 8, 4
MAE_BATCH, MAE_STEPS = 4, 2
# AdamW rates of the video training check, as CHECK_LR for images. A batch of
# 8 random clips is memorised fast: full fine-tuning at 1e-4 overshoots (4
# steps on an H100: 6.71 2.32 3.47 3.91), at 1e-5 the loss falls at every
# step (6.71 5.42 4.28 3.38 2.77).
VIDEO_CHECK_LR = {"frozen": 1e-3, "full": 1e-5}
# Flash kernels vs their plain versions computed in fp32 from the same
# inputs, max abs error over max |value| of each output. bf16: the kernel's
# own roundings (p and the output; ds, p and the result in the backward) at
# 2**-9 each, summed over up to 1568 keys tile by tile where the plain
# version sums at once; the same bound as BWD_REL_TOL. fp32: only the order
# of summation and expf differ. lse is fp32 in both.
FLASH_REL_TOL = {torch.bfloat16: 1.6e-2, torch.float32: 2e-5}
LSE_TOL = 1e-4
# Video-MAE loss (fp32 policy, fp32 kernels) vs the plain-version run.
MAE_LOSS_TOL = 1e-3

# Point clouds: ViT-B16 on 1024 points (256 groups of 32 + cls = 257 tokens,
# 40 classes) and, for segmentation, 2048 points (513 tokens, 13 classes).
POINT_N, POINT_T, POINT_CLASSES = 1024, 257, 40
POINT_SERVE_BATCHES = (1, 8, 64)
POINT_TRAIN_BATCH, POINT_TRAIN_STEPS = 32, 4
SEG_N, SEG_T, SEG_CLASSES, SEG_SERVE_BATCHES = 2048, 513, 13, (1, 8)
POINT_MAE_BATCH, POINT_MAE_STEPS = 32, 2
# AdamW rates of the point training check, as CHECK_LR for images. The head
# drops half its inputs, another half at every step, so the loss on the
# fixed batch is noisy (6 steps on an H100, frozen at 1e-3: 5.51 5.18 4.98
# 4.76 4.64 4.27; full at 1e-4: 5.51 5.06 4.99 4.37 4.86 4.66): the check
# asks for a lower loss after POINT_TRAIN_STEPS steps, not at every step.
# The model also amplifies the kernels' bf16 rounding more than the image and
# video models do: two max-pools (over each group, over the tokens) switch
# their argmax and dropout doubles what passes. Kernels #1-#3 are inside
# KERNEL_TOL and BWD_REL_TOL at this path's own shapes (T = 257, b = 32 and
# 64, held above), yet the first step's gradient of the largest leaf differs
# from the plain run's by 0.077-0.115 in relative L2 (images and video:
# 0.0025-0.012) and 3-4% of its elements differ in sign. That gradient is
# held at GRAD_STEP_REL_L2 like every other path's. AdamW's first updates are
# lr * g / |g|, so the sign flips alone put the update's relative L2 at
# 2 * sqrt(0.03) = 0.35 at any rate (measured 0.26-0.36; unrelated signs give
# 1.41), and the second step's loss moves with the rate: |diff| 0.027 / 0.082
# at 1e-3 / 1e-4 (frozen / full), 0.0104 / 0.0134 at 1e-4 / 1e-5. The check
# runs at the smaller rates, where the loss still falls (5.52 -> 5.00 / 5.10
# in 4 steps), keeps LOSS_TOL, and bounds the update at POINT_UPDATE_BOUNDS.
# At these rates two updates (at most 2 * lr) are smaller than the elementwise
# atol of one bf16 ulp of the largest weight, so the share inside it says
# nothing here: the gradient and the relative L2 are what bind.
POINT_CHECK_LR = {"frozen": 1e-4, "full": 1e-5}
POINT_UPDATE_BOUNDS = (0.98, 0.5)  # least share inside the bound, largest relative L2
# The FPS kernel is held to its plain version with torch.equal: (B, N, G).
# The last case is past the shared-memory route (N > 14,336).
FPS_CASES = [(1, 1024, 256), (64, 1024, 256), (8, 2048, 512), (32, 1024, 64),
             (2, 16384, 4096)]
FPS_MAIN_CASE = (64, 1024, 256)  # the classifier's b = 64 request

CSRC = "metatransformer_tpu_torch/ops/csrc/"
KERNELS = {
    "attn_sublayer": ("metatransformer_tpu/ops/fused_block.py:82", CSRC + "fused_block.cu"),
    "mlp_sublayer": ("metatransformer_tpu/ops/fused_block.py:562", CSRC + "fused_block.cu"),
    "attn_sublayer_bwd": (
        "metatransformer_tpu/ops/fused_block.py:310", CSRC + "fused_block_bwd.cu"),
    "flash_fwd": ("metatransformer_tpu/ops/flash_attention.py:70", CSRC + "flash_attention.cu"),
    "flash_bwd_dq": (
        "metatransformer_tpu/ops/flash_attention.py:137", CSRC + "flash_attention.cu"),
    "flash_bwd_dkv": (
        "metatransformer_tpu/ops/flash_attention.py:176", CSRC + "flash_attention.cu"),
    "fps": ("metatransformer_tpu/ops/point_ops.py:67", CSRC + "point_ops.cu"),
}
FUSED_KERNELS = ("attn_sublayer", "mlp_sublayer", "attn_sublayer_bwd")
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def phase_device() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: chip_smoke.py runs only on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)  # name, power limit: as nvidia-smi gives them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: off for fp32 matmuls and cuDNN convolutions", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)


def phase_build():
    from metatransformer_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    names = ", ".join(p.name for p in _build.library_paths().values())
    print(f"build: {names} in {time.perf_counter() - t0:.2f} s", flush=True)


# --------------------------------------------------------------------------
# Kernels against their plain versions
# --------------------------------------------------------------------------


def _sublayer_inputs(kind: str, b: int, seed: int, dev, t: int = T):
    """Seeded bf16 inputs at unit scale: x ~ N(0, 1) of ``t`` tokens, weights
    scaled by fan_in**-0.5 so every product stays O(1)."""
    g = torch.Generator().manual_seed(seed)
    randn = lambda *s: torch.randn(*s, generator=g)
    hidden, out_in = (MLP, MLP) if kind == "mlp_sublayer" else (3 * D, D)
    bf = torch.bfloat16
    return (
        randn(b, t, D).to(dev, bf),
        (1.0 + 0.1 * randn(D)).to(dev),
        (0.1 * randn(D)).to(dev),
        (randn(D, hidden) * D**-0.5).to(dev, bf),
        (0.1 * randn(hidden)).to(dev, bf),
        (randn(out_in, D) * out_in**-0.5).to(dev, bf),
        (0.1 * randn(D)).to(dev, bf),
    )


def _bwd_inputs(b: int, seed: int, dev, t: int = T):
    """The backward kernel's arguments: the attention inputs without proj_b,
    and a unit-scale cotangent g after x."""
    x, lns, lnb, wqkv, bqkv, wproj, _ = _sublayer_inputs("attn_sublayer", b, seed, dev, t)
    g = torch.randn(b, t, D, generator=torch.Generator().manual_seed(seed + 7))
    return (x, g.to(dev, torch.bfloat16), lns, lnb, wqkv, bqkv, wproj)


def _pair(kind: str):
    from metatransformer_tpu_torch.ops import fused_block as fb

    kw = dict(num_heads=HEADS, ln_eps=LN_EPS)
    if kind == "attn_sublayer":
        return (
            lambda a, bias=None: fb.attn_sublayer_cuda(*a, bias, **kw),
            lambda a, bias=None: fb.attn_sublayer_plain(*a, bias, **kw),
        )
    if kind == "attn_sublayer_bwd":
        return (
            lambda a, bias=None: fb.attn_sublayer_bwd_cuda(*a, bias, **kw),
            lambda a, bias=None: fb.attn_sublayer_bwd_plain(*a, bias, **kw),
        )
    return (
        lambda a, bias=None: fb.mlp_sublayer_cuda(*a, ln_eps=LN_EPS),
        lambda a, bias=None: fb.mlp_sublayer_plain(*a, ln_eps=LN_EPS),
    )


def _ragged_bias(dev):
    from metatransformer_tpu_torch.ops import fused_block as fb

    keep = torch.ones(8, T, dtype=torch.bool, device=dev)
    for i in range(8):
        keep[i, T - 23 * i:] = False  # ragged: 197, 174, ..., 36 kept
    return torch.where(keep, 0.0, fb.NEG_INF).float()


def phase_kernels(seed: int, dev) -> dict:
    worst = {}
    for kind in ("attn_sublayer", "mlp_sublayer"):
        kernel, plain = _pair(kind)
        cases = [(b, T, None) for b in KERNEL_BATCHES]
        if kind == "attn_sublayer":
            cases.append((8, T, _ragged_bias(dev)))
        # the point classifier's requests and its training batch
        cases += [(b, POINT_T, None) for b in POINT_SERVE_BATCHES + (POINT_TRAIN_BATCH,)]
        worst[kind] = 0.0
        for b, t, bias in cases:
            args = _sublayer_inputs(kind, b, seed + b + t, dev, t)
            with torch.no_grad():
                got = kernel(args, bias).float()
                torch.cuda.synchronize()
                want = plain([a.float() for a in args], bias)
            if not torch.isfinite(got).all():
                raise AssertionError(f"{kind} b={b} T={t}: non-finite kernel output")
            max_abs = (got - want).abs().max().item()
            tag = "masked" if bias is not None else "dense"
            print(f"{kind} b={b} T={t} {tag}: max_abs_err {max_abs:.6g} vs the fp32 plain "
                  f"version (tol {KERNEL_TOL}, max |x| {want.abs().max().item():.4g})",
                  flush=True)
            if max_abs > KERNEL_TOL:
                raise AssertionError(f"{kind} b={b} T={t} {tag}: kernel disagrees with plain")
            worst[kind] = max(worst[kind], max_abs)
    worst["attn_sublayer_bwd"] = phase_bwd_kernel(seed, dev)
    return worst


def phase_bwd_kernel(seed: int, dev) -> float:
    """All six outputs of the backward kernel vs its fp32 plain version;
    two launches must agree bit for bit (the dgamma / dbeta reduction has a
    fixed order and no atomics). Returns the worst absolute error."""
    kernel, plain = _pair("attn_sublayer_bwd")
    names = ("dx", "dqkv", "xn", "o", "dlns", "dlnb")
    worst_abs = 0.0
    cases = [(b, T, None) for b in KERNEL_BATCHES] + [(8, T, _ragged_bias(dev))]
    # the point classifier's training batch, and its largest request's shape
    cases += [(POINT_TRAIN_BATCH, POINT_T, None), (POINT_SERVE_BATCHES[-1], POINT_T, None)]
    for b, t, bias in cases:
        args = _bwd_inputs(b, seed + b + t, dev, t)
        with torch.no_grad():
            got = kernel(args, bias)
            again = kernel(args, bias)
            torch.cuda.synchronize()
            want = plain([a.float() for a in args], bias)
        tag = "masked" if bias is not None else "dense"
        parts = []
        for name, g, g2, w in zip(names, got, again, want):
            g = g.float()
            if not torch.isfinite(g).all():
                raise AssertionError(f"attn_sublayer_bwd b={b} T={t} {tag}: non-finite {name}")
            if not torch.equal(g, g2.float()):
                raise AssertionError(f"attn_sublayer_bwd b={b} T={t} {tag}: {name} does not repeat")
            err, scale = (g - w).abs().max().item(), w.abs().max().item()
            parts.append(f"{name} {err / scale:.4g} (abs {err:.4g}, max |x| {scale:.4g})")
            if err > BWD_REL_TOL * scale:
                raise AssertionError(
                    f"attn_sublayer_bwd b={b} T={t} {tag}: {name} rel err {err / scale:.4g} "
                    f"> {BWD_REL_TOL}")
            worst_abs = max(worst_abs, err)
        print(f"attn_sublayer_bwd b={b} T={t} {tag}: rel err vs the fp32 plain version "
              f"(tol {BWD_REL_TOL}), bit-equal on a second launch: " + "; ".join(parts),
              flush=True)
    return worst_abs


def phase_autograd(seed: int, dev):
    """Seven gradients of each autograd Function on the card vs autograd
    through the plain version in fp32 from the same bf16 inputs."""
    from metatransformer_tpu_torch.ops import fused_block as fb

    names = ("x", "ln_scale", "ln_bias", "w_in", "b_in", "w_out", "b_out")
    for kind, op, plain in (
        ("attn_sublayer", lambda a: fb.attn_sublayer(*a, num_heads=HEADS, ln_eps=LN_EPS),
         lambda a: fb.attn_sublayer_plain(*a, None, num_heads=HEADS, ln_eps=LN_EPS)),
        ("mlp_sublayer", lambda a: fb.mlp_sublayer(*a, ln_eps=LN_EPS),
         lambda a: fb.mlp_sublayer_plain(*a, ln_eps=LN_EPS)),
    ):
        args = _sublayer_inputs(kind, 8, seed + 3, dev)
        g = torch.randn(8, T, D, generator=torch.Generator().manual_seed(seed + 4)).to(dev)
        leaves = [a.clone().requires_grad_(True) for a in args]
        op(leaves).backward(g.to(torch.bfloat16))
        ref = [a.float().requires_grad_(True) for a in args]
        plain(ref).backward(g.to(torch.bfloat16).float())
        torch.cuda.synchronize()
        parts = []
        for name, leaf, want in zip(names, leaves, ref):
            if leaf.grad is None or leaf.grad.dtype != leaf.dtype:
                raise AssertionError(f"{kind}: gradient of {name} missing or of wrong dtype")
            err = (leaf.grad.float() - want.grad).abs().max().item()
            scale = want.grad.abs().max().item()
            parts.append(f"{name} {err / scale:.4g}")
            if not err <= GRAD_REL_TOL * scale:
                raise AssertionError(f"{kind}: gradient of {name} rel err {err / scale:.4g}")
        print(f"{kind} autograd b=8: rel err of 7 gradients vs fp32 autograd through the "
              f"plain version (tol {GRAD_REL_TOL}): " + ", ".join(parts), flush=True)


# --------------------------------------------------------------------------
# Serving
# --------------------------------------------------------------------------


def _plain_versions():
    """Context: the CUDA entries replaced by the plain versions (which run
    on the card's tensors with library ops)."""
    from contextlib import ExitStack

    from metatransformer_tpu_torch.ops import flash_attention as fa
    from metatransformer_tpu_torch.ops import fused_block as fb
    from metatransformer_tpu_torch.ops import point_ops as po

    stack = ExitStack()
    for mod, cuda, plain in ((fb, "attn_sublayer_cuda", fb.attn_sublayer_plain),
                             (fb, "mlp_sublayer_cuda", fb.mlp_sublayer_plain),
                             (fb, "attn_sublayer_bwd_cuda", fb.attn_sublayer_bwd_plain),
                             (fa, "flash_fwd_cuda", fa.flash_attention_plain),
                             (fa, "flash_bwd_dq_cuda", fa.flash_bwd_dq_plain),
                             (fa, "flash_bwd_dkv_cuda", fa.flash_bwd_dkv_plain),
                             (po, "fps_cuda", po.furthest_point_sample_plain)):
        stack.enter_context(mock.patch.object(mod, cuda, plain))
    return stack


def _serve(model, requests, dev):
    """Answer each request: uint8 images -> (logits, top-5 classes)."""
    answers = []
    for images in requests:
        logits = model(images.to(dev))
        answers.append((logits, logits.topk(5, dim=-1).indices))
    return answers


def _check_launches_per_request(per_request, expected: dict, what: str):
    """Each request must add exactly ``expected`` launches (0 for a kernel
    not named) to the running counts."""
    before = {k: 0 for k in per_request[0]}
    for i, counts in enumerate(per_request):
        grew = {k: v - before[k] for k, v in counts.items()}
        want = {k: expected.get(k, 0) for k in counts}
        if grew != want:
            raise AssertionError(f"{what} request {i}: launches {grew}, expected {want}")
        before = counts


def phase_serve(seed: int, dev):
    from metatransformer_tpu_torch import ops
    from metatransformer_tpu_torch.core import encoder as enc
    from metatransformer_tpu_torch.models import image_classifier as ic

    cfg = ic.ImageClassifierConfig()  # ViT-B16, 224^2, patch 16, 1000 classes
    params = ic.init(cfg, torch.Generator().manual_seed(seed))  # lands on the card
    model = ic.ImageClassifier(cfg, params, precision=enc.BF16)
    if next(model.buffers()).device.type != "cuda":
        raise AssertionError("the model did not land on the card")
    g = torch.Generator().manual_seed(seed + 1)
    requests = [
        torch.randint(0, 256, (b, 224, 224, 3), generator=g, dtype=torch.uint8)
        for b in SERVE_BATCHES
    ]
    depth = cfg.encoder.depth

    ops.reset_launch_counts()
    answers, per_request = [], []
    for images in requests:
        answers += _serve(model, [images], dev)
        per_request.append(ops.launch_counts())
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    print(f"served {len(requests)} requests, kernel launches {launches}", flush=True)
    _check_launches_per_request(
        per_request, {"attn_sublayer": depth, "mlp_sublayer": depth}, "image serve")

    # The same model with the plain versions on the card, request by request.
    with _plain_versions():
        want = _serve(model, requests, dev)
    for (logits, top5), (ref, ref_top5), images in zip(answers, want, requests):
        b = images.shape[0]
        if logits.shape != (b, cfg.num_classes) or top5.shape != (b, 5):
            raise AssertionError(f"b={b}: logits {tuple(logits.shape)}")
        if not torch.isfinite(logits).all():
            raise AssertionError(f"b={b}: non-finite logits")
        err = (logits - ref).abs().max().item()
        top1 = (top5[:, 0] == ref_top5[:, 0]).float().mean().item()
        print(f"request b={b}: logits {tuple(logits.shape)}, max |kernel - plain| "
              f"{err:.6g}, top-1 agreement {top1:.4f}, first top-5 "
              f"{top5[0].tolist()}", flush=True)
        torch.testing.assert_close(logits, ref, atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
    return model, launches


# --------------------------------------------------------------------------
# Training
# --------------------------------------------------------------------------


def _train_batch():
    """One fixed batch, as scripts/bench_train.py makes it: float images
    from numpy's default_rng(0), labels arange(B) % 1000."""
    images = np.random.default_rng(0).standard_normal(
        (TRAIN_BATCH, 224, 224, 3), np.float32)
    labels = np.arange(TRAIN_BATCH, dtype=np.int64) % 1000
    return {"input": images, "label": labels}


def _make_trainer(track: str, seed: int, lr: float = 1e-3):
    """Full-width ViT-B16 through the port's entry points; no device is
    named anywhere, so parameters, optimizer state and batches are on the
    card. AdamW at ``lr``, weight decay 0.05, BF16 policy."""
    from metatransformer_tpu_torch.core import encoder as enc
    from metatransformer_tpu_torch.models import image_classifier as ic
    from metatransformer_tpu_torch.train import optim, step as step_lib
    from metatransformer_tpu_torch.train.trainer import Trainer, TrainerConfig

    cfg = ic.ImageClassifierConfig()
    params = ic.init(cfg, torch.Generator().manual_seed(seed))
    frozen_keys = step_lib.FROZEN_KEYS if track == "frozen" else ()
    if track == "frozen":  # a frozen encoder is cast once, outside the step
        params["encoder"] = enc.cast_params(params["encoder"], enc.BF16)

    def forward(p, x, generator):
        return ic.forward(p, x, cfg, enc.BF16, train=True, generator=generator)

    trainer = Trainer(
        forward, optim.make_optimizer("adamw", lr=lr, weight_decay=0.05), params,
        TrainerConfig(epochs=1, log_every=10**9), frozen_keys=frozen_keys,
    )
    if trainer.device.type != "cuda":
        raise AssertionError("the trainer did not land on the card")
    return trainer, cfg


def _largest_leaf(tree):
    from metatransformer_tpu_torch.train import optim

    return max(optim.flatten_with_paths(tree), key=lambda kv: kv[1].numel())


def _train_tracks(what, make_trainer, batch, steps, per_step, weight_grads, lrs,
                  make_generator=lambda: None, fall_every_step: bool = True,
                  update_bounds=(UPDATE_MIN_FRACTION, UPDATE_REL_L2)) -> dict:
    """Both tracks of one model through ``Trainer`` on one fixed batch:
    ``steps`` AdamW steps with the kernel launches of every step held to
    ``per_step`` (kernels not named: 0) and the fused sublayers'
    weight-gradient products to ``weight_grads[track]``, at the AdamW rate
    ``lrs[track]``; the loss must fall
    at every step, a frozen encoder must not move, and the first
    COMPARE_STEPS steps are held against the same run with the plain
    versions on the card. ``make_generator`` gives each run its own equally
    seeded generator (dropout), so both runs draw the same masks; under
    dropout every step sees another mask and its loss is noisy, so such a
    caller asks only that the last loss lies below the first
    (``fall_every_step=False``). ``update_bounds`` is the least share of the
    largest leaf's update inside the elementwise bound and its largest
    relative L2 distance from the plain run's. Returns the launches of each
    track."""
    min_fraction, max_rel_l2 = update_bounds
    from metatransformer_tpu_torch import ops
    from metatransformer_tpu_torch.ops import fused_block as fb

    size = len(batch["label"])
    launches = {}
    for track in ("frozen", "full"):
        trainer = make_trainer(track, lrs[track])
        path, leaf = _largest_leaf(trainer.trainable)
        start = leaf.detach().clone()
        frozen_before = {k: v.clone() for k, v in trainer.frozen.get("encoder", {}).items()}

        ops.reset_launch_counts()
        losses, updates, first_grad, generator = [], None, None, make_generator()
        for step in range(steps):
            before, wg_before = ops.launch_counts(), fb.weight_grad_counts()
            stats = trainer.train_epoch([batch], generator)  # one optimizer step
            losses.append(stats["loss"])
            grew = {k: v - before[k] for k, v in ops.launch_counts().items()}
            if grew != {k: per_step.get(k, 0) for k in grew}:
                raise AssertionError(f"{what} {track} step {step}: kernel launches {grew}, "
                                     f"expected {per_step} and 0 of the others")
            wg = {k: v - wg_before[k] for k, v in fb.weight_grad_counts().items()}
            if wg != {k: weight_grads[track] for k in wg}:
                raise AssertionError(f"{what} {track} step {step}: weight-gradient products "
                                     f"{wg}, expected {weight_grads[track]} per sublayer kind")
            if step == 0:  # the step leaves its gradients on the leaves
                first_grad = leaf.grad.detach().clone()
            if step == COMPARE_STEPS - 1:
                updates = leaf.detach() - start
        torch.cuda.synchronize()
        launches[track] = ops.launch_counts()
        print(f"{what} {track}: {steps} AdamW steps (lr {lrs[track]:g}) at batch "
              f"{size}, losses "
              + " ".join(f"{v:.4f}" for v in losses)
              + f"; launches {launches[track]}; weight-gradient products "
              f"{fb.weight_grad_counts()}", flush=True)
        if not all(np.isfinite(losses)):
            raise AssertionError(f"{what} {track}: non-finite loss")
        fell = (all(b < a for a, b in zip(losses, losses[1:])) if fall_every_step
                else losses[-1] < losses[0])
        if not fell:
            raise AssertionError(f"{what} {track}: loss did not fall: {losses}")
        for k, v in frozen_before.items():
            now = trainer.frozen["encoder"][k]
            if not torch.equal(now, v) or now.grad is not None or now.requires_grad:
                raise AssertionError(f"{what} {track}: frozen encoder leaf {k} changed")
        del trainer

        # The first steps again with the plain versions on the card.
        ref_trainer = make_trainer(track, lrs[track])
        _, ref_leaf = _largest_leaf(ref_trainer.trainable)
        ref_generator = make_generator()
        ref_losses, ref_first_grad = [], None
        with _plain_versions():
            for step in range(COMPARE_STEPS):
                ref_losses.append(ref_trainer.train_epoch([batch], ref_generator)["loss"])
                if step == 0:
                    ref_first_grad = ref_leaf.grad.detach().clone()
        ref_updates = ref_leaf.detach() - start
        grad_rel_l2 = ((first_grad - ref_first_grad).norm() / ref_first_grad.norm()).item()
        diffs = [abs(a - b) for a, b in zip(losses, ref_losses)]
        # one bf16 ulp of the largest weight: 2**(floor(log2 |w|) - 7)
        atol = 2.0 ** (int(np.floor(np.log2(start.abs().max().item()))) - 7)
        inside = ((updates - ref_updates).abs()
                  <= atol + UPDATE_RTOL * ref_updates.abs()).float().mean().item()
        rel_l2 = ((updates - ref_updates).norm() / ref_updates.norm()).item()
        print(f"{what} {track} vs plain versions, {COMPARE_STEPS} steps: |loss diff| "
              + " ".join(f"{v:.5f}" for v in diffs)
              + f" (tol {LOSS_TOL}); update of {'/'.join(path)} {tuple(leaf.shape)}: "
              f"{inside:.4f} of elements within rtol {UPDATE_RTOL} + atol {atol:.3g} "
              f"(min {min_fraction}), relative L2 {rel_l2:.4f} (max {max_rel_l2}); its "
              f"first-step gradient: relative L2 {grad_rel_l2:.4f} (max {GRAD_STEP_REL_L2})",
              flush=True)
        if max(diffs) > LOSS_TOL:
            raise AssertionError(f"{what} {track}: losses differ from the plain run: {diffs}")
        if inside < min_fraction or not rel_l2 <= max_rel_l2:
            raise AssertionError(f"{what} {track}: update of {path} differs from the plain run")
        if not grad_rel_l2 <= GRAD_STEP_REL_L2:
            raise AssertionError(f"{what} {track}: first-step gradient of {path} differs "
                                 f"from the plain run")
        del ref_trainer
        torch.cuda.empty_cache()
    return launches


def phase_train(seed: int, dev) -> dict:
    from metatransformer_tpu_torch.models import image_classifier as ic

    depth = ic.ImageClassifierConfig().encoder.depth
    return _train_tracks(
        "train", lambda track, lr: _make_trainer(track, seed, lr)[0], _train_batch(),
        TRAIN_STEPS, {k: depth for k in FUSED_KERNELS},
        {"frozen": 0, "full": 4 * depth}, CHECK_LR)


# --------------------------------------------------------------------------
# Times and bounds
# --------------------------------------------------------------------------


def _median_ms(fn, reps: int = TIMING_REPS) -> float:
    for _ in range(min(3, reps)):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _library_attn(x, lns, lnb, wqkv, bqkv, wproj, bproj):
    """The attention sublayer as a composition of PyTorch's own bf16 calls.
    A yardstick only: nothing in the port calls it."""
    b, t, d = x.shape
    xn = F.layer_norm(x, (d,), lns.to(x.dtype), lnb.to(x.dtype), LN_EPS)
    q, k, v = F.linear(xn, wqkv.t(), bqkv).reshape(b, t, 3, HEADS, HD).permute(2, 0, 3, 1, 4)
    o = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(b, t, d)
    return x + F.linear(o, wproj.t(), bproj)


def _library_mlp(x, lns, lnb, w1, b1, w2, b2):
    xn = F.layer_norm(x, (x.shape[-1],), lns.to(x.dtype), lnb.to(x.dtype), LN_EPS)
    return x + F.linear(F.gelu(F.linear(xn, w1.t(), b1)), w2.t(), b2)


def _bounds(b: int) -> dict:
    """The least time the card could take for each kernel's work at batch b:
    the larger of operations / peak bf16 rate and bytes / peak memory rate,
    each input read once and each output written once."""
    m = b * T
    attn_products = 2 * b * HEADS * T * T * HD  # one [T, T, hd] product, all heads
    act = 2 * m * D  # one bf16 [B, T, D] tensor, bytes
    ops = {
        "attn_sublayer": 2 * m * D * 3 * D + 2 * m * D * D + 2 * attn_products,
        "mlp_sublayer": 2 * 2 * m * D * MLP,
        # QKV recompute, g Wproj^T, dqkv Wqkv^T, and s, o, dv, dp, dq, dk
        "attn_sublayer_bwd": 2 * m * D * 3 * D + 2 * m * D * D + 2 * m * 3 * D * D
        + 6 * attn_products,
    }
    nbytes = {
        "attn_sublayer": 2 * act + 2 * (4 * D * D + 4 * D) + 8 * D,
        "mlp_sublayer": 2 * act + 2 * (2 * D * MLP + MLP + D) + 8 * D,
        # in: x, g, Wqkv, bqkv, Wproj, LN params; out: dx, xn, o, dqkv, dgamma, dbeta
        "attn_sublayer_bwd": 2 * act + 2 * (4 * D * D + 3 * D) + 8 * D + 3 * act + 3 * act
        + 8 * D,
    }
    out = {}
    for k in ops:
        t_ops, t_bytes = ops[k] / PEAK_FLOPS * 1e3, nbytes[k] / PEAK_BYTES * 1e3
        out[k] = {"bound_ms": max(t_ops, t_bytes),
                  "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                  "gflop": ops[k] / 1e9, "mbytes": nbytes[k] / 1e6}
    return out


def phase_times(model, seed: int, dev) -> dict:
    times = {}
    b = 128
    bounds = _bounds(b)
    for kind in FUSED_KERNELS:
        kernel, plain = _pair(kind)
        if kind == "attn_sublayer_bwd":
            args = _bwd_inputs(b, seed, dev)
            x, g, lns, lnb, wqkv, bqkv, wproj = args
            leaves = [a.clone().requires_grad_(True)
                      for a in (x, lns, lnb, wqkv, bqkv, wproj, torch.zeros_like(lnb).bfloat16())]
            out = _library_attn(*leaves)  # untimed forward; its graph is kept
            library = lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)
            what = "backward of the composition (dx and 6 parameter gradients)"
        else:
            args = _sublayer_inputs(kind, b, seed, dev)
            composition = _library_attn if kind == "attn_sublayer" else _library_mlp
            library = lambda: composition(*args)
            what = "composition"
        with torch.no_grad():
            ms, plain_ms = _median_ms(lambda: kernel(args)), _median_ms(lambda: plain(args))
        if kind == "attn_sublayer_bwd":
            lib_ms = _median_ms(library)
            del out, leaves
        else:
            with torch.no_grad():
                lib_ms = _median_ms(library)
        bound = bounds[kind]
        times[kind] = {"ms": ms, "plain_ms": plain_ms, "library_composition_ms": lib_ms,
                       **{k: bound[k] for k in ("bound_ms", "bound_by")}}
        print(f"{kind} b={b}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library {what} "
              f"(layer_norm, linear, scaled_dot_product_attention, gelu in bf16; no single "
              f"PyTorch call computes the sublayer) {lib_ms:.4f} ms, bound "
              f"{bound['bound_ms']:.4f} ms by {bound['bound_by']} ({bound['gflop']:.2f} GFLOP, "
              f"{bound['mbytes']:.1f} MB; {100 * bound['bound_ms'] / ms:.1f}% of the bound's "
              f"rate) (median of {TIMING_REPS})", flush=True)
    g = torch.Generator().manual_seed(seed + 2)
    with torch.no_grad():
        for b in (128, 1):
            images = torch.randint(0, 256, (b, 224, 224, 3), generator=g,
                                   dtype=torch.uint8).to(dev)
            ms = _median_ms(lambda: model(images))
            print(f"forward b={b}: {ms:.4f} ms, {b * 1000.0 / ms:.2f} seq/s "
                  f"(median of {TIMING_REPS}, uint8 on the card -> logits)", flush=True)
    return times


def _time_step(label, trainer, batch, unit, generator=None, profile_as=None):
    """Time one optimizer step of ``trainer`` on ``batch`` (moved to the card
    once), with its peak memory; ``profile_as`` also prints its device time
    by kernel under that name."""
    on_card = trainer._to_device(batch)
    size = len(on_card["input"])
    step = lambda: trainer._step(trainer.trainable, trainer.frozen, on_card, generator)
    torch.cuda.reset_peak_memory_stats()
    ms = _median_ms(step)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"{label} b={size}: {ms:.4f} ms, {size * 1000.0 / ms:.2f} {unit}/s, peak memory "
          f"{peak:.3f} GiB (median of {TIMING_REPS} optimizer steps, batch on the card)",
          flush=True)
    if profile_as:
        _profile_step(step, profile_as)


def phase_train_times(seed: int, dev, profile: bool):
    batch = _train_batch()
    for track in ("frozen", "full"):
        trainer, _ = _make_trainer(track, seed)
        _time_step(f"train step {track}", trainer, batch, "seq",
                   profile_as="full-track step" if profile and track == "full" else None)
        del trainer
        torch.cuda.empty_cache()


def _profile_step(step, what: str = "full-track step", steps: int = 3):
    """Device time by kernel over a few runs of ``step`` (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6 / steps
    rows = [(e.key, e.device_time_total / steps, e.count / steps)
            for e in prof.key_averages() if e.device_time_total > 0]
    busy = sum(r[1] for r in rows)
    print(f"profile, {what}: wall {wall_us:.1f} us/step under the profiler, "
          f"device busy {busy:.1f} us/step, idle share {100 * (1 - busy / wall_us):.2f}%",
          flush=True)
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:28]:
        print(f"  {us:10.1f} us  {100 * us / busy:6.2f}%  x{count:6.1f}  {key[:110]}",
              flush=True)


# --------------------------------------------------------------------------
# Long sequences and video: the flash-attention kernels and the paths on them
# --------------------------------------------------------------------------

BF, F32 = torch.bfloat16, torch.float32
FLASH_CASES = [  # b, h, t, head_dim, dtype, ragged mask
    (1, 12, VT, 64, BF, False), (1, 12, VT, 64, BF, True),
    (8, 12, VT, 64, BF, False), (8, 12, VT, 64, BF, True),
    (2, 4, 512, 32, BF, True), (2, 4, 577, 32, BF, False),
    (2, 2, 512, 128, BF, False), (2, 2, 577, 128, BF, True),
    # the segmenter's requests: T = 8 * 64 + 1, the last tile holds one row
    (1, 12, SEG_T, 64, BF, False), (8, 12, SEG_T, 64, BF, False),
    (8, 12, SEG_T, 64, BF, True),
    (4, 6, VT, 64, F32, False), (1, 12, VT, 64, F32, True),
    (2, 4, 577, 32, F32, True), (2, 2, 577, 128, F32, True),
]


def _flash_inputs(b, h, t, d, dtype, ragged, seed, dev):
    """Seeded unit-normal q, k, v as strided views of one [B, T, 3, H, d]
    tensor (the layout the encoder hands over), a cotangent, and the key
    bias of a ragged keep-mask (sample i loses its last (i+1) t / (2b+2)
    keys) or None."""
    from metatransformer_tpu_torch.ops import flash_attention as fa

    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(b, t, 3, h, d, generator=g).to(dev, dtype)
    do = torch.randn(b, t, h, d, generator=g).to(dev, dtype)
    bias = None
    if ragged:
        keep = torch.ones(b, t, dtype=torch.bool, device=dev)
        for i in range(b):
            keep[i, t - (i + 1) * t // (2 * b + 2):] = False
        bias = torch.where(keep, 0.0, fa.NEG_INF).float()
    return (*qkv.unbind(2), bias, do)


def phase_flash_kernels(seed: int, dev) -> dict:
    """Kernels #4-#6 vs their plain versions in fp32 from the same inputs;
    lse held too; both backward kernels bit-equal on a second launch.
    Returns the worst absolute error of each kernel."""
    from metatransformer_tpu_torch.ops import flash_attention as fa

    worst = {k: 0.0 for k in FLASH_KERNELS}
    f = lambda x: x.float()
    for b, h, t, d, dtype, ragged in FLASH_CASES:
        q, k, v, bias, do = _flash_inputs(b, h, t, d, dtype, ragged, seed + t + d, dev)
        scale = float(d) ** -0.5
        with torch.no_grad():
            o, lse = fa.flash_fwd_cuda(q, k, v, bias, scale)
            delta = fa._delta(o, do)
            dq = fa.flash_bwd_dq_cuda(q, k, v, bias, do, lse, delta, scale)
            dk, dv = fa.flash_bwd_dkv_cuda(q, k, v, bias, do, lse, delta, scale)
            dq2 = fa.flash_bwd_dq_cuda(q, k, v, bias, do, lse, delta, scale)
            dk2, dv2 = fa.flash_bwd_dkv_cuda(q, k, v, bias, do, lse, delta, scale)
            torch.cuda.synchronize()
            want_o, want_lse = fa.flash_attention_plain(f(q), f(k), f(v), bias, scale)
            # the backward from the kernel's own lse and delta, as the Function runs it
            want_dq = fa.flash_bwd_dq_plain(f(q), f(k), f(v), bias, f(do), lse, delta, scale)
            want_dk, want_dv = fa.flash_bwd_dkv_plain(
                f(q), f(k), f(v), bias, f(do), lse, delta, scale)
        tag = (f"b={b} h={h} T={t} d={d} {str(dtype).split('.')[-1]} "
               f"{'ragged' if ragged else 'dense'}")
        for name, a, a2 in (("dq", dq, dq2), ("dk", dk, dk2), ("dv", dv, dv2)):
            if not torch.equal(a, a2):
                raise AssertionError(f"flash {tag}: {name} does not repeat bit for bit")
        lse_err = (lse - want_lse).abs().max().item()
        if not lse_err <= LSE_TOL * max(1.0, want_lse.abs().max().item()):
            raise AssertionError(f"flash {tag}: lse differs by {lse_err:.4g}")
        tol, parts = FLASH_REL_TOL[dtype], [f"lse abs {lse_err:.3g}"]
        for kernel, name, got, want in (
                ("flash_fwd", "o", o, want_o), ("flash_bwd_dq", "dq", dq, want_dq),
                ("flash_bwd_dkv", "dk", dk, want_dk), ("flash_bwd_dkv", "dv", dv, want_dv)):
            got = got.float()
            if got.shape != want.shape or not torch.isfinite(got).all():
                raise AssertionError(f"flash {tag}: {name} non-finite or of wrong shape")
            err, top = (got - want).abs().max().item(), want.abs().max().item()
            parts.append(f"{name} {err / top:.3g} (abs {err:.3g})")
            if err > tol * top:
                raise AssertionError(f"flash {tag}: {name} rel err {err / top:.4g} > {tol}")
            worst[kernel] = max(worst[kernel], err)
        print(f"flash {tag}: rel err vs the fp32 plain versions (tol {tol}), backward "
              f"bit-equal on a second launch: " + "; ".join(parts), flush=True)
        del want_o, want_lse, want_dq, want_dk, want_dv
    torch.cuda.empty_cache()
    return worst


def phase_flash_autograd(seed: int, dev):
    """The autograd Function on the card (bf16 and fp32 inputs, ragged mask)
    vs fp32 autograd through the plain forward; compared on kept positions
    (a masked key's gradient is zero in both, a masked query row is a row
    like any other)."""
    from metatransformer_tpu_torch.ops import flash_attention as fa

    for dtype in (BF, F32):
        q, k, v, bias, do = _flash_inputs(2, 12, VT, 64, dtype, True, seed + 5, dev)
        mask = bias == 0
        leaves = [a.clone().requires_grad_(True) for a in (q, k, v)]
        out = fa.flash_attention(*leaves, mask=mask)
        out.backward(do)
        ref = [a.float().requires_grad_(True) for a in (q, k, v)]
        want, _ = fa.flash_attention_plain(*ref, bias, 0.125)
        want.backward(do.float())
        torch.cuda.synchronize()
        tol, parts = FLASH_REL_TOL[dtype], []
        pairs = [("out", out.detach(), want.detach())]
        pairs += [(n, a.grad, b.grad) for n, a, b in zip(("dq", "dk", "dv"), leaves, ref)]
        for name, got, exp in pairs:
            if got is None or got.dtype != dtype:
                raise AssertionError(f"flash autograd: {name} missing or of wrong dtype")
            err = (got.float() - exp).abs().max().item()
            top = exp.abs().max().item()
            parts.append(f"{name} {err / top:.3g}")
            if not err <= tol * top:
                raise AssertionError(f"flash autograd {dtype}: {name} rel err {err / top:.4g}")
        print(f"flash autograd b=2 h=12 T={VT} {str(dtype).split('.')[-1]} ragged: rel err "
              f"vs fp32 autograd through the plain forward (tol {tol}): "
              + ", ".join(parts), flush=True)
        del leaves, ref, out, want
    torch.cuda.empty_cache()


def _video_cfg():
    from metatransformer_tpu_torch.models import video_classifier as vc

    return vc.VideoClassifierConfig()  # ViT-B16, 16 x 224^2, tubelet 2, patch 16, 400 classes


def phase_video_serve(seed: int, dev):
    """uint8 clips of b = 1 and 8 and one 15-view request (5 temporal x 3
    spatial crops of a 40-frame 256 x 340 video) through a full-width
    VideoClassifier; 12 forward-kernel launches a clip batch, none of the
    short-sequence kernels; logits against the plain versions on the card."""
    from metatransformer_tpu_torch import ops
    from metatransformer_tpu_torch.core import encoder as enc
    from metatransformer_tpu_torch.models import video_classifier as vc
    from metatransformer_tpu_torch.models import video_eval

    cfg = _video_cfg()
    if cfg.tokenizer.num_patches != VT:
        raise AssertionError(f"video geometry gives {cfg.tokenizer.num_patches} tokens")
    params = vc.init(cfg, torch.Generator().manual_seed(seed))  # lands on the card
    model = vc.VideoClassifier(cfg, params, precision=enc.BF16)
    if next(model.buffers()).device.type != "cuda":
        raise AssertionError("the video model did not land on the card")
    g = torch.Generator().manual_seed(seed + 1)
    requests = [torch.randint(0, 256, (b, 16, 224, 224, 3), generator=g, dtype=torch.uint8)
                for b in VIDEO_SERVE_BATCHES]
    video = torch.randint(0, 256, (40, 256, 340, 3), generator=g, dtype=torch.uint8).numpy()
    depth = cfg.encoder.depth

    def serve_all(count):
        answers, counts = [], []
        for clips in requests:
            answers.append(model(clips.to(dev)))
            counts.append(count())
        mean_logits, views = video_eval.multiview_logits(lambda c: model(c.to(dev)), video)
        answers.append(mean_logits[None])
        counts.append(count())
        return answers, counts, views

    ops.reset_launch_counts()
    answers, per_request, views = serve_all(ops.launch_counts)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    print(f"video: served {len(requests)} clip batches and one {views}-view request, kernel "
          f"launches {launches}", flush=True)
    if views != 15:
        raise AssertionError(f"multiview request made {views} views, expected 15")
    _check_launches_per_request(per_request, {"flash_fwd": depth}, "video serve")

    with _plain_versions():
        want, _, _ = serve_all(lambda: None)  # the plain versions count nothing
    for logits, ref, what in zip(answers, want, [f"b={b}" for b in VIDEO_SERVE_BATCHES]
                                 + ["15-view mean"]):
        if logits.shape[-1] != VIDEO_CLASSES or not torch.isfinite(logits).all():
            raise AssertionError(f"video {what}: logits {tuple(logits.shape)} or non-finite")
        err = (logits - ref).abs().max().item()
        top1 = (logits.argmax(-1) == ref.argmax(-1)).float().mean().item()
        print(f"video request {what}: logits {tuple(logits.shape)}, max |kernel - plain| "
              f"{err:.6g}, top-1 agreement {top1:.4f}", flush=True)
        torch.testing.assert_close(logits, ref, atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
    return model, launches


def _video_batch():
    """One fixed batch of float clips from numpy's default_rng(0), labels
    arange(B) % 400."""
    clips = np.random.default_rng(0).standard_normal(
        (VIDEO_TRAIN_BATCH, 16, 224, 224, 3), np.float32)
    return {"input": clips, "label": np.arange(VIDEO_TRAIN_BATCH, dtype=np.int64) % 400}


def _make_video_trainer(track: str, seed: int, lr: float = 1e-3):
    """Full-width video classifier through the port's entry points (no
    device named): AdamW at ``lr``, weight decay 0.05, BF16 policy."""
    from metatransformer_tpu_torch.core import encoder as enc
    from metatransformer_tpu_torch.models import video_classifier as vc
    from metatransformer_tpu_torch.train import optim, step as step_lib
    from metatransformer_tpu_torch.train.trainer import Trainer, TrainerConfig

    cfg = _video_cfg()
    params = vc.init(cfg, torch.Generator().manual_seed(seed))
    frozen_keys = step_lib.FROZEN_KEYS if track == "frozen" else ()
    if track == "frozen":  # a frozen encoder is cast once, outside the step
        params["encoder"] = enc.cast_params(params["encoder"], enc.BF16)
    trainer = Trainer(
        lambda p, x, generator: vc.forward(p, x, cfg, enc.BF16),
        optim.make_optimizer("adamw", lr=lr, weight_decay=0.05), params,
        TrainerConfig(epochs=1, log_every=10**9), frozen_keys=frozen_keys,
    )
    if trainer.device.type != "cuda":
        raise AssertionError("the video trainer did not land on the card")
    return trainer


def phase_video_train(seed: int, dev) -> dict:
    depth = _video_cfg().encoder.depth
    return _train_tracks(
        "video train", lambda track, lr: _make_video_trainer(track, seed, lr), _video_batch(),
        VIDEO_TRAIN_STEPS, {k: depth for k in FLASH_KERNELS}, {"frozen": 0, "full": 0},
        VIDEO_CHECK_LR)


def _mae_clips():
    """One fixed batch of float clips in [0, 1) from numpy's default_rng(1)."""
    return np.random.default_rng(1).random((MAE_BATCH, 16, 224, 224, 3), np.float32)


def _make_mae_trainer(seed: int):
    """The full-width video MAE (ViT-B16 encoder, 4 x 384 decoder) through
    the port's entry points, everything trainable, AdamW 1e-3 / 0.05, FP32
    policy as the reference's recipe calls it."""
    from metatransformer_tpu_torch.models import video_pretrain as vp
    from metatransformer_tpu_torch.train import optim
    from metatransformer_tpu_torch.train.trainer import Trainer, TrainerConfig

    cfg = vp.VideoMAEConfig()
    return Trainer(
        lambda p, x, generator: vp.forward_loss(p, x, generator, cfg)[0],
        optim.make_optimizer("adamw", lr=1e-3, weight_decay=0.05),
        vp.init(cfg, torch.Generator().manual_seed(seed)),
        TrainerConfig(epochs=1, log_every=10**9),
        loss_fn=lambda loss, label: loss, frozen_keys=(),
    )


def phase_video_mae(seed: int, dev) -> dict:
    """Two AdamW steps of the video-MAE loss at batch 4 under the FP32
    policy: the encoder sees 152 visible tokens (materialised attention),
    the decoder (4 layers, 6 heads of 64) all 1568, through the fp32 route
    of the flash kernels. Held against the plain versions on the card."""
    from metatransformer_tpu_torch import ops
    from metatransformer_tpu_torch.models import video_pretrain as vp

    depth = vp.VideoMAEConfig().decoder.depth
    clips = _mae_clips()

    def run(count):
        trainer = _make_mae_trainer(seed)
        masks = torch.Generator(device=trainer.device).manual_seed(seed)
        losses, counts = [], []
        for _ in range(MAE_STEPS):
            losses.append(trainer.train_epoch([{"input": clips}], masks)["loss"])
            counts.append(count())
        return losses, counts

    ops.reset_launch_counts()
    losses, per_step = run(ops.launch_counts)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    _check_launches_per_request(per_step, {k: depth for k in FLASH_KERNELS}, "video MAE step")
    with _plain_versions():
        ref_losses, _ = run(lambda: None)  # the plain versions count nothing
    diffs = [abs(a - b) for a, b in zip(losses, ref_losses)]
    print(f"video MAE: {MAE_STEPS} AdamW steps at batch {MAE_BATCH} (FP32 policy, fp32 "
          f"kernels), losses " + " ".join(f"{v:.5f}" for v in losses)
          + "; |loss diff| vs plain versions " + " ".join(f"{v:.2g}" for v in diffs)
          + f" (tol {MAE_LOSS_TOL}); launches {launches}", flush=True)
    if not all(np.isfinite(losses)):  # each step draws a new tube mask: no fall is asked
        raise AssertionError(f"video MAE: losses {losses}")
    if max(diffs) > MAE_LOSS_TOL:
        raise AssertionError(f"video MAE: losses differ from the plain run: {diffs}")
    torch.cuda.empty_cache()
    return launches


def phase_video_mae_time(seed: int, dev):
    from metatransformer_tpu_torch.models import video_pretrain as vp

    trainer = _make_mae_trainer(seed)
    masks = torch.Generator(device=trainer.device).manual_seed(seed)
    _time_step(f"video MAE step (FP32 policy, mask ratio {vp.VideoMAEConfig().mask_ratio})",
               trainer, {"input": _mae_clips()}, "clips", masks)
    del trainer
    torch.cuda.empty_cache()


def _flash_bounds(b, h, t, d, elem_bytes, masked) -> dict:
    """Least time for each flash kernel's work at the real T: operations
    (4, 6 and 8 B H T^2 d) over the peak rate of the element type (bf16:
    tensor cores; fp32: plain FMAs), bytes (every operand read and every
    output written once) over the memory rate; the larger."""
    peak = PEAK_FLOPS if elem_bytes == 2 else PEAK_FLOPS_FP32
    bh, tensor = b * h, b * h * t * d * elem_bytes
    rows, bias = 4 * bh * t, (4 * b * t if masked else 0)
    ops = {"flash_fwd": 4, "flash_bwd_dq": 6, "flash_bwd_dkv": 8}
    nbytes = {
        "flash_fwd": 4 * tensor + bias + rows,  # q, k, v in; o, lse out
        "flash_bwd_dq": 5 * tensor + bias + 2 * rows,  # q, k, v, dO, lse, delta in; dq out
        "flash_bwd_dkv": 6 * tensor + bias + 2 * rows,  # the same in; dk, dv out
    }
    out = {}
    for name, mult in ops.items():
        n_ops = mult * bh * t * t * d
        t_ops, t_bytes = n_ops / peak * 1e3, nbytes[name] / PEAK_BYTES * 1e3
        out[name] = {"bound_ms": max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                     "gflop": n_ops / 1e9, "mbytes": nbytes[name] / 1e6}
    return out


def phase_flash_times(seed: int, dev) -> dict:
    """Each flash kernel at the video training shape (b = 8, 12 heads,
    T = 1568, head_dim 64, bf16, dense), its plain version, its bound, and
    the library call for the same function: scaled_dot_product_attention
    for the forward, autograd's backward through it for dq + dk/dv together
    (timed here, used nowhere in the port). Also the b = 1 serving shape and
    the fp32 route at the video-MAE decoder's shape."""
    from metatransformer_tpu_torch.ops import flash_attention as fa

    times = {}
    for b, h, dtype in ((VIDEO_TRAIN_BATCH, HEADS, BF), (1, HEADS, BF), (MAE_BATCH, 6, F32)):
        q, k, v, _, do = _flash_inputs(b, h, VT, HD, dtype, False, seed, dev)
        scale = float(HD) ** -0.5
        with torch.no_grad():
            o, lse = fa.flash_fwd_cuda(q, k, v, None, scale)
            delta = fa._delta(o, do)
            bwd = (q, k, v, None, do, lse, delta, scale)
            ms = {
                "flash_fwd": _median_ms(lambda: fa.flash_fwd_cuda(q, k, v, None, scale)),
                "flash_bwd_dq": _median_ms(lambda: fa.flash_bwd_dq_cuda(*bwd)),
                "flash_bwd_dkv": _median_ms(lambda: fa.flash_bwd_dkv_cuda(*bwd)),
            }
        bounds = _flash_bounds(b, h, VT, HD, q.element_size(), False)
        kind = str(dtype).split(".")[-1]
        if (b, dtype) != (VIDEO_TRAIN_BATCH, BF):
            for name in FLASH_KERNELS:
                bound = bounds[name]
                print(f"{name} b={b} h={h} T={VT} d={HD} {kind}: kernel {ms[name]:.4f} ms, bound "
                      f"{bound['bound_ms']:.4f} ms by {bound['bound_by']} at the {kind} peak "
                      f"({bound['gflop']:.2f} GFLOP, {bound['mbytes']:.1f} MB; "
                      f"{bound['gflop'] / ms[name]:.2f} TFLOP/s) (median of {TIMING_REPS})",
                      flush=True)
            continue
        f = lambda x: x.float()
        with torch.no_grad():
            plain_ms = {
                "flash_fwd": _median_ms(
                    lambda: fa.flash_attention_plain(f(q), f(k), f(v), None, scale)),
                "flash_bwd_dq": _median_ms(lambda: fa.flash_bwd_dq_plain(
                    f(q), f(k), f(v), None, f(do), lse, delta, scale)),
                "flash_bwd_dkv": _median_ms(lambda: fa.flash_bwd_dkv_plain(
                    f(q), f(k), f(v), None, f(do), lse, delta, scale)),
            }
            lq, lk, lv = (a.transpose(1, 2) for a in (q, k, v))  # [B, H, T, d] views
            lib_fwd = _median_ms(lambda: F.scaled_dot_product_attention(lq, lk, lv))
        leaves = [a.detach().clone().requires_grad_(True) for a in (lq, lk, lv)]
        out = F.scaled_dot_product_attention(*leaves)  # untimed forward; its graph is kept
        g = do.transpose(1, 2)
        lib_bwd = _median_ms(lambda: torch.autograd.grad(out, leaves, g, retain_graph=True))
        del out, leaves
        library = {"flash_fwd": lib_fwd, "flash_bwd_dq": lib_bwd, "flash_bwd_dkv": lib_bwd}
        for name in FLASH_KERNELS:
            bound = bounds[name]
            times[name] = {"ms": ms[name], "plain_ms": plain_ms[name],
                           "library_ms": library[name],
                           **{k: bound[k] for k in ("bound_ms", "bound_by")}}
            what = ("scaled_dot_product_attention" if name == "flash_fwd" else
                    "autograd's backward through scaled_dot_product_attention (dq, dk and dv "
                    "together: one time for both backward kernels)")
            print(f"{name} b={b} h={h} T={VT} d={HD} {kind}: kernel {ms[name]:.4f} ms, plain "
                  f"{plain_ms[name]:.4f} ms, library {what} {library[name]:.4f} ms, bound "
                  f"{bound['bound_ms']:.4f} ms by {bound['bound_by']} ({bound['gflop']:.2f} "
                  f"GFLOP, {bound['mbytes']:.1f} MB; {100 * bound['bound_ms'] / ms[name]:.1f}% "
                  f"of the bound's rate, {bound['gflop'] / ms[name]:.2f} TFLOP/s) (median of "
                  f"{TIMING_REPS})", flush=True)
        grid = -(-VT // 64) * h
        print(f"grid: {grid} blocks a sample of 64 query (or key) rows x {h} heads; at b=1 "
              f"that is {grid / 132:.2f} blocks for each of the card's 132 SMs", flush=True)
    torch.cuda.empty_cache()
    return times


def phase_video_times(model, seed: int, dev, profile: bool):
    g = torch.Generator().manual_seed(seed + 2)
    with torch.no_grad():
        for b in (8, 1):
            clips = torch.randint(0, 256, (b, 16, 224, 224, 3), generator=g,
                                  dtype=torch.uint8).to(dev)
            ms = _median_ms(lambda: model(clips))
            print(f"video forward b={b}: {ms:.4f} ms, {b * 1000.0 / ms:.2f} clips/s "
                  f"(median of {TIMING_REPS}, uint8 on the card -> logits)", flush=True)
            if profile:
                _profile_step(lambda: model(clips), f"video forward b={b}")
    del model
    torch.cuda.empty_cache()
    batch = _video_batch()
    for track in ("frozen", "full"):
        trainer = _make_video_trainer(track, seed)
        _time_step(f"video train step {track}", trainer, batch, "clips",
                   profile_as="video full-track step" if profile and track == "full" else None)
        del trainer
        torch.cuda.empty_cache()

# --------------------------------------------------------------------------
# Point clouds: the FPS kernel and the paths on it
# --------------------------------------------------------------------------


def _clouds(seed: int, b: int, n: int) -> torch.Tensor:
    """Seeded float32 clouds, as scripts/bench_modalities.py makes them:
    standard normal coordinates times 0.5."""
    return torch.tensor(
        np.random.default_rng(seed).standard_normal((b, n, 3), np.float32) * 0.5)


def phase_fps_kernel(seed: int, dev) -> float:
    """Kernel #7 vs its plain version, index for index (torch.equal), at
    the shapes of the point paths and past the shared-memory route; on a
    cloud whose points all appear four times with more samples than distinct
    points; through masked_fps with ragged masks on both routes; a second
    launch must repeat bit for bit. Returns the number of differing indices,
    counted over every case."""
    from metatransformer_tpu_torch.ops import _build
    from metatransformer_tpu_torch.ops import point_ops as po

    fits = _build.library().mt_fps_fits_shared

    def check(tag, pts, g):
        with torch.no_grad():
            got = po.fps_cuda(pts, g)
            again = po.fps_cuda(pts, g)
            torch.cuda.synchronize()
            want = po.furthest_point_sample_plain(pts, g)
        if got.dtype != torch.int64 or got.shape != (pts.shape[0], g):
            raise AssertionError(f"fps {tag}: output {got.dtype} {tuple(got.shape)}")
        if not torch.equal(got, again):
            raise AssertionError(f"fps {tag}: a second launch does not repeat")
        wrong = int((got != want).sum())
        route = "shared memory" if fits(pts.shape[1]) else "device memory"
        print(f"fps {tag} ({route} route): {wrong} of {got.numel()} indices differ from the "
              f"plain version, bit-equal on a second launch, {got[0].unique().numel()} "
              f"distinct indices in cloud 0", flush=True)
        if wrong:
            raise AssertionError(f"fps {tag}: kernel disagrees with the plain version")
        return wrong

    wrong = 0
    for b, n, g in FPS_CASES:
        wrong += check(f"B={b} N={n} G={g}", _clouds(seed + n + g, b, n).to(dev), g)
    base = _clouds(seed + 1, 4, 256).to(dev)
    wrong += check("B=4 N=1024 G=300, 256 distinct points each four times",
                   torch.cat([base] * 4, 1), 300)
    for n in (1024, 16384):  # masked_fps, ragged: sample i keeps its first n (i+1) / (b+1) points
        pts = _clouds(seed + 2, 8, n).to(dev)
        mask = torch.arange(n, device=dev)[None, :] < (
            torch.arange(1, 9, device=dev)[:, None] * n // 9)
        mask[7] = ~mask[0]  # and one whose first valid point is not point 0
        before = po.fps_cuda.launches
        with torch.no_grad():
            got = po.masked_fps(pts, mask, 128)
            torch.cuda.synchronize()
            with _plain_versions():
                want = po.masked_fps(pts, mask, 128)
        if po.fps_cuda.launches != before + 1:
            raise AssertionError("masked_fps did not launch the kernel exactly once")
        picked = torch.gather(mask | (torch.arange(n, device=dev)[None] == 0), 1, got)
        differ = int((got != want).sum())
        wrong += differ
        print(f"masked_fps B=8 N={n} G=128 ragged: {differ} indices differ "
              f"from the plain version; every index valid or slot 0: {bool(picked.all())}",
              flush=True)
        if differ:
            raise AssertionError(f"masked_fps N={n}: kernel disagrees with the plain version")
    return float(wrong)


def _fps_bound(b: int, n: int, g: int) -> dict:
    """Least time for the FPS work: ~10 fp32 operations a point a round
    (3 subtractions, 3 multiplies, 2 adds, a minimum, a compare) over the
    fp32 rate outside the tensor cores, against the points read once and
    the indices written once over the memory rate; the larger."""
    n_ops, nbytes = 10 * b * n * (g - 1), 12 * b * n + 4 * b * g
    t_ops, t_bytes = n_ops / PEAK_FLOPS_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "gflop": n_ops / 1e9, "mbytes": nbytes / 1e6}


def phase_fps_times(seed: int, dev) -> dict:
    """The FPS kernel, its plain version and its bound at every shape of
    FPS_CASES; no single PyTorch call computes FPS, so there is no library
    time. The rounds are sequential, so the time of one round (ms / (G-1))
    stands beside the bound."""
    from metatransformer_tpu_torch.ops import point_ops as po

    times = {}
    for b, n, g in FPS_CASES:
        pts = _clouds(seed, b, n).to(dev)
        with torch.no_grad():
            ms = _median_ms(lambda: po.fps_cuda(pts, g))
            plain_ms = _median_ms(lambda: po.furthest_point_sample_plain(pts, g),
                                  reps=20 if g <= 512 else 3)
        bound = _fps_bound(b, n, g)
        print(f"fps B={b} N={n} G={g}: kernel {ms:.4f} ms ({1e3 * ms / (g - 1):.3f} us a "
              f"round, {po._fps_threads(n)} threads a block, {b} blocks), plain {plain_ms:.4f} "
              f"ms, library none, bound {bound['bound_ms']:.6f} ms by {bound['bound_by']} "
              f"({bound['gflop']:.4f} GFLOP fp32, {bound['mbytes']:.3f} MB; "
              f"{100 * bound['bound_ms'] / ms:.2f}% of the bound's rate) (median of "
              f"{TIMING_REPS}; plain: of {20 if g <= 512 else 3})", flush=True)
        if (b, n, g) == FPS_MAIN_CASE:
            times["fps"] = {"ms": ms, "plain_ms": plain_ms,
                            **{k: bound[k] for k in ("bound_ms", "bound_by")}}
    return times


def _point_cfg():
    from metatransformer_tpu_torch.models import point_classifier as pc

    return pc.PointClassifierConfig()  # ViT-B16, ratio 0.25, groups of 32, 40 classes


def _serve_points(what, model, requests, classes, expected, dev):
    """Answer each request with the kernels, hold the launches of each to
    ``expected``, then answer them again with the plain versions on the card
    and hold the logits to them. Returns the launches of the run."""
    from metatransformer_tpu_torch import ops

    if next(model.buffers()).device.type != "cuda":
        raise AssertionError(f"the {what} model did not land on the card")
    ops.reset_launch_counts()
    answers, per_request = [], []
    for clouds in requests:
        answers.append(model(clouds.to(dev)))
        per_request.append(ops.launch_counts())
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    print(f"{what}: served {len(requests)} requests, kernel launches {launches}", flush=True)
    _check_launches_per_request(per_request, expected, f"{what} serve")
    with _plain_versions():
        want = [model(clouds.to(dev)) for clouds in requests]
    for logits, ref, clouds in zip(answers, want, requests):
        b = clouds.shape[0]
        if logits.shape[0] != b or logits.shape[-1] != classes or logits.dtype != torch.float32:
            raise AssertionError(f"{what} b={b}: logits {tuple(logits.shape)} {logits.dtype}")
        if not torch.isfinite(logits).all():
            raise AssertionError(f"{what} b={b}: non-finite logits")
        err = (logits - ref).abs().max().item()
        top1 = (logits.argmax(-1) == ref.argmax(-1)).float().mean().item()
        print(f"{what} request b={b}: logits {tuple(logits.shape)}, max |kernel - plain| "
              f"{err:.6g}, top-1 agreement {top1:.4f}", flush=True)
        torch.testing.assert_close(logits, ref, atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
        if logits.dim() == 2 and top1 < 1.0:
            raise AssertionError(f"{what} b={b}: top-1 differs from the plain-version run")
    return launches


def phase_point_serve(seed: int, dev):
    """Float clouds of b = 1, 8, 64 through a full-width PointClassifier:
    per request one FPS launch and 12 of each fused sublayer."""
    from metatransformer_tpu_torch.core import encoder as enc
    from metatransformer_tpu_torch.models import point_classifier as pc

    cfg = _point_cfg()
    if int(POINT_N * cfg.tokenizer.sample_ratio) + 1 != POINT_T:
        raise AssertionError("point geometry does not give 257 tokens")
    params = pc.init(cfg, torch.Generator().manual_seed(seed))  # lands on the card
    model = pc.PointClassifier(cfg, params, precision=enc.BF16)
    requests = [_clouds(seed + 1 + b, b, POINT_N) for b in POINT_SERVE_BATCHES]
    depth = cfg.encoder.depth
    launches = _serve_points(
        "point", model, requests, POINT_CLASSES,
        {"fps": 1, "attn_sublayer": depth, "mlp_sublayer": depth}, dev)
    return model, launches


def phase_seg_serve(seed: int, dev):
    """Float clouds of b = 1, 8 at 2048 points through a full-width
    PointSegmenter: 513 tokens, so per request one FPS launch and 12 of the
    flash forward kernel, whose last query and key tile holds one row."""
    from metatransformer_tpu_torch.core import encoder as enc
    from metatransformer_tpu_torch.models import point_segmenter as ps

    cfg = ps.PointSegmenterConfig()
    if int(SEG_N * cfg.tokenizer.sample_ratio) + 1 != SEG_T:
        raise AssertionError("segmenter geometry does not give 513 tokens")
    params = ps.init(cfg, torch.Generator().manual_seed(seed))
    model = ps.PointSegmenter(cfg, params, precision=enc.BF16)
    requests = [_clouds(seed + 3 + b, b, SEG_N) for b in SEG_SERVE_BATCHES]
    launches = _serve_points(
        "segmenter", model, requests, SEG_CLASSES,
        {"fps": 1, "flash_fwd": cfg.encoder.depth}, dev)
    return model, launches


def _point_batch(seed: int):
    """One fixed batch of clouds, labels arange(B) % 40."""
    return {"input": _clouds(seed, POINT_TRAIN_BATCH, POINT_N).numpy(),
            "label": np.arange(POINT_TRAIN_BATCH, dtype=np.int64) % POINT_CLASSES}


def _dropout_generator(seed: int):
    return torch.Generator(device="cuda").manual_seed(seed)


def _make_point_trainer(track: str, seed: int, lr: float = 1e-3):
    """Full-width point classifier through the port's entry points (no
    device named): AdamW at ``lr``, weight decay 0.05, BF16 policy, head
    dropout 0.5 as configured. The frozen track trains tokenizer, positional
    MLP, cls token and position, final LayerNorm and head."""
    from metatransformer_tpu_torch.core import encoder as enc
    from metatransformer_tpu_torch.models import point_classifier as pc
    from metatransformer_tpu_torch.train import optim, step as step_lib
    from metatransformer_tpu_torch.train.trainer import Trainer, TrainerConfig

    cfg = _point_cfg()
    params = pc.init(cfg, torch.Generator().manual_seed(seed))
    frozen_keys = step_lib.FROZEN_KEYS if track == "frozen" else ()
    if track == "frozen":  # a frozen encoder is cast once, outside the step
        params["encoder"] = enc.cast_params(params["encoder"], enc.BF16)
    trainer = Trainer(
        lambda p, x, generator: pc.forward(
            p, x, cfg, precision=enc.BF16, train=True, generator=generator),
        optim.make_optimizer("adamw", lr=lr, weight_decay=0.05), params,
        TrainerConfig(epochs=1, log_every=10**9), frozen_keys=frozen_keys,
    )
    if trainer.device.type != "cuda":
        raise AssertionError("the point trainer did not land on the card")
    return trainer


def phase_point_train(seed: int, dev) -> dict:
    depth = _point_cfg().encoder.depth
    return _train_tracks(
        "point train", lambda track, lr: _make_point_trainer(track, seed, lr),
        _point_batch(seed), POINT_TRAIN_STEPS, {"fps": 1, **{k: depth for k in FUSED_KERNELS}},
        {"frozen": 0, "full": 4 * depth}, POINT_CHECK_LR,
        make_generator=lambda: _dropout_generator(seed), fall_every_step=False,
        update_bounds=POINT_UPDATE_BOUNDS)


def _make_point_mae_trainer(seed: int):
    """The full-width masked point ViT (12 x 384 encoder, 4 x 192 decoder)
    through the port's entry points, everything trainable, AdamW 1e-3 /
    0.05, FP32 policy as the reference runs it."""
    from metatransformer_tpu_torch.models import point_mae as pm
    from metatransformer_tpu_torch.train import optim
    from metatransformer_tpu_torch.train.trainer import Trainer, TrainerConfig

    cfg = pm.MaskedPointViTConfig()
    return Trainer(
        lambda p, x, generator: pm.forward(p, x, generator, cfg)[0],
        optim.make_optimizer("adamw", lr=1e-3, weight_decay=0.05),
        pm.init(cfg, torch.Generator().manual_seed(seed)),
        TrainerConfig(epochs=1, log_every=10**9),
        loss_fn=lambda loss, label: loss, frozen_keys=(),
    )


def phase_point_mae(seed: int, dev) -> dict:
    """Two AdamW steps of the masked point ViT at batch 32 under the FP32
    policy: 64 groups of 32, 16 visible; one FPS launch a step and none of
    the attention kernels (T = 17 and 65 materialise). Held against the
    plain versions on the card."""
    from metatransformer_tpu_torch import ops

    clouds = _clouds(seed + 5, POINT_MAE_BATCH, POINT_N).numpy()

    def run(count):
        trainer = _make_point_mae_trainer(seed)
        masks = torch.Generator(device=trainer.device).manual_seed(seed)
        losses, counts = [], []
        for _ in range(POINT_MAE_STEPS):
            losses.append(trainer.train_epoch([{"input": clouds}], masks)["loss"])
            counts.append(count())
        return losses, counts

    ops.reset_launch_counts()
    losses, per_step = run(ops.launch_counts)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    _check_launches_per_request(per_step, {"fps": 1}, "point MAE step")
    with _plain_versions():
        ref_losses, _ = run(lambda: None)  # the plain versions count nothing
    diffs = [abs(a - b) for a, b in zip(losses, ref_losses)]
    print(f"point MAE: {POINT_MAE_STEPS} AdamW steps at batch {POINT_MAE_BATCH} (FP32 "
          f"policy), losses " + " ".join(f"{v:.5f}" for v in losses)
          + "; |loss diff| vs plain versions " + " ".join(f"{v:.2g}" for v in diffs)
          + f" (tol {MAE_LOSS_TOL}); launches {launches}", flush=True)
    if not all(np.isfinite(losses)):  # each step draws a new mask: no fall is asked
        raise AssertionError(f"point MAE: losses {losses}")
    if max(diffs) > MAE_LOSS_TOL:
        raise AssertionError(f"point MAE: losses differ from the plain run: {diffs}")
    torch.cuda.empty_cache()
    return launches


def phase_point_times(model, seg_model, seed: int, dev, profile: bool):
    """Classifier forward at b = 1, 8, 64, segmenter forward at b = 1, 8,
    one step of each classifier track and of the masked point ViT."""
    with torch.no_grad():
        for what, net, n, batches in (("point", model, POINT_N, POINT_SERVE_BATCHES),
                                      ("segmenter", seg_model, SEG_N, SEG_SERVE_BATCHES)):
            for b in batches:
                clouds = _clouds(seed + 7, b, n).to(dev)
                torch.cuda.reset_peak_memory_stats()
                ms = _median_ms(lambda: net(clouds))
                peak = torch.cuda.max_memory_allocated() / 2**30
                print(f"{what} forward b={b} N={n}: {ms:.4f} ms, {b * 1000.0 / ms:.2f} clouds/s, "
                      f"peak memory {peak:.3f} GiB (median of {TIMING_REPS}, float32 clouds "
                      f"on the card -> logits)", flush=True)
                if profile and (b == batches[-1] or what == "segmenter"):
                    _profile_step(lambda: net(clouds), f"{what} forward b={b}")
    del model, seg_model
    torch.cuda.empty_cache()
    batch = _point_batch(seed)
    for track in ("frozen", "full"):
        trainer = _make_point_trainer(track, seed)
        _time_step(f"point train step {track}", trainer, batch, "clouds",
                   _dropout_generator(seed),
                   "point full-track step" if profile and track == "full" else None)
        del trainer
        torch.cuda.empty_cache()
    trainer = _make_point_mae_trainer(seed)
    masks = torch.Generator(device=trainer.device).manual_seed(seed)
    _time_step("point MAE step (FP32 policy)", trainer,
               {"input": _clouds(seed + 5, POINT_MAE_BATCH, POINT_N).numpy()}, "clouds", masks)
    del trainer
    torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also print device time by kernel of one full-track image step, "
                         "one video forward at b=8, one full-track video step, the point "
                         "and segmenter forwards at their largest batch and one full-track "
                         "point step")
    args = ap.parse_args()

    phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    errs = phase_kernels(args.seed, dev)
    phase_autograd(args.seed, dev)
    model, serve_launches = phase_serve(args.seed, dev)
    times = phase_times(model, args.seed, dev)
    del model
    train_launches = phase_train(args.seed, dev)
    torch.cuda.empty_cache()
    phase_train_times(args.seed, dev, args.profile)

    errs.update(phase_flash_kernels(args.seed, dev))
    phase_flash_autograd(args.seed, dev)
    video_model, video_serve_launches = phase_video_serve(args.seed, dev)
    times.update(phase_flash_times(args.seed, dev))
    phase_video_times(video_model, args.seed, dev, args.profile)
    del video_model
    torch.cuda.empty_cache()
    video_train_launches = phase_video_train(args.seed, dev)
    mae_launches = phase_video_mae(args.seed, dev)
    phase_video_mae_time(args.seed, dev)

    errs["fps"] = phase_fps_kernel(args.seed, dev)
    times.update(phase_fps_times(args.seed, dev))
    point_model, point_serve_launches = phase_point_serve(args.seed, dev)
    seg_model, seg_serve_launches = phase_seg_serve(args.seed, dev)
    phase_point_times(point_model, seg_model, args.seed, dev, args.profile)
    del point_model, seg_model
    torch.cuda.empty_cache()
    point_train_launches = phase_point_train(args.seed, dev)
    point_mae_launches = phase_point_mae(args.seed, dev)

    by_path = {
        "serve": serve_launches,
        **{f"train_{k}": v for k, v in train_launches.items()},
        "video_serve": video_serve_launches,
        **{f"video_train_{k}": v for k, v in video_train_launches.items()},
        "video_mae": mae_launches,
        "point_serve": point_serve_launches,
        **{f"point_train_{k}": v for k, v in point_train_launches.items()},
        "seg_serve": seg_serve_launches,
        "point_mae": point_mae_launches,
    }
    on_path = {  # the kernels each path must have gone through
        "serve": ("attn_sublayer", "mlp_sublayer"),
        "train_frozen": FUSED_KERNELS, "train_full": FUSED_KERNELS,
        "video_serve": ("flash_fwd",),
        "video_train_frozen": FLASH_KERNELS, "video_train_full": FLASH_KERNELS,
        "video_mae": FLASH_KERNELS,
        "point_serve": ("fps", "attn_sublayer", "mlp_sublayer"),
        "point_train_frozen": ("fps", *FUSED_KERNELS),
        "point_train_full": ("fps", *FUSED_KERNELS),
        "seg_serve": ("fps", "flash_fwd"),
        "point_mae": ("fps",),
    }
    for path, kinds in on_path.items():
        for kind in kinds:
            if by_path[path][kind] <= 0:
                raise AssertionError(f"{path} never launched {kind}")
    print(json.dumps({"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": sum(counts[name] for counts in by_path.values()),
            "launches_by_path": {path: counts[name] for path, counts in by_path.items()},
            "max_abs_err": errs[name],
            "ms": times[name]["ms"],
            "plain_ms": times[name]["plain_ms"],
            "bound_ms": times[name]["bound_ms"],
            "bound_by": times[name]["bound_by"],
            # one PyTorch call for the same function: scaled_dot_product_attention
            # for the flash forward, autograd's backward through it for dq and
            # dk/dv together; none computes a whole fused sublayer or FPS; for FPS
            # max_abs_err counts differing indices: 0 is index-exact
            "library_ms": times[name].get("library_ms"),
            **({"library_composition_ms": times[name]["library_composition_ms"]}
               if "library_composition_ms" in times[name] else {}),
        }
        for name, (replaces, source) in KERNELS.items()
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
