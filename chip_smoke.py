"""Chip smoke test of the PyTorch/CUDA port: drives the ViT-B16 image
serving path on one NVIDIA GPU through the hand-written kernels.

    python3 chip_smoke.py [--seed N]

Phases (any failed check raises, so the process exits non-zero):

1. device: require a CUDA card, print its name and power limit, turn TF32
   off for fp32 matmuls and convolutions;
2. build the kernels from ``metatransformer_tpu_torch/ops/csrc``;
3. hold each kernel against its plain PyTorch version, computed in fp32
   from the same bf16 inputs, at the serving path's shapes;
4. serve a few uint8 image batches (b = 1, 8, 128) through a full-width
   ViT-B16 classifier (seeded random weights, 1000 classes), count the
   kernel launches of that run, and hold the logits against the same model
   run with the plain versions on the card;
5. time each kernel and its plain version, and the whole forward;
6. print one JSON line describing the kernels, then the result line.

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

import torch

D, HEADS, T, MLP = 768, 12, 197, 3072
LN_EPS = 1e-5
KERNEL_BATCHES = (1, 8, 128)
SERVE_BATCHES = (1, 8, 128)
# Kernel vs its plain version computed in fp32 from the same bf16 inputs:
# max abs error 3e-2, about 4 bf16 ulps at |x| ~ 1. It covers the kernel's
# own bf16 roundings (LN output, q/k/v, P, the attention output, the GELU
# output and the result); outputs reach |x| ~ 7, where rounding the
# result alone costs up to 1.6e-2.
KERNEL_TOL = 3e-2
# Served logits vs the plain-version model: the drift bound of the
# reference's fused-vs-XLA bf16 encoder test (tests/test_fused_block.py).
LOGIT_ATOL, LOGIT_RTOL = 0.15, 0.1
TIMING_REPS = 20

KERNELS = {
    "attn_sublayer": "metatransformer_tpu/ops/fused_block.py:82",
    "mlp_sublayer": "metatransformer_tpu/ops/fused_block.py:562",
}
SOURCE = "metatransformer_tpu_torch/ops/csrc/fused_block.cu"


def phase_device() -> str:
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
    return torch.cuda.get_device_name(0)


def phase_build():
    from metatransformer_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    print(f"build: {_build.library_path().name} in {time.perf_counter() - t0:.2f} s",
          flush=True)


def _sublayer_inputs(kind: str, b: int, seed: int, dev):
    """Seeded bf16 inputs at unit scale: x ~ N(0, 1), weights scaled by
    fan_in**-0.5 so every product stays O(1)."""
    g = torch.Generator().manual_seed(seed)
    randn = lambda *s: torch.randn(*s, generator=g)
    hidden, out_in = (3 * D, D) if kind == "attn_sublayer" else (MLP, MLP)
    bf = torch.bfloat16
    return (
        randn(b, T, D).to(dev, bf),
        (1.0 + 0.1 * randn(D)).to(dev),
        (0.1 * randn(D)).to(dev),
        (randn(D, hidden) * D**-0.5).to(dev, bf),
        (0.1 * randn(hidden)).to(dev, bf),
        (randn(out_in, D) * out_in**-0.5).to(dev, bf),
        (0.1 * randn(D)).to(dev, bf),
    )


def _pair(kind: str):
    from metatransformer_tpu_torch.ops import fused_block as fb

    if kind == "attn_sublayer":
        kw = dict(num_heads=HEADS, ln_eps=LN_EPS)
        return (
            lambda a, bias=None: fb.attn_sublayer_cuda(*a, bias, **kw),
            lambda a, bias=None: fb.attn_sublayer_plain(*a, bias, **kw),
        )
    return (
        lambda a, bias=None: fb.mlp_sublayer_cuda(*a, ln_eps=LN_EPS),
        lambda a, bias=None: fb.mlp_sublayer_plain(*a, ln_eps=LN_EPS),
    )


def phase_kernels(seed: int, dev) -> dict:
    from metatransformer_tpu_torch.ops import fused_block as fb

    worst = {}
    for kind in KERNELS:
        kernel, plain = _pair(kind)
        cases = [(b, None) for b in KERNEL_BATCHES]
        if kind == "attn_sublayer":
            keep = torch.ones(8, T, dtype=torch.bool, device=dev)
            for i in range(8):
                keep[i, T - 23 * i:] = False  # ragged: 197, 174, ..., 36 kept
            cases.append((8, torch.where(keep, 0.0, fb.NEG_INF).float()))
        worst[kind] = 0.0
        for b, bias in cases:
            args = _sublayer_inputs(kind, b, seed + b, dev)
            with torch.no_grad():
                got = kernel(args, bias).float()
                torch.cuda.synchronize()
                want = plain([a.float() for a in args], bias)
            if not torch.isfinite(got).all():
                raise AssertionError(f"{kind} b={b}: non-finite kernel output")
            max_abs = (got - want).abs().max().item()
            tag = "masked" if bias is not None else "dense"
            print(f"{kind} b={b} {tag}: max_abs_err {max_abs:.6g} vs the fp32 plain "
                  f"version (tol {KERNEL_TOL}, max |x| {want.abs().max().item():.4g})",
                  flush=True)
            if max_abs > KERNEL_TOL:
                raise AssertionError(f"{kind} b={b} {tag}: kernel disagrees with plain")
            worst[kind] = max(worst[kind], max_abs)
    return worst


def _serve(model, requests, dev):
    """Answer each request: uint8 images -> (logits, top-5 classes)."""
    answers = []
    for images in requests:
        logits = model(images.to(dev))
        answers.append((logits, logits.topk(5, dim=-1).indices))
    return answers


def phase_serve(seed: int, dev):
    from metatransformer_tpu_torch.core import encoder as enc
    from metatransformer_tpu_torch.models import image_classifier as ic
    from metatransformer_tpu_torch.ops import fused_block as fb

    cfg = ic.ImageClassifierConfig()  # ViT-B16, 224^2, patch 16, 1000 classes
    params = ic.init(cfg, torch.Generator().manual_seed(seed))
    model = ic.ImageClassifier(cfg, params, precision=enc.BF16, device=dev)
    g = torch.Generator().manual_seed(seed + 1)
    requests = [
        torch.randint(0, 256, (b, 224, 224, 3), generator=g, dtype=torch.uint8)
        for b in SERVE_BATCHES
    ]
    depth = cfg.encoder.depth

    fb.reset_launch_counts()
    answers, per_request = [], []
    for images in requests:
        answers += _serve(model, [images], dev)
        per_request.append(fb.launch_counts())
    torch.cuda.synchronize()
    launches = fb.launch_counts()
    print(f"served {len(requests)} requests, kernel launches {launches}", flush=True)
    for kind in launches:
        counts = [c[kind] for c in per_request]
        grew = [b - a for a, b in zip([0] + counts, counts)]
        if grew != [depth] * len(requests):
            raise AssertionError(f"{kind}: launches per forward {grew}, expected {depth}")

    # The same model with the plain versions on the card, request by request.
    with mock.patch.object(fb, "attn_sublayer_cuda", fb.attn_sublayer_plain), \
            mock.patch.object(fb, "mlp_sublayer_cuda", fb.mlp_sublayer_plain):
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


def _median_ms(fn) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(TIMING_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_times(model, seed: int, dev) -> dict:
    times = {}
    with torch.no_grad():
        for kind in KERNELS:
            kernel, plain = _pair(kind)
            args = _sublayer_inputs(kind, 128, seed, dev)
            times[kind] = (_median_ms(lambda: kernel(args)), _median_ms(lambda: plain(args)))
            print(f"{kind} b=128: kernel {times[kind][0]:.4f} ms, plain "
                  f"{times[kind][1]:.4f} ms (median of {TIMING_REPS})", flush=True)
    g = torch.Generator().manual_seed(seed + 2)
    for b in (128, 1):
        images = torch.randint(0, 256, (b, 224, 224, 3), generator=g,
                               dtype=torch.uint8).to(dev)
        ms = _median_ms(lambda: model(images))
        print(f"forward b={b}: {ms:.4f} ms, {b * 1000.0 / ms:.2f} seq/s "
              f"(median of {TIMING_REPS}, uint8 on the card -> logits)", flush=True)
    return times


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    card = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    errs = phase_kernels(args.seed, dev)
    model, launches = phase_serve(args.seed, dev)
    times = phase_times(model, args.seed, dev)
    print(json.dumps({"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": SOURCE,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": times[name][0],
            "plain_ms": times[name][1],
        }
        for name, replaces in KERNELS.items()
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
