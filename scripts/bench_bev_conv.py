"""Time the 3x3 BEV convs of SECOND's backbone (b = 1, 2, 4), of
PointPillars' (its recipe's b = 32) and of CenterPoint's head (its shared
512 -> 64 conv and a separate head's 64 -> 64 and 64 -> 3 convs on the
KITTI, nuScenes and Waymo BEV maps at their YAMLs' batches 2, 4, 4) on the
card (fp32, TF32 off): cuDNN as
``vit_adapter.conv2d`` calls it (NHWC permuted to an NCHW view), cuDNN on a
contiguous NCHW input, and the patch GEMM of ``detector3d.conv3x3_gemm``
that ``detector3d.bev_backbone`` runs; each with
``torch.backends.cudnn.benchmark`` off and on.

    python scripts/bench_bev_conv.py [centerpoint]

(``centerpoint``: CenterPoint's cases only.) Prints the card's name and
power limit, then one line a shape: ms of one forward (CUDA events around 10 calls,
over the count), of a forward and backward on each of the two paths the
backbone could take, and the peak memory each forward and backward
allocates above its inputs.
"""

import subprocess
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, ".")
from metatransformer_tpu_torch.models import detector3d  # noqa: E402
from metatransformer_tpu_torch.models.vit_adapter import conv2d  # noqa: E402

# (H, W, Cin, Cout, stride) of each block's first conv and of its others
SECOND = ((200, 176, 256, 128, 1), (200, 176, 128, 128, 1), (200, 176, 128, 256, 2),
          (100, 88, 256, 256, 1))
POINTPILLARS = ((496, 432, 64, 64, 2), (248, 216, 64, 64, 1), (248, 216, 64, 128, 2),
                (124, 108, 128, 128, 1), (124, 108, 128, 256, 2), (62, 54, 256, 256, 1))
# CenterPoint's shared conv (2 x 256 BEV channels -> 64) and one separate
# head's two convs, on the BEV map of each YAML's grid (1/8 of it)
CENTERPOINT = [(f"CenterPoint {name}", b, ((h, w, 512, 64, 1), (h, w, 64, 64, 1),
                                            (h, w, 64, 3, 1)))
               for name, b, h, w in (("KITTI", 2, 200, 176), ("nuScenes", 4, 128, 128),
                                     ("Waymo", 4, 188, 188))]
CASES = ([("SECOND", b, SECOND) for b in (1, 2, 4)] + [("PointPillars", 32, POINTPILLARS)]
         + CENTERPOINT)


def timed(fn, reps: int = 10) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def peak_gib(fn) -> float:
    """GiB that one call of ``fn`` allocates above what was live before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**30


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    cases = CENTERPOINT if sys.argv[1:] == ["centerpoint"] else CASES
    for bench in (False, True):
        torch.backends.cudnn.benchmark = bench
        for model, b, shapes in cases:
            for h, w, cin, cout, s in shapes:
                x = torch.randn(b, h, w, cin, generator=g).to(dev)
                wt = (torch.randn(3, 3, cin, cout, generator=g) * 0.05).to(dev)
                xc = x.permute(0, 3, 1, 2).contiguous()
                wc = wt.permute(3, 2, 0, 1).contiguous()
                pad = (0, 1, 0, 1) if s == 2 else (1, 1, 1, 1)
                xr, wr = x.clone().requires_grad_(True), wt.clone().requires_grad_(True)

                def cudnn_step():
                    conv2d(xr, wr, stride=s).sum().backward()

                def gemm_step():
                    detector3d.conv3x3_gemm(xr, wr, s).sum().backward()

                view = timed(lambda: conv2d(x, wt, stride=s))
                nchw = timed(lambda: F.conv2d(F.pad(xc, pad), wc, stride=s))
                gemm = timed(lambda: detector3d.conv3x3_gemm(x, wt, s))
                cudnn_both, gemm_both = timed(cudnn_step, 5), timed(gemm_step, 5)
                cudnn_mem, gemm_mem = peak_gib(cudnn_step), peak_gib(gemm_step)
                gflop = 2 * 9 * cin * cout * b * (h // s) * (w // s) / 1e9
                print(f"benchmark={bench} {model} b={b} {h}x{w} {cin}->{cout} stride {s} "
                      f"({gflop:.1f} GFLOP): cuDNN view {view:.3f} ms, cuDNN NCHW {nchw:.3f} ms, "
                      f"patch GEMM {gemm:.3f} ms; forward + backward cuDNN view {cudnn_both:.3f} "
                      f"ms ({cudnn_mem:.3f} GiB), patch GEMM {gemm_both:.3f} ms "
                      f"({gemm_mem:.3f} GiB)", flush=True)
                del x, xc, xr, wr


if __name__ == "__main__":
    main()
