"""Chip smoke test of the PyTorch/CUDA port: drives the ViT-B16 image
serving path, the ViT-B16 image training step, the ViT-B16 video classifier
(16 x 224^2 clip, 1568 tokens; served and trained, frozen-encoder and full
fine-tune), the ViT-B16 point-cloud models (classifier served and trained,
segmenter served, masked point ViT trained, multi-view classifier served),
a whole ViT-L14 image classifier (served and trained), all 12
modalities of ``pipeline.Data2Seq`` with the fused multimodal trio, the
bucket ladder and the audio, hyper-spectral, tabular and time-series models
(served), the serving edge (``serving.Dispatcher``, ``ServingDaemon``, byte
payloads), the graph predictor, the demo CLI, the dense-prediction family
(ViT-Adapter with UperNet, test-time augmentation, windowed blocks and
Mask2Former at 512^2), 2D detection (Mask R-CNN, Cascade R-CNN and HTC++
over the ViT-Adapter at 1024^2), KITTI 3D detection (PointPillars, SECOND,
Voxel R-CNN and PV-RCNN) and every ported training recipe through
``train_cli`` on one NVIDIA GPU through the hand-written kernels.

    python3 chip_smoke.py [--seed N] [--profile]
    python3 chip_smoke.py --bwd-times      # only the flash backward and video-step times
    python3 chip_smoke.py --kernel-times   # only #1-#4, #7 and the forwards and steps they carry
    python3 chip_smoke.py --fps-plans      # only #7 under its launch plan and variants of it
    python3 chip_smoke.py --serving        # only the serving edge, the graph predictor, the demo
    python3 chip_smoke.py --recipes        # only every ported recipe YAML through train_cli
    python3 chip_smoke.py --dense          # only phase_dense and the dense recipes' holds and steps
    python3 chip_smoke.py --detection      # only phase_detection and the COCO recipes' holds and steps
    python3 chip_smoke.py --det3d          # only phase_det3d and the KITTI recipes through train_cli

Phases (any failed check raises, so the process exits non-zero):

1. device: require a CUDA card, print its name and power limit, turn TF32
   off for fp32 matmuls and convolutions;
2. build the kernels from ``metatransformer_tpu_torch/ops/csrc`` and print
   the registers and spills of the wgmma and FPS kernels;
3. hold each kernel against its plain PyTorch version, computed in fp32
   from the same bf16 inputs, at the shapes of the image path (T = 197), of
   the point classifier (T = 257), of ViT-L14 (D = 1024, 16 heads of 64,
   T = 257) and of the pipeline (T = 1 ... 256, masked where its paths
   mask); the backward kernel is launched twice and must repeat bit for
   bit;
4. hold both autograd Functions (attention and MLP sublayer) against
   autograd through the plain versions in fp32;
5. serve a few uint8 image batches (b = 1, 8, 128) through a full-width
   ViT-B16 classifier (seeded random weights, 1000 classes), count the
   kernel launches of that run, and hold the logits against the same model
   run with the plain versions on the card;
6. time each kernel (a loop of launches between two CUDA events, over the
   count; the median of one timed call beside it), its plain version and
   the library composition of the same function, the attention core of #1
   alone, and the whole forward; then serve one uint8 batch of 8 through a
   whole ViT-L14 classifier (24 blocks of 1024, patch 14, T = 257) the
   same way, launches and logits held, and time its forward;
7. train: for each track build the full-width model through
   ``image_classifier.init`` and ``Trainer`` (no device named: both land on
   the card), take 6 AdamW steps on one fixed batch of 128, count the kernel
   launches and weight-gradient products of each step, and hold the first 2
   steps (losses, the first gradient and the update of the largest leaf)
   against the same run with the plain versions on the card;
8. time one optimizer step of each track, with its peak memory; with
   ``--profile``, device time by kernel of a full-track step; then one
   full-track AdamW step of the whole ViT-L14 classifier at b = 8, held
   against the plain versions at the image bounds;
9. video: hold the three flash-attention kernels (forward, dq, dk/dv)
   against their plain versions at B*H = 12 and 96, T = 1568, head_dim 64,
   dense, ragged and with a fully masked sample, at the segmenter's T = 513
   (a last tile of one row), at the edges of the bf16 backward's 128-row
   blocks (T = 127, 128, 129, 257), at head_dim 32 and 128, at the
   pipeline's T = 1212 and 2876 and its ragged 1600 / 3072 buckets, in bf16
   and fp32, and the autograd Function against fp32 autograd; serve uint8 clips
   of b = 1 and 8 and one 15-view request through a full-width
   ``VideoClassifier``; take 4 AdamW steps of each track at batch 8 through
   ``Trainer``, and one full-track step with ``remat=True`` and one with
   ``remat="save"`` against one without from the same weights and batch;
   take 2 steps of the video-MAE loss at batch 4 (the fp32 kernel route);
   each against the plain versions on the card; then time the kernels, the
   whole flash backward, the clip forward and one step of each track;
10. point clouds: hold the furthest-point-sampling kernel against its plain
    version index for index on every route of its launch plan (one block,
    a thread block cluster, the largest cluster, the device-memory route),
    on duplicated points with ties across a cluster's blocks, through
    masked_fps with ragged masks, with a second launch bit-equal; serve
    float clouds of b = 1, 8, 64 (1024 points, 257 tokens, fused sublayers)
    through a full-width ``PointClassifier`` and of b = 1, 8 (2048 points,
    513 tokens, flash attention) through a full-width ``PointSegmenter``;
    take 4 AdamW steps of both classifier tracks at batch 32 through
    ``Trainer``, then one step of each track with head dropout off and the
    max-pools and head ReLUs pinned to the plain run's choices (at the image
    bounds), and 2 steps of the masked point ViT at batch 32 (FP32); serve
    8 clouds through the multi-view classifier (32 rendered views); each
    against the plain versions on the card; time the kernel, the forwards
    and one step of each track (``--profile``: also the masked point ViT
    step);
11. the modalities at ViT-B16 width, BF16: each of the 12 modalities
    (text, tabular, graph, time series, IMU, hyper-spectral, image, x-ray,
    infrared, point, audio, video; the batches and raw schemas of
    scripts/bench_modalities.py) through ``Data2Seq``, 3 requests straight
    into the encoder (T = 1 ... 1568) and 3 padded to their bucket through
    ``encode_bucketed_pooled``, with each modality's seq/s; the README trio
    (video, audio from waveforms, time series: 2876 tokens) through the
    multimodal classifier under BF16 and FP32, with its batch-1 latency; one
    ragged call at every bucket 64 ... 3072; the audio classifier from
    waveforms (fbank on the card against its numpy oracle), the
    hyper-spectral classifier in ViT and CAF modes, the tabular classifier
    and the time-series forecaster; each against the plain versions on the
    card, launches held; the CLIP text tower against itself in float64;
    the fused sublayers and flash kernels are held at these paths' shapes in
    phases 3 and 9;
12. the serving edge at ViT-B16 width, BF16: all 12 modalities behind one
    ``serving.Dispatcher`` (the batch-1 requests of
    scripts/bench_serving.py: uint8 pixels, a padded graph dict), one mixed
    flush of 2 requests a modality on the bucketed and on the packed path,
    launches held to what the flush's groups need and answers against the
    plain versions; a ``ServingDaemon`` (max_batch 24, max_wait 0.3 s) on
    each path: one warm-up storm, 2 timed storms of 6 requests a modality,
    every future read, requests/s, p50 and p99; byte payloads (npy, npz, WAV, UTF-8, a
    DIB AVI; PNG where Pillow imports) through the daemon, decoded equal to
    their array twins and answered as the twins are;
13. the graph predictor at ``enc.GRAPH_BASE`` (32 heads of 24, T = 194) on
    64 collated random molecules, BF16, plain attention and Performer (no
    kernel launched: head_dim 24), FP32 against the CPU at 1e-4, ms and
    graphs/s; then ``demo.main`` on the card for ``--modality image
    --synthetic`` and a WAV file;
13a. dense prediction at the ADE20K YAMLs' full width (ViT-B16 adapter,
    512^2, 150 classes, BF16): the UperNet segmentor serves b = 1 and 2 (12
    flash forwards a request, T = 1024), ``tta_inference`` at b = 1 (T =
    576, 1024, 1600; 72 flash forwards; probabilities sum to 1), the
    windowed adapter at b = 2 (8 of each fused sublayer at 18 windows of
    T = 196, 4 flash forwards; one backward of its loss: 8 launches of #3,
    4 of #5 and #6), the Mask2Former segmentor at b = 2 (its
    attention masks recorded from the plain run and replayed); each against
    the plain versions, launches exactly; the card's antialiased bilinear and
    bicubic resizes (forward and backward) against the CPU; the three
    forwards timed at b = 2 (``--profile``: by kernel, and the share of the
    UperNet forward outside the 12 ViT blocks);
13b. 2D detection at the COCO YAMLs' full width (ViT-B16 adapter, 1024^2,
    T = 4096, 80 classes, BF16): the backbone, FPN and RPN at b = 1 and 2
    (every FPN map and RPN output held), ``forward_test`` of Mask R-CNN,
    Cascade R-CNN and HTC++ at b = 1 and 2 (12 flash forwards a request and
    no other launch; boxes, scores, labels, masks and HTC++'s semantic
    logits against the plain versions, with the top-k, NMS keeps, RoI
    levels and top classes recorded from the plain run and replayed), one
    backward of the Mask R-CNN loss at b = 2 (12 launches each of #4-#6,
    its assignments replayed too; peak memory), ``large_scale_jitter`` on
    the card against the CPU at scales 0.3, 0.8, 1.7; the three forwards
    and the NMS loop timed at b = 2, median of 10 (``--profile``: by
    kernel, the idle share, the NMS loop's kernels and the share outside
    the 12 ViT blocks);
13c. KITTI 3D detection at the YAMLs' full width (fp32, seeded weights):
    the ops on a 16,384-point scan against the CPU (the voxel set in the
    (41, 1600, 1408) grid, a submanifold, strided and inverse sparse conv:
    active sets equal, features at 1e-4 of their scale; the rotated IoU and
    NMS of 1024 boxes: keep set equal); ``forward`` and ``predict`` of
    PointPillars, SECOND, Voxel R-CNN and PV-RCNN at b = 1 on 16,384 points
    and b = 2 on 1,024 against the same code on the CPU, the voxel set,
    top-k, NMS keeps, grid-pool voxels and ball-group members recorded there
    and replayed (``_det3d_pins``); PV-RCNN one launch of #7 a forward, the
    others none; one backward of each loss at b = 2 against the CPU (its
    assignments and RoI sampling replayed too); #7 at PV-RCNN's
    (2, 1024, 2048) and (1, 16384, 2048) against its plain version; the
    forwards, predicts and NMS loops timed at both cases, median of 10
    (``--profile``: each predict's and NMS loop's device time by kernel);
13d. the training entry point: ``train_cli.main`` as a user runs it (no
    ``--device``, no ``--smoke``: the card, full width) on each of the 36
    ported recipe YAMLs of ``metatransformer_tpu/configs/``, 1 epoch of 2
    steps at ``train.batch_size=min(yaml, 8)`` (modelnet40 at its own 32,
    the three dense and the four COCO detection recipes at 2, the four
    KITTI recipes at their own 32, 4, 2 and 2; ViT-B16);
    each recipe's launches counted under ``recipes_<stem>`` and held to the
    kernels its T resolves to, a finite final loss, its step timed as
    ``train_cli.setup`` builds it (median of 20, the detection recipes of
    10, batch on the card); ``--eval`` and ``--eval-all`` on modelnet40's work dir,
    ``--data`` on a JPEG tree the phase writes for imagenet; the shape of
    every kernel call of these runs recorded, and each kernel held against
    its plain version at each of those shapes (T = 9 ... 2876, ViT-L14's
    widths, the fp32 route, FPS over 1024 ... 8192 points) at the bounds of
    phases 3, 9 and 10; modelnet40 and s3dis (4096 points, T = 1025, the
    segmenter's first training on the card) held against two steps on the
    plain versions at the point bounds, and so are ade20k_upernet,
    ade20k_mask2former (Mask2Former's attention masks, assignments and loss
    points recorded from the plain run and replayed; then both runs again
    with the head's products at full precision, losses within the plain
    bound), coco_mask_rcnn and coco_htcpp (proposals, RoI levels and
    assignments replayed); the bare
    point-classifier step timed beside the flagship's;
14. the host: the C++ host runtime (grid subsampling, kNN) against its
    numpy twins, and host-to-device copy times of an image and a cloud
    batch;
15. print one JSON line describing the kernels, then the result line.

It imports nothing of JAX. Without a CUDA card it raises before printing
any result.
"""

from __future__ import annotations

import argparse
import dataclasses
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
# Mask2Former's loss sums 30 point-sampled terms (cls, mask, dice of 10
# layers; about 300 at init) from a head whose matmuls round both operands
# to bf16 (the reference's Precision.DEFAULT under BF16): a kernel's rounding
# moves an operand across a bf16 rounding edge now and then, one ulp (2**-8
# relative) at a time. Its losses are held at 1% of the plain run's, what
# LOSS_TOL is of a 5-nat cross-entropy; the card measures 0.2-0.35%. The
# hold then runs both again with the head's products at "highest", and
# those losses must agree within LOSS_TOL (the card: 0.03 of 335): what the
# kernels move, the head's bf16 rounding magnifies.
M2F_LOSS_RTOL = 1e-2
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
MULTIVIEW_BATCH = 8  # clouds a request of the multi-view classifier (4 views each)
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
# 1024 and 2048 points run on one block, 16384 on a cluster of 8 blocks,
# 65536 on the largest cluster (8 blocks of 8192) and 65537 on the
# device-memory route past it.
FPS_CASES = [(1, 1024, 256), (64, 1024, 256), (8, 2048, 512), (32, 1024, 64),
             (2, 16384, 4096), (1, 65536, 512), (1, 65537, 256)]
FPS_MAIN_CASE = (64, 1024, 256)  # the classifier's b = 64 request

# ViT-L14 (enc.LARGE): D = 1024, 16 heads of 64, MLP 4096, T = 257 at patch
# 14 on 224^2; its fused sublayers are held at b = 8.
LARGE_D, LARGE_HEADS, LARGE_MLP, LARGE_T, LARGE_BATCH = 1024, 16, 4096, 257, 8

# Dense prediction at the ADE20K YAMLs' full width: ViT-B16 adapter on 512^2
# (a 32 x 32 grid, no cls token: T = 1024, flash), 150 classes, BF16. TTA's
# 0.75 / 1.25 scales give T = 576 / 1600. The windowed adapter of the COCO /
# ADE recipes pads the grid to 42 and runs 9 windows of 14 x 14 an image:
# 18 windows of T = 196 (fused sublayers) at b = 2.
DENSE_YAML = "ade20k_mask2former_metatransformer"  # the backbone and head widths
DENSE_BATCHES = (1, 2)
DENSE_WINDOWS = (True, True, False) * 4
WINDOW_BATCH, WINDOW_T = 18, 196
DENSE_PROB_TOL = 1e-3  # TTA's averaged probabilities sum to 1
# jax.image.resize on the card: F.interpolate(antialias=True), bilinear and
# bicubic, forward and backward, against the CPU (fp32, unit-normal inputs;
# max abs error over max(1, max |value|)). (in, out, channels, method): the
# PPM's pools of the 1/32 map, Mask2Former's attention-mask resizes of the
# 1/4 masks, TTA's image resizes, the bicubic pos-embed resizes, the logits'
# resize to the input. The card's kernels compute each sample's position in
# fp32, the CPU's closer (it matches jax.image.resize to 1e-6 on the CPU,
# tests/test_torch_vit_adapter.py), so near a coordinate of 512 a position
# may be off by an ulp of 512 (6.1e-5; measured 1.9e-5 of value at
# 512 -> 384): a case's bound is RESIZE_TOL or two such ulps times the
# largest step between neighbouring input values (forward) or 4 |cotangent|
# (backward: a hat of slope at most 1, at most 4 outputs on an input),
# whichever is larger.
RESIZE_TOL = 1e-5
DENSE_RESIZES = [
    *[(16, s, 768, "bilinear") for s in (1, 2, 3, 6)],
    *[(128, s, 100, "bilinear") for s in (16, 32, 64)],
    (512, 384, 3, "bilinear"), (512, 640, 3, "bilinear"),
    (32, 24, 768, "bicubic"), (32, 40, 768, "bicubic"), (128, 512, 150, "bilinear"),
]

CSRC = "metatransformer_tpu_torch/ops/csrc/"
KERNELS = {
    "attn_sublayer": ("metatransformer_tpu/ops/fused_block.py:82", CSRC + "fused_block.cu"),
    "mlp_sublayer": ("metatransformer_tpu/ops/fused_block.py:562", CSRC + "fused_block.cu"),
    "attn_sublayer_bwd": (
        "metatransformer_tpu/ops/fused_block.py:310", CSRC + "fused_block_bwd.cu"),
    "flash_fwd": (
        "metatransformer_tpu/ops/flash_attention.py:70", CSRC + "flash_attention_fwd.cu"),
    "flash_bwd_dq": (
        "metatransformer_tpu/ops/flash_attention.py:137", CSRC + "flash_attention_bwd.cu"),
    "flash_bwd_dkv": (
        "metatransformer_tpu/ops/flash_attention.py:176", CSRC + "flash_attention_bwd.cu"),
    "fps": ("metatransformer_tpu/ops/point_ops.py:67", CSRC + "point_ops.cu"),
}
FUSED_KERNELS = ("attn_sublayer", "mlp_sublayer", "attn_sublayer_bwd")
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def _smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def phase_device() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: chip_smoke.py runs only on a GPU")
    print(_smi(), flush=True)  # name, power limit: as nvidia-smi gives them
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
    # registers, shared memory, spills and warnings of the wgmma kernels
    import re

    names = {p.name for p in _build._SOURCES}
    wanted = re.compile(r"(flash_fwd_wgmma|flash_bwd_dq_wgmma|flash_bwd_dkv_wgmma|attn_bwd_q|"
                        r"attn_bwd_kv|attn_core|gemm_sm90|fps_regs)I(\w+?)EEv|(fps_device)E")
    for source in ("fused_block.cu", "flash_attention_fwd.cu", "flash_attention_bwd.cu",
                   "fused_block_bwd.cu", "point_ops.cu"):
        if source not in names:  # an older checkout
            continue
        kernel = None
        for line in _build.ptxas_report(source).splitlines():
            if "Compiling entry function" in line:
                found = wanted.search(line)
                kernel = None
                if found and found.group(3):
                    kernel = found.group(3)
                elif found:  # template arguments: Li64 -> 64, Li0ELb1 -> 0,1
                    args = ",".join(re.findall(r"L[ib](\d+)", found.group(2)))
                    kernel = f"{found.group(1)}<{args}>"
            elif line.startswith("ptxas") and "warning" in line or (
                    kernel and ("spill" in line or "Used" in line)):
                print(f"ptxas -v {source} {kernel}: {line.strip()}", flush=True)


# --------------------------------------------------------------------------
# Kernels against their plain versions
# --------------------------------------------------------------------------


def _sublayer_inputs(kind: str, b: int, seed: int, dev, t: int = T, d: int = D,
                     mlp: int = MLP):
    """Seeded bf16 inputs at unit scale: x ~ N(0, 1) of ``t`` tokens of width
    ``d``, weights scaled by fan_in**-0.5 so every product stays O(1)."""
    g = torch.Generator().manual_seed(seed)
    randn = lambda *s: torch.randn(*s, generator=g)
    hidden, out_in = (mlp, mlp) if kind == "mlp_sublayer" else (3 * d, d)
    bf = torch.bfloat16
    return (
        randn(b, t, d).to(dev, bf),
        (1.0 + 0.1 * randn(d)).to(dev),
        (0.1 * randn(d)).to(dev),
        (randn(d, hidden) * d**-0.5).to(dev, bf),
        (0.1 * randn(hidden)).to(dev, bf),
        (randn(out_in, d) * out_in**-0.5).to(dev, bf),
        (0.1 * randn(d)).to(dev, bf),
    )


def _bwd_inputs(b: int, seed: int, dev, t: int = T, d: int = D):
    """The backward kernel's arguments: the attention inputs without proj_b,
    and a unit-scale cotangent g after x."""
    x, lns, lnb, wqkv, bqkv, wproj, _ = _sublayer_inputs("attn_sublayer", b, seed, dev, t, d)
    g = torch.randn(b, t, d, generator=torch.Generator().manual_seed(seed + 7))
    return (x, g.to(dev, torch.bfloat16), lns, lnb, wqkv, bqkv, wproj)


def _pair(kind: str, heads: int = HEADS):
    from metatransformer_tpu_torch.ops import fused_block as fb

    kw = dict(num_heads=heads, ln_eps=LN_EPS)
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


def _prefix_bias(b: int, t: int, dev):
    """Key bias of a ragged batch: sample i keeps its first
    max(1, t (i + 1) / b) tokens."""
    from metatransformer_tpu_torch.ops import fused_block as fb

    kept = torch.tensor([max(1, t * (i + 1) // b) for i in range(b)], device=dev)
    keep = torch.arange(t, device=dev)[None, :] < kept[:, None]
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
        # Data2Seq's token counts up to 256 at their serving batch, and the
        # masked ones: the graph's keep-mask and bucket, the ragged buckets
        cases += [(b, t, None) for b, t in
                  sorted({(b, t) for b, t, _ in MODALITY_SPECS.values() if t <= 256})]
        if kind == "attn_sublayer":
            cases += [(b, t, _prefix_bias(b, t, dev)) for b, t in MODALITY_MASKED_SHAPES]
        cases.append((WINDOW_BATCH, WINDOW_T, None))  # the windowed adapter's blocks
        worst[kind] = 0.0
        for b, t, bias in cases:
            args = _sublayer_inputs(kind, b, seed + b + t, dev, t)
            worst[kind] = max(worst[kind], _check_sublayer(kind, kernel, plain, args, bias))
        # ViT-L14's widths
        kernel, plain = _pair(kind, LARGE_HEADS)
        args = _sublayer_inputs(kind, LARGE_BATCH, seed + 11, dev, LARGE_T, LARGE_D, LARGE_MLP)
        worst[kind] = max(worst[kind], _check_sublayer(kind, kernel, plain, args, None, "L14 "))
    worst["attn_sublayer_bwd"] = max(
        phase_bwd_kernel(seed, dev),
        phase_bwd_kernel(seed, dev, [(LARGE_BATCH, LARGE_T, None)], LARGE_D, LARGE_HEADS, "L14 "))
    return worst


def _check_sublayer(kind, kernel, plain, args, bias, what: str = "") -> float:
    """One forward kernel against its fp32 plain version; the max abs error."""
    b, t, d = args[0].shape
    with torch.no_grad():
        got = kernel(args, bias).float()
        torch.cuda.synchronize()
        want = plain([a.float() for a in args], bias)
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}{kind} b={b} T={t}: non-finite kernel output")
    max_abs = (got - want).abs().max().item()
    tag = "masked" if bias is not None else "dense"
    print(f"{what}{kind} b={b} T={t} D={d} {tag}: max_abs_err {max_abs:.6g} vs the fp32 "
          f"plain version (tol {KERNEL_TOL}, max |x| {want.abs().max().item():.4g})",
          flush=True)
    if max_abs > KERNEL_TOL:
        raise AssertionError(f"{what}{kind} b={b} T={t} {tag}: kernel disagrees with plain")
    return max_abs


def phase_bwd_kernel(seed: int, dev, cases=None, d: int = D, heads: int = HEADS,
                     what: str = "") -> float:
    """All six outputs of the backward kernel vs its fp32 plain version;
    two launches must agree bit for bit (the dgamma / dbeta reduction has a
    fixed order and no atomics). Returns the worst absolute error."""
    kernel, plain = _pair("attn_sublayer_bwd", heads)
    names = ("dx", "dqkv", "xn", "o", "dlns", "dlnb")
    worst_abs = 0.0
    if cases is None:
        cases = [(b, T, None) for b in KERNEL_BATCHES] + [(8, T, _ragged_bias(dev))]
        # the point classifier's training batch, and its largest request's shape
        cases += [(POINT_TRAIN_BATCH, POINT_T, None), (POINT_SERVE_BATCHES[-1], POINT_T, None)]
        cases.append((WINDOW_BATCH, WINDOW_T, None))  # the windowed adapter's blocks
    for b, t, bias in cases:
        args = _bwd_inputs(b, seed + b + t, dev, t, d)
        with torch.no_grad():
            got = kernel(args, bias)
            again = kernel(args, bias)
            torch.cuda.synchronize()
            want = plain([a.float() for a in args], bias)
        tag = ("masked" if bias is not None else "dense") + f" D={d}"
        tag = what + tag
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

    _check_answers(model, requests, answers, cfg.num_classes, dev)
    return model, launches


def _check_answers(model, requests, answers, classes: int, dev, what: str = ""):
    """Answer the requests again with the plain versions on the card and
    hold the kernels' logits to them at the serving tolerance."""
    with _plain_versions():
        want = _serve(model, requests, dev)
    for (logits, top5), (ref, ref_top5), images in zip(answers, want, requests):
        b = images.shape[0]
        if logits.shape != (b, classes) or top5.shape != (b, 5):
            raise AssertionError(f"{what}b={b}: logits {tuple(logits.shape)}")
        if not torch.isfinite(logits).all():
            raise AssertionError(f"{what}b={b}: non-finite logits")
        err = (logits - ref).abs().max().item()
        top1 = (top5[:, 0] == ref_top5[:, 0]).float().mean().item()
        print(f"{what}request b={b}: logits {tuple(logits.shape)}, max |kernel - plain| "
              f"{err:.6g}, top-1 agreement {top1:.4f}, first top-5 "
              f"{top5[0].tolist()}", flush=True)
        torch.testing.assert_close(logits, ref, atol=LOGIT_ATOL, rtol=LOGIT_RTOL)


def _large_cfg():
    """ViT-L14 (enc.LARGE: 24 blocks of 1024, 16 heads of 64) at patch 14
    on 224^2 (T = 257), 1000 classes."""
    from metatransformer_tpu_torch.core import encoder as enc
    from metatransformer_tpu_torch.models import image_classifier as ic
    from metatransformer_tpu_torch.tokenizers import image as tok

    cfg = ic.ImageClassifierConfig(
        tokenizer=tok.ImageTokenizerConfig(224, 14, 3, LARGE_D), encoder=enc.LARGE,
        num_classes=1000)
    if cfg.tokenizer.num_patches + 1 != LARGE_T or cfg.encoder.dim != LARGE_D:
        raise AssertionError("ViT-L14 geometry does not give 257 tokens of 1024")
    return cfg


def phase_large_serve(seed: int, dev) -> dict:
    """A whole ViT-L14 image classifier (seeded random weights, no depth
    cut) serves one uint8 request of b = LARGE_BATCH: 24 launches of each
    fused sublayer, logits held against the same model on the plain
    versions on the card; then its forward time."""
    from metatransformer_tpu_torch import ops
    from metatransformer_tpu_torch.core import encoder as enc
    from metatransformer_tpu_torch.models import image_classifier as ic

    cfg = _large_cfg()
    model = ic.ImageClassifier(cfg, ic.init(cfg, torch.Generator().manual_seed(seed)),
                               precision=enc.BF16)
    if next(model.buffers()).device.type != "cuda":
        raise AssertionError("the ViT-L14 model did not land on the card")
    requests = [torch.randint(0, 256, (LARGE_BATCH, 224, 224, 3), dtype=torch.uint8,
                              generator=torch.Generator().manual_seed(seed + 1))]
    depth = cfg.encoder.depth
    ops.reset_launch_counts()
    answers = _serve(model, requests, dev)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    print(f"L14 served 1 request, kernel launches {launches}", flush=True)
    _check_launches_per_request(
        [launches], {"attn_sublayer": depth, "mlp_sublayer": depth}, "L14 serve")
    _check_answers(model, requests, answers, cfg.num_classes, dev, "L14 ")
    images = requests[0].to(dev)
    with torch.no_grad():
        ms = _median_ms(lambda: model(images))
    print(f"L14 forward b={LARGE_BATCH}: {ms:.4f} ms, {LARGE_BATCH * 1000.0 / ms:.2f} seq/s "
          f"(median of {TIMING_REPS}, uint8 on the card -> logits)", flush=True)
    del model
    torch.cuda.empty_cache()
    return launches


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


def _make_trainer(track: str, seed: int, lr: float = 1e-3, cfg=None):
    """Full-width ViT-B16 (or the classifier ``cfg``) through the port's
    entry points; no device is named anywhere, so parameters, optimizer
    state and batches are on the card. AdamW at ``lr``, weight decay 0.05,
    BF16 policy."""
    from metatransformer_tpu_torch.core import encoder as enc
    from metatransformer_tpu_torch.models import image_classifier as ic
    from metatransformer_tpu_torch.train import optim, step as step_lib
    from metatransformer_tpu_torch.train.trainer import Trainer, TrainerConfig

    cfg = cfg or ic.ImageClassifierConfig()
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
    from metatransformer_tpu_torch.core.tree import leaves_with_path

    return max(leaves_with_path(tree), key=lambda kv: kv[1].numel())


def _train_tracks(what, make_trainer, batch, steps, per_step, weight_grads, lrs,
                  make_generator=lambda: None, fall_every_step: bool = True,
                  update_bounds=(UPDATE_MIN_FRACTION, UPDATE_REL_L2),
                  tracks=("frozen", "full"), compare_steps: int = COMPARE_STEPS) -> dict:
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
    relative L2 distance from the plain run's. ``tracks`` and
    ``compare_steps`` (at most ``steps``; with one step no fall is asked)
    narrow the check. Returns the launches of each track."""
    min_fraction, max_rel_l2 = update_bounds
    from metatransformer_tpu_torch import ops
    from metatransformer_tpu_torch.ops import fused_block as fb

    size = len(batch["label"])
    launches = {}
    for track in tracks:
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
            if step == compare_steps - 1:
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
            for step in range(compare_steps):
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
        print(f"{what} {track} vs plain versions, {compare_steps} step(s): |loss diff| "
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


def phase_large_train(seed: int, dev) -> dict:
    """One full-track AdamW step of the whole ViT-L14 classifier (24 blocks
    of 1024, patch 14, T = 257) at b = LARGE_BATCH through ``Trainer``: 24
    launches of each fused kernel, and the loss, the largest leaf's first
    gradient and its update held against the same step with the plain
    versions on the card at the image bounds."""
    depth = _large_cfg().encoder.depth
    batch = {k: v[:LARGE_BATCH] for k, v in _train_batch().items()}
    return _train_tracks(
        "L14 train", lambda track, lr: _make_trainer(track, seed, lr, _large_cfg())[0], batch,
        1, {k: depth for k in FUSED_KERNELS}, {"full": 4 * depth}, CHECK_LR,
        tracks=("full",), compare_steps=1)["full"]


# --------------------------------------------------------------------------
# Times and bounds
# --------------------------------------------------------------------------


def _loop_ms(fn, launches: int = TIMING_REPS, loops: int = 5) -> float:
    """Time of one call of ``fn`` in a stream of calls: CUDA events around a
    loop of ``launches`` calls on inputs made before it, over the count; the
    median of ``loops`` such loops after a warm-up. The kernel rows' time: a
    launch's host work overlaps the device work of the launch before it."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(loops):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def _median_ms(fn, reps: int = TIMING_REPS) -> float:
    """Median of ``reps`` CUDA-event timings of one call each: the step and
    forward times, and beside each kernel row the earlier single-call
    figure, whose event pair also holds the wrapper's host work."""
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


def _library_attn(x, lns, lnb, wqkv, bqkv, wproj, bproj, heads: int = HEADS):
    """The attention sublayer as a composition of PyTorch's own bf16 calls.
    A yardstick only: nothing in the port calls it."""
    b, t, d = x.shape
    xn = F.layer_norm(x, (d,), lns.to(x.dtype), lnb.to(x.dtype), LN_EPS)
    q, k, v = F.linear(xn, wqkv.t(), bqkv).reshape(
        b, t, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
    o = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(b, t, d)
    return x + F.linear(o, wproj.t(), bproj)


def _library_mlp(x, lns, lnb, w1, b1, w2, b2):
    xn = F.layer_norm(x, (x.shape[-1],), lns.to(x.dtype), lnb.to(x.dtype), LN_EPS)
    return x + F.linear(F.gelu(F.linear(xn, w1.t(), b1)), w2.t(), b2)


def _bounds(b: int, t: int = T, d: int = D, mlp: int = MLP) -> dict:
    """The least time the card could take for each kernel's work at batch b
    (T tokens, width d): the larger of operations / peak bf16 rate and
    bytes / peak memory rate, each input read once and each output written
    once."""
    m, D, MLP = b * t, d, mlp
    attn_products = 2 * b * t * t * D  # one [T, T, hd] product, all heads
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


def _fused_kernel_times(kind, b, seed, dev, t=T, d=D, heads=HEADS, mlp=MLP,
                        plain_too=True) -> dict:
    """One fused kernel at batch b: its time by the launch loop and by the
    single-call median, its plain version, the library composition of the
    same function (by the launch loop) and the bound."""
    kernel, plain = _pair(kind, heads)
    if kind == "attn_sublayer_bwd":
        args = _bwd_inputs(b, seed, dev, t, d)
        x, g, lns, lnb, wqkv, bqkv, wproj = args
        leaves = [a.clone().requires_grad_(True)
                  for a in (x, lns, lnb, wqkv, bqkv, wproj, torch.zeros_like(lnb).bfloat16())]
        out = _library_attn(*leaves, heads=heads)  # untimed forward; its graph is kept
        library = lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)
    else:
        args = _sublayer_inputs(kind, b, seed, dev, t, d, mlp)
        composition = (lambda *a: _library_attn(*a, heads=heads)) if kind == "attn_sublayer" \
            else _library_mlp
        library = lambda: composition(*args)
    with torch.no_grad():
        ms, single = _loop_ms(lambda: kernel(args)), _median_ms(lambda: kernel(args))
        plain_ms = _median_ms(lambda: plain(args)) if plain_too else None
    with torch.set_grad_enabled(kind == "attn_sublayer_bwd"):
        lib_ms = _loop_ms(library)
    bound = _bounds(b, t, d, mlp)[kind]
    return {"ms": ms, "ms_single_call": single, "plain_ms": plain_ms,
            "library_composition_ms": lib_ms, **bound}


def _attn_core_times(b: int, seed: int, dev, t: int = T, d: int = D,
                     heads: int = HEADS) -> dict:
    """The attention core of kernel #1 alone (``mt_attn_core``, dense) by the
    launch loop, and its bound: S and P.V once each (the kernel runs S
    twice) over the QKV slab in and the output out."""
    from metatransformer_tpu_torch.ops import _build

    lib = _build.library()
    qkv = torch.randn(b, t, 3 * d, generator=torch.Generator().manual_seed(seed)).to(
        dev, torch.bfloat16)
    o = torch.empty(b, t, d, device=dev, dtype=torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream
    launch = lambda: lib.mt_attn_core(qkv.data_ptr(), None, o.data_ptr(), b, t, d, heads,
                                      stream)
    if launch() != 0:
        raise AssertionError("mt_attn_core did not launch")
    ops, nbytes = 4 * b * t * t * d, 2 * 4 * b * t * d
    t_ops, t_bytes = ops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"ms": _loop_ms(launch), "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "gflop": ops / 1e9, "mbytes": nbytes / 1e6}


def phase_times(model, seed: int, dev) -> dict:
    times = {}
    b = 128
    row = _attn_core_times(b, seed, dev)
    print(f"attention core of attn_sublayer b={b}: {row['ms']:.4f} ms by a loop of "
          f"{TIMING_REPS} launches, bound {row['bound_ms']:.4f} ms by {row['bound_by']} "
          f"({row['gflop']:.2f} GFLOP, {row['mbytes']:.1f} MB; "
          f"{100 * row['bound_ms'] / row['ms']:.1f}% of the bound's rate)", flush=True)
    for kind in FUSED_KERNELS:
        row = _fused_kernel_times(kind, b, seed, dev)
        times[kind] = {k: row[k] for k in ("ms", "ms_single_call", "plain_ms",
                                           "library_composition_ms", "bound_ms", "bound_by")}
        what = ("backward of the composition (dx and 6 parameter gradients)"
                if kind == "attn_sublayer_bwd" else "composition")
        print(f"{kind} b={b}: kernel {row['ms']:.4f} ms by a loop of {TIMING_REPS} launches "
              f"(one timed call: {row['ms_single_call']:.4f} ms), plain {row['plain_ms']:.4f} "
              f"ms, library {what} (layer_norm, linear, scaled_dot_product_attention, gelu in "
              f"bf16; no single PyTorch call computes the sublayer) "
              f"{row['library_composition_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms by "
              f"{row['bound_by']} ({row['gflop']:.2f} GFLOP, {row['mbytes']:.1f} MB; "
              f"{100 * row['bound_ms'] / row['ms']:.1f}% of the bound's rate)", flush=True)
    # ViT-L14's widths: the backward kernel at its bound
    row = _fused_kernel_times("attn_sublayer_bwd", LARGE_BATCH, seed, dev, LARGE_T, LARGE_D,
                              LARGE_HEADS, LARGE_MLP)
    print(f"L14 attn_sublayer_bwd b={LARGE_BATCH} T={LARGE_T} D={LARGE_D} H={LARGE_HEADS}: "
          f"kernel {row['ms']:.4f} ms by a loop of {TIMING_REPS} launches (one timed call: "
          f"{row['ms_single_call']:.4f} ms), plain {row['plain_ms']:.4f} ms, library backward "
          f"of the composition {row['library_composition_ms']:.4f} ms, bound "
          f"{row['bound_ms']:.4f} ms by {row['bound_by']} ({row['gflop']:.2f} GFLOP, "
          f"{row['mbytes']:.1f} MB; {100 * row['bound_ms'] / row['ms']:.1f}% of the bound's rate)",
          flush=True)
    g = torch.Generator().manual_seed(seed + 2)
    with torch.no_grad():
        for b in (128, 1):
            images = torch.randint(0, 256, (b, 224, 224, 3), generator=g,
                                   dtype=torch.uint8).to(dev)
            ms = _median_ms(lambda: model(images))
            print(f"forward b={b}: {ms:.4f} ms, {b * 1000.0 / ms:.2f} seq/s "
                  f"(median of {TIMING_REPS}, uint8 on the card -> logits)", flush=True)
    return times


def _time_step(label, trainer, batch, unit, generator=None, profile_as=None, size=None,
               top: int = 28, reps: int = TIMING_REPS) -> float:
    """Time one optimizer step of ``trainer`` on ``batch`` (moved to the card
    once), with its peak memory, and return the ms (median of ``reps``);
    ``profile_as`` also prints its device time by kernel under that name
    (the ``top`` kernels). ``size``: the batch's samples, where its input is
    not one tensor."""
    on_card = trainer._to_device(batch)
    size = size or len(on_card["input"])
    step = lambda: trainer._step(trainer.trainable, trainer.frozen, on_card, generator)
    torch.cuda.reset_peak_memory_stats()
    ms = _median_ms(step, reps)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"{label} b={size}: {ms:.4f} ms, {size * 1000.0 / ms:.2f} {unit}/s, peak memory "
          f"{peak:.3f} GiB (median of {reps} optimizer steps, batch on the card)",
          flush=True)
    if profile_as:
        _profile_step(step, profile_as, top=top)
    return ms


def phase_train_times(seed: int, dev, profile: bool):
    batch = _train_batch()
    for track in ("frozen", "full"):
        trainer, _ = _make_trainer(track, seed)
        _time_step(f"train step {track}", trainer, batch, "seq",
                   profile_as="full-track step" if profile and track == "full" else None)
        del trainer
        torch.cuda.empty_cache()


def _profile_step(step, what: str = "full-track step", steps: int = 3, top: int = 28):
    """Device time by kernel over a few runs of ``step`` (torch.profiler),
    the ``top`` kernels by time; returns the device busy us a run."""
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
          f"device busy {busy:.1f} us/step, idle share {100 * (1 - busy / wall_us):.2f}%, "
          f"{sum(r[2] for r in rows):.1f} device operations/step", flush=True)
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:top]:
        print(f"  {us:10.1f} us  {100 * us / busy:6.2f}%  x{count:6.1f}  {key[:110]}",
              flush=True)
    return busy


# --------------------------------------------------------------------------
# Long sequences and video: the flash-attention kernels and the paths on them
# --------------------------------------------------------------------------

BF, F32 = torch.bfloat16, torch.float32
EMPTY = "empty"  # ragged, and sample 1 has no kept key
FLASH_CASES = [  # b, h, t, head_dim, dtype, mask: False (dense), True (ragged) or EMPTY
    (1, 12, VT, 64, BF, False), (1, 12, VT, 64, BF, True),
    (8, 12, VT, 64, BF, False), (8, 12, VT, 64, BF, True), (3, 12, VT, 64, BF, EMPTY),
    (2, 4, 512, 32, BF, True), (2, 4, 577, 32, BF, False),
    (2, 2, 512, 128, BF, False), (2, 2, 577, 128, BF, True),
    # the segmenter's requests: T = 8 * 64 + 1, the last tile holds one row
    (1, 12, SEG_T, 64, BF, False), (8, 12, SEG_T, 64, BF, False),
    (8, 12, SEG_T, 64, BF, True), (2, 4, SEG_T, 32, BF, True), (2, 4, SEG_T, 128, BF, True),
    # the bf16 backward's 128-row blocks and 64-row streamed tiles
    (2, 4, 127, 64, BF, False), (2, 4, 127, 64, BF, True),
    (2, 4, 128, 64, BF, False), (2, 4, 128, 64, BF, True),
    (2, 4, 129, 64, BF, False), (2, 4, 129, 64, BF, True),
    (2, 4, 257, 64, BF, False), (2, 4, 257, 64, BF, True),
    (4, 6, VT, 64, F32, False), (1, 12, VT, 64, F32, True),
    (2, 4, 577, 32, F32, True), (2, 2, 577, 128, F32, True),
    # Data2Seq's long sequences: audio's 1212 tokens, the fused trio's 2876
    # (the last key tile holds 60 rows; bf16 and the fp32 route), the 1600
    # and 3072 buckets ragged
    (8, 12, 1212, 64, BF, False), (8, 12, 2876, 64, BF, False), (8, 12, 2876, 64, F32, False),
    (4, 12, 1600, 64, BF, True), (4, 12, 3072, 64, BF, True),
    # the ViT-Adapter's 32 x 32 grid at b = 2, TTA's 24 x 24 and 40 x 40
    (2, 12, 1024, 64, BF, False), (1, 12, 576, 64, BF, False), (1, 12, 1600, 64, BF, False),
    # the detectors' 64 x 64 grid at 1024^2
    (1, 12, 4096, 64, BF, False), (2, 12, 4096, 64, BF, False),
]


def _flash_inputs(b, h, t, d, dtype, ragged, seed, dev):
    """Seeded unit-normal q, k, v as strided views of one [B, T, 3, H, d]
    tensor (the layout the encoder hands over), a cotangent, and the key
    bias of a ragged keep-mask (sample i loses its last (i+1) t / (2b+2)
    keys; with ``EMPTY`` sample 1 loses them all) or None."""
    from metatransformer_tpu_torch.ops import flash_attention as fa

    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(b, t, 3, h, d, generator=g).to(dev, dtype)
    do = torch.randn(b, t, h, d, generator=g).to(dev, dtype)
    bias = None
    if ragged:
        keep = torch.ones(b, t, dtype=torch.bool, device=dev)
        for i in range(b):
            keep[i, t - (i + 1) * t // (2 * b + 2):] = False
        if ragged == EMPTY:
            keep[1] = False
        bias = torch.where(keep, 0.0, fa.NEG_INF).float()
    return (*qkv.unbind(2), bias, do)


def phase_flash_kernels(seed: int, dev, cases=FLASH_CASES) -> dict:
    """Kernels #4-#6 vs their plain versions in fp32 from the same inputs,
    at each of ``cases``; lse held too; both backward kernels bit-equal on a
    second launch. A sample with no kept key is held to be finite only: the
    reference pads T and spreads its uniform p over the padded keys too.
    Returns the worst absolute error of each kernel."""
    from metatransformer_tpu_torch.ops import flash_attention as fa

    worst = {k: 0.0 for k in FLASH_KERNELS}
    f = lambda x: x.float()
    for b, h, t, d, dtype, ragged in cases:
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
        mask_name = {False: "dense", True: "ragged", EMPTY: "ragged, sample 1 empty"}[ragged]
        tag = f"b={b} h={h} T={t} d={d} {str(dtype).split('.')[-1]} {mask_name}"
        for name, a, a2 in (("dq", dq, dq2), ("dk", dk, dk2), ("dv", dv, dv2)):
            if not torch.equal(a, a2):
                raise AssertionError(f"flash {tag}: {name} does not repeat bit for bit")
        for name, a in (("o", o), ("lse", lse), ("dq", dq), ("dk", dk), ("dv", dv)):
            if not torch.isfinite(a).all():
                raise AssertionError(f"flash {tag}: {name} is not finite")
        live = [i for i in range(b) if ragged != EMPTY or i != 1]  # samples with a kept key
        lse, want_lse = lse[live], want_lse[live]
        o, dq, dk, dv = o[live], dq[live], dk[live], dv[live]
        want_o, want_dq, want_dk, want_dv = (
            want_o[live], want_dq[live], want_dk[live], want_dv[live])
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


def _make_video_trainer(track: str, seed: int, lr: float = 1e-3, remat: bool = False):
    """Full-width video classifier through the port's entry points (no
    device named): AdamW at ``lr``, weight decay 0.05, BF16 policy;
    ``remat`` recomputes each encoder block in the backward."""

    from metatransformer_tpu_torch.core import encoder as enc
    from metatransformer_tpu_torch.models import video_classifier as vc
    from metatransformer_tpu_torch.train import optim, step as step_lib
    from metatransformer_tpu_torch.train.trainer import Trainer, TrainerConfig

    cfg = _video_cfg()
    cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, remat=remat))
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


def phase_video_remat(seed: int, dev):
    """One full-track video step at b = 8 with ``remat=True`` and one with
    ``remat="save"``, each against one with ``remat=False`` from the same
    weights and batch. Under remat each block runs its forward again in the
    backward (24 forward-kernel launches a step, not 12), and the backward
    kernels read the recomputed lse; "save" keeps the block's intermediates
    and leaves the flash path (T = 1568) as it is, 12 launches of each. The
    losses and the largest leaf's gradient are held within BWD_REL_TOL of
    the run without remat (relative to the larger value); the peak memories
    are printed. Returns the launches of the remat=True and "save" steps."""
    from metatransformer_tpu_torch import ops

    depth, batch, runs = _video_cfg().encoder.depth, _video_batch(), {}
    for remat in (False, True, "save"):
        trainer = _make_video_trainer("full", seed, VIDEO_CHECK_LR["full"], remat=remat)
        path, leaf = _largest_leaf(trainer.trainable)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        loss = trainer.train_epoch([batch])["loss"]
        torch.cuda.synchronize()
        runs[remat] = (loss, leaf.grad.detach().clone(), ops.launch_counts(),
                       torch.cuda.max_memory_allocated() / 2**30)
        del trainer, leaf
        torch.cuda.empty_cache()
    loss0, grad0, counts0, peak0 = runs[False]
    expected = {True: {"flash_fwd": 2 * depth, "flash_bwd_dq": depth, "flash_bwd_dkv": depth},
                "save": {k: depth for k in FLASH_KERNELS}}
    for remat, want in expected.items():
        loss1, grad1, counts1, peak1 = runs[remat]
        if {k: v for k, v in counts1.items() if v} != want:
            raise AssertionError(f"video remat={remat!r} step: launches {counts1}, expected {want}")
        loss_rel = abs(loss1 - loss0) / abs(loss0)
        grad_rel = ((grad1 - grad0).abs().max() / grad0.abs().max()).item()
        print(f"video remat: one full-track step at batch {VIDEO_TRAIN_BATCH}, remat={remat!r} "
              f"vs False: losses {loss1:.6f} / {loss0:.6f} (relative diff {loss_rel:.3g}), "
              f"first gradient of {'/'.join(path)} relative max diff {grad_rel:.3g} (tol "
              f"{BWD_REL_TOL}); launches {counts1} vs {counts0}; peak memory {peak1:.3f} GiB "
              f"with remat={remat!r}, {peak0:.3f} GiB without", flush=True)
        if not (loss_rel <= BWD_REL_TOL and grad_rel <= BWD_REL_TOL):
            raise AssertionError(f"video remat={remat!r} step differs from the step without remat")
    return runs[True][2], runs["save"][2]


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
    (timed here, used nowhere in the port), beside which stands the port's
    whole backward (``_backward``: delta and both kernels). Also the b = 1
    serving shape, the fp32 route at the video-MAE decoder's shape and the
    detectors' b = 2 at T = 4096 (with scaled_dot_product_attention's time
    beside #4)."""
    from metatransformer_tpu_torch.ops import flash_attention as fa

    times = {}
    for b, h, dtype, t in ((VIDEO_TRAIN_BATCH, HEADS, BF, VT), (1, HEADS, BF, VT),
                           (MAE_BATCH, 6, F32, VT), (2, HEADS, BF, DET_T)):
        q, k, v, _, do = _flash_inputs(b, h, t, HD, dtype, False, seed, dev)
        scale = float(HD) ** -0.5
        with torch.no_grad():
            o, lse = fa.flash_fwd_cuda(q, k, v, None, scale)
            delta = fa._delta(o, do)
            bwd = (q, k, v, None, do, lse, delta, scale)
            calls = {
                "flash_fwd": lambda: fa.flash_fwd_cuda(q, k, v, None, scale),
                "flash_bwd_dq": lambda: fa.flash_bwd_dq_cuda(*bwd),
                "flash_bwd_dkv": lambda: fa.flash_bwd_dkv_cuda(*bwd),
            }
            ms = {name: _loop_ms(fn) for name, fn in calls.items()}
            single = {name: _median_ms(fn) for name, fn in calls.items()}
        bounds = _flash_bounds(b, h, t, HD, q.element_size(), False)
        kind = str(dtype).split(".")[-1]
        if (b, dtype, t) != (VIDEO_TRAIN_BATCH, BF, VT):
            if t == DET_T:
                with torch.no_grad():
                    lq, lk, lv = (a.transpose(1, 2) for a in (q, k, v))
                    lib = _loop_ms(lambda: F.scaled_dot_product_attention(lq, lk, lv))
                    plain = _median_ms(lambda: fa.flash_attention_plain(
                        q.float(), k.float(), v.float(), None, scale), 5)
                print(f"flash_fwd b={b} h={h} T={t} d={HD} {kind}: plain version {plain:.4f} ms "
                      f"(median of 5), library scaled_dot_product_attention {lib:.4f} ms",
                      flush=True)
            for name in FLASH_KERNELS:
                bound = bounds[name]
                print(f"{name} b={b} h={h} T={t} d={HD} {kind}: kernel {ms[name]:.4f} ms by a "
                      f"loop of {TIMING_REPS} launches (one timed call: {single[name]:.4f} ms), "
                      f"bound "
                      f"{bound['bound_ms']:.4f} ms by {bound['bound_by']} at the {kind} peak "
                      f"({bound['gflop']:.2f} GFLOP, {bound['mbytes']:.1f} MB; "
                      f"{bound['gflop'] / ms[name]:.2f} TFLOP/s)", flush=True)
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
            lib_fwd = _loop_ms(lambda: F.scaled_dot_product_attention(lq, lk, lv))
        leaves = [a.detach().clone().requires_grad_(True) for a in (lq, lk, lv)]
        out = F.scaled_dot_product_attention(*leaves)  # untimed forward; its graph is kept
        g = do.transpose(1, 2)
        lib_bwd = _loop_ms(lambda: torch.autograd.grad(out, leaves, g, retain_graph=True))
        del out, leaves
        with torch.no_grad():
            port_bwd = _loop_ms(lambda: fa._backward(q, k, v, None, o, lse, do, scale))
        library = {"flash_fwd": lib_fwd, "flash_bwd_dq": lib_bwd, "flash_bwd_dkv": lib_bwd}
        for name in FLASH_KERNELS:
            bound = bounds[name]
            times[name] = {"ms": ms[name], "ms_single_call": single[name],
                           "plain_ms": plain_ms[name], "library_ms": library[name],
                           **{k: bound[k] for k in ("bound_ms", "bound_by")}}
            if name != "flash_fwd":  # what the library's number covers, on the port
                times[name]["port_backward_ms"] = port_bwd
            what = ("scaled_dot_product_attention" if name == "flash_fwd" else
                    "autograd's backward through scaled_dot_product_attention (dq, dk and dv "
                    "together: one time for both backward kernels)")
            print(f"{name} b={b} h={h} T={VT} d={HD} {kind}: kernel {ms[name]:.4f} ms by a loop "
                  f"of {TIMING_REPS} launches (one timed call: {single[name]:.4f} ms), plain "
                  f"{plain_ms[name]:.4f} ms, library {what} {library[name]:.4f} ms, bound "
                  f"{bound['bound_ms']:.4f} ms by {bound['bound_by']} ({bound['gflop']:.2f} "
                  f"GFLOP, {bound['mbytes']:.1f} MB; {100 * bound['bound_ms'] / ms[name]:.1f}% "
                  f"of the bound's rate, {bound['gflop'] / ms[name]:.2f} TFLOP/s)", flush=True)
        print(f"flash backward b={b} h={h} T={VT} d={HD} {kind}: the port's whole backward "
              f"(delta as a torch reduction, then dq and dk/dv) {port_bwd:.4f} ms, library "
              f"{lib_bwd:.4f} ms (loops of {TIMING_REPS})", flush=True)
        grid = -(-VT // 128) * h
        print(f"grid: {grid} blocks a sample of 128 rows x {h} heads (bf16 forward and "
              f"backward); at b=1 that is {grid / 132:.2f} blocks for each of the card's 132 SMs",
              flush=True)
    torch.cuda.empty_cache()
    return times


def phase_bwd_times(seed: int, dev) -> dict:
    """The flash backward at the video training shape (b = 8, 12 heads,
    T = 1568, head_dim 64, bf16, dense): #5, #6 and the whole backward,
    then one optimizer step of each video track at batch 8. Only the port's
    entry points that every slice since the video one has, so the same
    script times an older checkout of the package (``--bwd-times``)."""
    from metatransformer_tpu_torch.ops import flash_attention as fa

    q, k, v, _, do = _flash_inputs(VIDEO_TRAIN_BATCH, HEADS, VT, HD, BF, False, seed, dev)
    scale = float(HD) ** -0.5
    with torch.no_grad():
        o, lse = fa.flash_fwd_cuda(q, k, v, None, scale)
        bwd = (q, k, v, None, do, lse, fa._delta(o, do), scale)
        out = {"flash_bwd_dq": _median_ms(lambda: fa.flash_bwd_dq_cuda(*bwd)),
               "flash_bwd_dkv": _median_ms(lambda: fa.flash_bwd_dkv_cuda(*bwd)),
               "backward": _median_ms(lambda: fa._backward(q, k, v, None, o, lse, do, scale))}
    del q, k, v, do, o, lse, bwd
    torch.cuda.empty_cache()
    batch = _video_batch()
    for track in ("frozen", "full"):
        trainer = _make_video_trainer(track, seed)
        on_card = trainer._to_device(batch)
        out[f"video_step_{track}"] = _median_ms(
            lambda: trainer._step(trainer.trainable, trainer.frozen, on_card, None))
        del trainer, on_card
        torch.cuda.empty_cache()
    print("bwd times (ms, median of %d): %s" % (TIMING_REPS, json.dumps(out)), flush=True)
    return out


def phase_kernel_times(seed: int, dev, profile: bool = False) -> dict:
    """Kernels #1, #2 and #3 (b = 128, T = 197) and #4 (b = 8, 12 heads,
    T = 1568, head_dim 64, bf16, dense) by the launch loop, each beside its
    library yardstick (the composition; its backward; scaled_dot_product_
    attention), then the forwards and steps they carry: the image forward at
    b = 128, the point forward at b = 64, the segmenter forward at b = 8,
    kernel #7 at every case of FPS_CASES, one image step of each track at
    b = 128, the video forward at b = 8 and one video step of each track at
    b = 8. Only the port's entry points that every version since the point
    clouds have, so the same script times an older checkout of the package
    (``--kernel-times``); with ``profile``, also device time by kernel of
    the image forward at b = 128 and the full-track image step."""
    from metatransformer_tpu_torch.core import encoder as enc
    from metatransformer_tpu_torch.models import image_classifier as ic
    from metatransformer_tpu_torch.models import point_classifier as pc
    from metatransformer_tpu_torch.models import point_segmenter as ps
    from metatransformer_tpu_torch.models import video_classifier as vc
    from metatransformer_tpu_torch.ops import flash_attention as fa
    from metatransformer_tpu_torch.ops import point_ops as po

    out = {}
    for kind in ("attn_sublayer", "mlp_sublayer"):
        row = _fused_kernel_times(kind, TRAIN_BATCH, seed, dev, plain_too=False)
        out[kind] = row["ms"]
        out[f"{kind}_library"] = row["library_composition_ms"]
        torch.cuda.empty_cache()
    cfg = ic.ImageClassifierConfig()
    model = ic.ImageClassifier(cfg, ic.init(cfg, torch.Generator().manual_seed(seed)),
                               precision=enc.BF16)
    images = torch.randint(0, 256, (TRAIN_BATCH, 224, 224, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(seed + 2)).to(dev)
    with torch.no_grad():
        out["image_forward_b128"] = _median_ms(lambda: model(images))
        if profile:
            _profile_step(lambda: model(images), "image forward b=128")
    cfg = _point_cfg()
    model = pc.PointClassifier(cfg, pc.init(cfg, torch.Generator().manual_seed(seed)),
                               precision=enc.BF16)
    clouds = _clouds(seed + 7, POINT_SERVE_BATCHES[-1], POINT_N).to(dev)
    with torch.no_grad():
        out["point_forward_b64"] = _median_ms(lambda: model(clouds))
    del model, images, clouds
    seg_cfg = ps.PointSegmenterConfig()
    model = ps.PointSegmenter(seg_cfg, ps.init(seg_cfg, torch.Generator().manual_seed(seed)),
                              precision=enc.BF16)
    clouds = _clouds(seed + 7, SEG_SERVE_BATCHES[-1], SEG_N).to(dev)
    with torch.no_grad():
        out["segmenter_forward_b8"] = _median_ms(lambda: model(clouds))
    del model, clouds
    for b, n, g in FPS_CASES:  # kernel #7 at every case, its plan beside it
        pts = _clouds(seed, b, n).to(dev)
        with torch.no_grad():
            ms = _loop_ms(lambda: po.fps_cuda(pts, g))
        out[f"fps_B{b}_N{n}_G{g}"] = ms
        print(f"fps B={b} N={n} G={g}: {ms:.4f} ms, {1e3 * ms / (g - 1):.3f} us a round "
              f"({_fps_plan_text(n)})", flush=True)
    torch.cuda.empty_cache()
    q, k, v, _, _ = _flash_inputs(VIDEO_TRAIN_BATCH, HEADS, VT, HD, BF, False, seed, dev)
    scale = float(HD) ** -0.5
    with torch.no_grad():
        out["flash_fwd"] = _loop_ms(lambda: fa.flash_fwd_cuda(q, k, v, None, scale))
        lq, lk, lv = (a.transpose(1, 2) for a in (q, k, v))  # [B, H, T, d] views
        out["flash_fwd_library"] = _loop_ms(lambda: F.scaled_dot_product_attention(lq, lk, lv))
    del q, k, v, lq, lk, lv
    row = _fused_kernel_times("attn_sublayer_bwd", TRAIN_BATCH, seed, dev, plain_too=False)
    out["attn_sublayer_bwd"] = row["ms"]
    out["attn_sublayer_bwd_library"] = row["library_composition_ms"]
    torch.cuda.empty_cache()
    step = lambda t, batch, g=None: _median_ms(
        lambda: t._step(t.trainable, t.frozen, batch, g))
    for track in ("frozen", "full"):
        trainer, _ = _make_trainer(track, seed)
        on_card = trainer._to_device(_train_batch())
        out[f"image_step_{track}"] = step(trainer, on_card)
        if profile and track == "full":
            _profile_step(lambda: trainer._step(trainer.trainable, trainer.frozen, on_card, None),
                          "image full-track step")
        del trainer, on_card
        torch.cuda.empty_cache()
    cfg = _video_cfg()
    model = vc.VideoClassifier(cfg, vc.init(cfg, torch.Generator().manual_seed(seed)),
                               precision=enc.BF16)
    clips = torch.randint(0, 256, (VIDEO_TRAIN_BATCH, 16, 224, 224, 3),
                          generator=torch.Generator().manual_seed(seed + 2),
                          dtype=torch.uint8).to(dev)
    with torch.no_grad():
        out["video_forward_b8"] = _median_ms(lambda: model(clips))
    del model, clips
    torch.cuda.empty_cache()
    for track in ("frozen", "full"):
        trainer = _make_video_trainer(track, seed)
        out[f"video_step_{track}"] = step(trainer, trainer._to_device(_video_batch()))
        del trainer
        torch.cuda.empty_cache()
    print(f"kernel times (ms; kernels: loops of {TIMING_REPS} launches, steps and forward: "
          f"median of {TIMING_REPS}): {json.dumps(out)}", flush=True)
    return out


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


def _check_fps(tag: str, pts, g: int) -> int:
    """Kernel #7 on ``pts`` vs its plain version, index for index, with a
    second launch bit-equal; the number of differing indices (0, or it
    raises)."""
    from metatransformer_tpu_torch.ops import point_ops as po

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
    print(f"fps {tag} ({_fps_plan_text(pts.shape[1])}): {wrong} of {got.numel()} indices differ from the "
          f"plain version, bit-equal on a second launch, {got[0].unique().numel()} "
          f"distinct indices in cloud 0", flush=True)
    if wrong:
        raise AssertionError(f"fps {tag}: kernel disagrees with the plain version")
    return wrong


def phase_fps_kernel(seed: int, dev) -> float:
    """Kernel #7 vs its plain version, index for index (torch.equal), at
    the shapes of the point paths and past the shared-memory route; on a
    cloud whose points all appear four times with more samples than distinct
    points; through masked_fps with ragged masks on both routes; a second
    launch must repeat bit for bit. Returns the number of differing indices,
    counted over every case."""
    from metatransformer_tpu_torch.ops import point_ops as po

    wrong = 0
    for b, n, g in FPS_CASES:
        wrong += _check_fps(f"B={b} N={n} G={g}", _clouds(seed + n + g, b, n).to(dev), g)
    base = _clouds(seed + 1, 4, 256).to(dev)
    wrong += _check_fps("B=4 N=1024 G=300, 256 distinct points each four times",
                       torch.cat([base] * 4, 1), 300)
    # ties across the blocks of a cluster: every point has a copy in each block
    wrong += _check_fps("B=2 N=16384 G=80, 64 distinct points each 256 times",
                       _clouds(seed + 1, 2, 64).to(dev).repeat(1, 256, 1), 80)
    wrong += _check_fps("B=2 N=16384 G=20, one point 16384 times (every distance +0)",
                       _clouds(seed + 1, 2, 1).to(dev).expand(2, 16384, 3), 20)
    for n in (1024, 16384, 65537):  # masked_fps, ragged: sample i keeps its first n (i+1) / (b+1) points
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


def _fps_plan_text(n: int) -> str:
    """The FPS kernel's launch plan for n points, as a phrase; "plan not
    known" for a checkout whose wrapper has no plan."""
    from metatransformer_tpu_torch.ops import point_ops as po

    if not hasattr(po, "_fps_plan"):
        return "plan not known"
    plan = po._fps_plan(n)
    return (f"{plan.route} route, {max(plan.cluster, 1)} block(s) a cloud of {plan.threads} "
            f"threads" + (f", {plan.ppt} points a thread" if plan.ppt else ""))


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
            ms = _loop_ms(lambda: po.fps_cuda(pts, g))
            single = _median_ms(lambda: po.fps_cuda(pts, g))
            plain_ms = _median_ms(lambda: po.furthest_point_sample_plain(pts, g),
                                  reps=20 if g <= 512 else 3)
        bound = _fps_bound(b, n, g)
        print(f"fps B={b} N={n} G={g}: kernel {ms:.4f} ms by a loop of {TIMING_REPS} launches "
              f"(one timed call: {single:.4f} ms; {1e3 * ms / (g - 1):.3f} us a "
              f"round; {_fps_plan_text(n)}), plain {plain_ms:.4f} "
              f"ms, library none, bound {bound['bound_ms']:.6f} ms by {bound['bound_by']} "
              f"({bound['gflop']:.4f} GFLOP fp32, {bound['mbytes']:.3f} MB; "
              f"{100 * bound['bound_ms'] / ms:.2f}% of the bound's rate) (plain: median of "
              f"{20 if g <= 512 else 3})", flush=True)
        if (b, n, g) == FPS_MAIN_CASE:
            times["fps"] = {"ms": ms, "ms_single_call": single, "plain_ms": plain_ms,
                            **{k: bound[k] for k in ("bound_ms", "bound_by")}}
    return times


def phase_fps_plans(seed: int, dev) -> dict:
    """Kernel #7 at every case of FPS_CASES under its launch plan and under
    plans with one knob of ``point_ops._fps_plan`` changed (the fewest
    points a thread in a cluster, the most threads a block,
    the largest cloud on one block, the points a block of a cluster aims
    at), also at 4096 and 8192 points: every plan's indices must equal the first plan's, and
    the time of each distinct plan is printed, to choose the knobs."""
    from contextlib import ExitStack

    from metatransformer_tpu_torch.ops import point_ops as po

    variants = ([{}] + [{"_FPS_CLUSTER_MIN_PPT": v} for v in (4, 16)]
                + [{"_FPS_THREADS": v} for v in (256, 1024)]
                + [{"_FPS_ONE_BLOCK": v} for v in (2048, 8192)]
                + [{"_FPS_CLUSTER_SHARE": v} for v in (512, 2048)])
    out = {}
    for b, n, g in FPS_CASES + [(8, 4096, 512), (8, 8192, 512)]:  # and both sides of _FPS_ONE_BLOCK
        pts = _clouds(seed, b, n).to(dev)
        with torch.no_grad():
            want = po.fps_cuda(pts, g)
        seen = set()
        for variant in variants:
            with ExitStack() as stack:
                for name, value in variant.items():
                    stack.enter_context(mock.patch.object(po, name, value))
                plan = po._fps_plan(n)
                if plan in seen:
                    continue
                seen.add(plan)
                with torch.no_grad():
                    got = po.fps_cuda(pts, g)
                    ms = _loop_ms(lambda: po.fps_cuda(pts, g))
            if not torch.equal(got, want):
                raise AssertionError(f"fps B={b} N={n} G={g}: plan {plan} changes the indices")
            out[f"B{b}_N{n}_G{g} {plan.route} C={plan.cluster} T={plan.threads} "
                f"ppt={plan.ppt}"] = ms
            print(f"fps B={b} N={n} G={g} {variant or 'the plan'}: {plan}: {ms:.4f} ms, "
                  f"{1e3 * ms / (g - 1):.3f} us a round", flush=True)
    return out


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


def _make_point_trainer(track: str, seed: int, lr: float = 1e-3, head_dropout=None):
    """Full-width point classifier through the port's entry points (no
    device named): AdamW at ``lr``, weight decay 0.05, BF16 policy, head
    dropout 0.5 as configured (or ``head_dropout``). The frozen track trains
    tokenizer, positional MLP, cls token and position, final LayerNorm and
    head."""
    from metatransformer_tpu_torch.core import encoder as enc
    from metatransformer_tpu_torch.models import point_classifier as pc
    from metatransformer_tpu_torch.train import optim, step as step_lib
    from metatransformer_tpu_torch.train.trainer import Trainer, TrainerConfig

    cfg = _point_cfg()
    if head_dropout is not None:
        cfg = dataclasses.replace(cfg, head_dropout=head_dropout)
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


class _PinnedRoutes:
    """The point classifier's piecewise-linear switches, taken as recorded:
    the conv stack's two max-pools over each group (``tokenizers.point.
    _pool``) and the pool over the tokens (``body.amax(dim=1)``) as an argmax
    and a gather, the head's two ReLUs (``torch.relu`` on [B, C]) as a mask.
    Under ``record()`` each keeps what its input chooses; under ``replay()``
    each takes the kept choice, in the order of one forward, again in every
    forward. A run recorded with the plain versions and replayed with the
    kernels routes every gradient through the same elements, so no switch
    flips on a rounding difference."""

    def __init__(self):
        self.kept, self.calls, self.mode = [], 0, None

    def _choice(self, choose, x):
        if self.mode == "record":
            self.kept.append(choose(x.detach()))
            return self.kept[-1]
        self.calls += 1
        return self.kept[(self.calls - 1) % len(self.kept)]

    def _patched(self, mode):
        from contextlib import ExitStack

        from metatransformer_tpu_torch.tokenizers import point as point_tok

        amax, relu = torch.Tensor.amax, torch.relu

        def pool(x, cfg):
            if cfg.reduction != "max":
                raise AssertionError(f"pinned pools need max reduction, got {cfg.reduction}")
            return x.gather(2, self._choice(lambda t: t.argmax(2, keepdim=True), x))

        def tensor_amax(t, dim=(), keepdim=False):
            if dim == 1 and not keepdim and t.dim() == 3:  # the pool over the tokens
                return t.gather(1, self._choice(lambda u: u.argmax(1, keepdim=True), t))[:, 0]
            return amax(t, dim, keepdim)

        def head_relu(x):
            if x.dim() != 2:  # the conv stack's ReLUs run before the kernels: no flips
                return relu(x)
            return torch.where(self._choice(lambda t: t > 0, x), x, 0.0)

        self.mode = mode
        stack = ExitStack()
        stack.enter_context(mock.patch.object(point_tok, "_pool", pool))
        stack.enter_context(mock.patch.object(torch.Tensor, "amax", tensor_amax))
        stack.enter_context(mock.patch.object(torch, "relu", head_relu))
        return stack

    def record(self):
        return self._patched("record")

    def replay(self):
        return self._patched("replay")


def phase_point_train_pinned(seed: int, dev) -> dict:
    """The point training check with what makes its runs part taken out:
    head dropout off, and the max-pools' argmax and the head's ReLU masks
    recorded from a plain-version step and replayed in both compared runs
    (``_PinnedRoutes``). For each
    track one AdamW step with the kernels against one with the plain
    versions from the same weights and batch: losses within LOSS_TOL, the
    largest leaf's first gradient within GRAD_STEP_REL_L2 and its update at
    the image bounds (UPDATE_MIN_FRACTION, UPDATE_REL_L2), as
    _train_tracks holds them. Returns the launches of each track."""
    depth = _point_cfg().encoder.depth
    batch = _point_batch(seed)
    make = lambda track, lr: _make_point_trainer(track, seed, lr, head_dropout=0.0)
    launches = {}
    for track in ("frozen", "full"):
        pins = _PinnedRoutes()
        with pins.record(), _plain_versions():
            make(track, POINT_CHECK_LR[track]).train_epoch([batch])
        with pins.replay():
            launches.update(_train_tracks(
                "point train, dropout off, pools and head ReLUs pinned", make, batch, 1,
                {"fps": 1, **{k: depth for k in FUSED_KERNELS}},
                {"frozen": 0, "full": 4 * depth}, POINT_CHECK_LR, tracks=(track,),
                compare_steps=1))
        if len(pins.kept) != 5 or pins.calls != 2 * len(pins.kept):
            raise AssertionError(f"pinned switches: {len(pins.kept)} recorded, {pins.calls} "
                                 f"replayed; expected 5 (3 pools, 2 ReLUs) and 10")
        torch.cuda.empty_cache()
    return launches


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


def phase_multiview_serve(seed: int, dev) -> dict:
    """One request of b = MULTIVIEW_BATCH float clouds of POINT_N points
    through the full-width multi-view point classifier (4 rendered views of
    224^2 a cloud, folded into the batch: 32 images through ViT-B16 at
    T = 197, BF16), no device named: 12 launches of each fused sublayer and
    no FPS; logits held against the same model run with the plain versions
    on the card at the serving tolerance."""
    from metatransformer_tpu_torch import ops
    from metatransformer_tpu_torch.core import encoder as enc
    from metatransformer_tpu_torch.models import point_multiview as mv

    cfg = mv.MultiViewConfig()
    params = mv.init(cfg, torch.Generator().manual_seed(seed))  # lands on the card
    if params["head"]["w0"].device.type != "cuda":
        raise AssertionError("the multi-view model did not land on the card")
    clouds = _clouds(seed + 11, MULTIVIEW_BATCH, POINT_N).to(dev)
    ops.reset_launch_counts()
    with torch.no_grad():
        logits = mv.forward(params, clouds, cfg, precision=enc.BF16)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        with _plain_versions():
            ref = mv.forward(params, clouds, cfg, precision=enc.BF16)
        ms = _median_ms(lambda: mv.forward(params, clouds, cfg, precision=enc.BF16))
    depth = cfg.encoder.depth
    _check_launches_per_request([launches], {"attn_sublayer": depth, "mlp_sublayer": depth},
                                "multi-view serve")
    if logits.shape != (MULTIVIEW_BATCH, cfg.num_classes) or not torch.isfinite(logits).all():
        raise AssertionError(f"multi-view: logits {tuple(logits.shape)}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    err = (logits - ref).abs().max().item()
    top1 = (logits.argmax(-1) == ref.argmax(-1)).float().mean().item()
    print(f"multi-view point classifier b={MULTIVIEW_BATCH} N={POINT_N} ({cfg.num_views} views, "
          f"{MULTIVIEW_BATCH * cfg.num_views} images of {cfg.proj.img_size}^2): logits {tuple(logits.shape)}, max "
          f"|kernel - plain| {err:.6g}, top-1 agreement {top1:.4f}; launches {launches}; forward "
          f"{ms:.4f} ms (median of {TIMING_REPS})", flush=True)
    torch.testing.assert_close(logits, ref, atol=LOGIT_ATOL, rtol=LOGIT_RTOL)
    del params
    torch.cuda.empty_cache()
    return launches


def phase_native_host(seed: int) -> None:
    """The C++ host runtime (runtime/native.py), built with g++ on this
    machine, against its numpy twins at a size of the input pipeline: voxel
    grid subsampling of a 65,536-point cloud with 4 features at dl = 0.06,
    and 16 nearest neighbours of 2,048 queries in 8,192 support points; the
    bounds of tests/test_torch_point_multiview.py. Host times beside them."""
    from metatransformer_tpu_torch.runtime import native

    rng = np.random.default_rng(seed + 13)
    pts = rng.uniform(-1, 1, (65536, 3)).astype(np.float32)
    feats = rng.standard_normal((65536, 4)).astype(np.float32)
    t0 = time.perf_counter()
    native.library()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got_p, got_f = native.grid_subsample(pts, feats, dl=0.06)
    grid_ms = (time.perf_counter() - t0) * 1e3
    want_p, want_f = native.grid_subsample_plain(pts, feats, dl=0.06)
    if got_p.shape != want_p.shape:
        raise AssertionError(f"grid_subsample: {got_p.shape} voxels, plain {want_p.shape}")
    np.testing.assert_allclose(got_p, want_p, atol=1e-6)
    np.testing.assert_allclose(got_f, want_f, atol=1e-5)
    support = rng.uniform(-1, 1, (8192, 3)).astype(np.float32)
    queries = rng.uniform(-1, 1, (2048, 3)).astype(np.float32)
    t0 = time.perf_counter()
    idx, d2 = native.knn_search(support, queries, 16)
    knn_ms = (time.perf_counter() - t0) * 1e3
    pidx, pd2 = native.knn_search_plain(support, queries, 16)
    np.testing.assert_allclose(np.sort(d2, axis=1), pd2, rtol=1e-3, atol=1e-4)
    same = (np.sort(idx, axis=1) == np.sort(pidx, axis=1)).mean()
    print(f"native host runtime (g++ build {build_s:.2f} s): grid_subsample 65536 points -> "
          f"{len(got_p)} voxels in {grid_ms:.2f} ms, equal to the numpy version within 1e-6 / "
          f"1e-5; knn_search 2048 x 8192, k = 16 in {knn_ms:.2f} ms, distances within the "
          f"bound, {same:.5f} of the indices equal (near-ties aside, min 0.99)", flush=True)
    if same <= 0.99:
        raise AssertionError(f"knn_search: {same} of the indices equal the numpy version's")


def phase_host_copies(seed: int, dev) -> None:
    """Host-to-device copy time of a uint8 image batch of 128 (224^2 x 3)
    and of a float32 cloud batch of 64 x 1024 x 3, from pageable memory as
    the serving wrappers take them (``tensor.to(device)``) and from pinned
    memory: CUDA events around one copy, median of TIMING_REPS."""
    smi = _smi()
    images = torch.randint(0, 256, (128, 224, 224, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(seed))
    clouds = _clouds(seed, POINT_SERVE_BATCHES[-1], POINT_N)
    for what, host in (("uint8 images b=128", images), ("float32 clouds b=64", clouds)):
        for kind, src in (("pageable", host), ("pinned", host.pin_memory())):
            ms = _median_ms(lambda: src.to(dev, non_blocking=kind == "pinned"))
            on_card = src.to(dev)
            if not torch.equal(on_card.cpu(), host):
                raise AssertionError(f"host copy of {what} ({kind}) differs")
            nbytes = host.numel() * host.element_size()
            print(f"host-to-device copy, {what} ({nbytes / 1e6:.3f} MB, {kind}): {ms:.4f} ms, "
                  f"{nbytes / ms / 1e6:.2f} GB/s ({smi})", flush=True)


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
               {"input": _clouds(seed + 5, POINT_MAE_BATCH, POINT_N).numpy()}, "clouds", masks,
               "masked point ViT step" if profile else None)
    del trainer
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# Data2Seq, fuse-then-encode, buckets and the dense-input modalities
# --------------------------------------------------------------------------

# Each modality's batch, unpadded token count and bucket, with the raw
# schema of _modality_raw and the tokenizer configs of _modality_config:
# those of scripts/bench_modalities.py (copied: that script imports JAX).
# Graphs have ragged node and edge counts, so the tokenizer's keep-mask holds
# padded slots.
MODALITY_SPECS = {  # name: (batch, tokens, bucket)
    "text": (256, 1, 64), "tabular": (512, 14, 64), "graph": (64, 82, 128),
    "time-series": (256, 96, 128), "imu": (256, 256, 256), "hyper": (64, 201, 256),
    "image": (128, 196, 256), "x-ray": (128, 196, 256), "infrared": (128, 196, 256),
    "point": (64, 256, 256), "audio": (8, 1212, 1600), "video": (8, 1568, 1600),
}
MODALITY_REQUESTS, MODALITY_TIMING_REPS = 3, 10
# The README trio (video, audio, time series): one sample is 1568 + 1212 + 96
# = 2876 tokens; the audio arrives as a waveform of 400 + 1023 * 160 samples,
# 1024 fbank frames.
FUSE_BATCH, FUSE_T, FUSE_SAMPLES = 8, 2876, 164_080
BUCKET_BATCH = 4
# #1 under a keep-mask at the pipeline's shapes (b, T): the graph's own mask,
# its bucket, and the ragged buckets up to 256.
MODALITY_MASKED_SHAPES = [(64, 82), (64, 128)] + [(BUCKET_BATCH, t) for t in (64, 128, 256)]
# Batches of the modality models' forwards and of the CLIP text tower alone.
MODEL_BATCHES = {"audio": 8, "hyper": 64, "tabular": 512, "time-series": 32, "text": 256}
# The text tower (fp32) on the card vs the same tower in float64 there: the
# tolerance of the tower's CPU parity test (tests/test_torch_text.py). TF32
# products would miss it.
TEXT_TOL = 1e-4
FBANK_TOL = 1e-4  # log-mel on the card vs the numpy oracle (tests/test_torch_audio.py)


def _modality_config(name: str):
    """The tokenizer configs scripts/bench_modalities.py gives where the
    defaults carry no schema; None: the facade's default at width D."""
    from metatransformer_tpu_torch.tokenizers import hyper, image, point, tabular, time_series

    return {
        "tabular": lambda: tabular.TabularTokenizerConfig(vocab_sizes=(8,) * 14, dim=D),
        "time-series": lambda: time_series.TimeSeriesConfig(c_in=7, dim=D),
        "imu": lambda: time_series.TimeSeriesConfig(c_in=6, dim=D),
        "hyper": lambda: hyper.HyperTokenizerConfig(img_size=1, near_band=49, num_tokens=200,
                                                    dim=D),
        "infrared": lambda: image.ImageTokenizerConfig(in_channels=1, dim=D),
        # bf16 products in the conv stack, as the BF16 encoder it feeds
        "point": lambda: point.PointTokenizerConfig(precision="default"),
    }.get(name, lambda: None)()


def _modality_raw(name: str, seed: int, dev):
    """One raw request of ``name`` at its batch, made on the card."""
    b = MODALITY_SPECS[name][0]
    g = torch.Generator(device=dev).manual_seed(seed)
    randn = lambda *s: torch.randn(*s, generator=g, device=dev)
    ints = lambda hi, *s: torch.randint(0, hi, s, generator=g, device=dev)
    if name == "graph":
        return {"node_data": ints(16, b, 32, 9), "edge_data": ints(4, b, 48, 3),
                "edge_index": ints(32, b, 48, 2),
                "node_num": 24 + torch.arange(b, device=dev) % 9,
                "edge_num": 40 + torch.arange(b, device=dev) % 9,
                "lap_eigvec": randn(b, 32, 16)}
    return {
        "text": lambda: ints(48_999, b, 77) + 1, "tabular": lambda: ints(8, b, 14),
        "time-series": lambda: randn(b, 96, 7), "imu": lambda: randn(b, 256, 6),
        "hyper": lambda: randn(b, 200, 49), "image": lambda: randn(b, 224, 224, 3),
        "x-ray": lambda: randn(b, 224, 224, 3), "infrared": lambda: randn(b, 224, 224, 1),
        "point": lambda: randn(b, 1024, 3) * 0.5, "audio": lambda: randn(b, 1024, 128),
        "video": lambda: randn(b, 16, 224, 224, 3),
    }[name]()


def _expected_launches(t: int, depth: int, fps: bool = False) -> dict:
    """The launches one BF16 pass of ViT-B16 over ``t`` tokens makes: 12 of
    each fused sublayer up to 256 tokens (the reference's gate), 12 of the
    flash forward from 512; one FPS launch for a cloud."""
    from metatransformer_tpu_torch.core import encoder as enc

    impl = enc._resolve_impl(enc.BASE, t, enc.BF16)
    if impl == "fused":
        counts = {"attn_sublayer": depth, "mlp_sublayer": depth}
    elif impl == "flash":
        counts = {"flash_fwd": depth}
    else:
        raise AssertionError(f"T={t} resolves to {impl!r}, off every kernel")
    if fps:
        counts["fps"] = 1
    return counts


def _held(what: str, fn, requests, expected: dict, shape, keep=None, pins=None,
          tols=None) -> dict:
    """Answer each request with the kernels (launches of each held to
    ``expected``), then again with the plain versions on the card; outputs
    finite, of ``shape`` and within the serving tolerance (at the positions
    ``keep(request)`` names, where given). ``pins`` (a ``_Replayed``): the
    plain versions answer first under ``pins.record()`` and the kernels
    under ``pins.replay()``. Where ``shape`` is a dict, ``fn`` answers a dict
    of outputs, each held at its own shape and at ``tols[key]`` (atol,
    rtol) where given, an atol that is a function taking it from the plain
    run's output. Returns the run's launches."""
    import contextlib

    from metatransformer_tpu_torch import ops

    with torch.no_grad():
        if pins is not None:
            with _plain_versions(), pins.record():
                want = [fn(raw) for raw in requests]
        ops.reset_launch_counts()
        answers, per_request = [], []
        with pins.replay() if pins is not None else contextlib.nullcontext():
            for raw in requests:
                answers.append(fn(raw))
                per_request.append(ops.launch_counts())
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        if pins is None:
            with _plain_versions():
                want = [fn(raw) for raw in requests]
    _check_launches_per_request(per_request, expected, what)
    shapes = shape if isinstance(shape, dict) else {"": shape}
    errs, tops, bounds = {k: 0.0 for k in shapes}, {k: 0.0 for k in shapes}, {}
    for raw, answer, reference in zip(requests, answers, want):
        for key, want_shape in shapes.items():
            got, ref = (answer[key], reference[key]) if key else (answer, reference)
            if tuple(got.shape) != tuple(want_shape) or not torch.isfinite(got.float()).all():
                raise AssertionError(
                    f"{what} {key}: output {tuple(got.shape)} (expected {want_shape}), finite "
                    f"{bool(torch.isfinite(got.float()).all())}")
            if keep is not None:
                m = keep(raw)
                got, ref = got[m], ref[m]
            errs[key] = max(errs[key], (got.float() - ref.float()).abs().max().item())
            tops[key] = max(tops[key], ref.float().abs().max().item())
            atol, rtol = (tols or {}).get(key, (LOGIT_ATOL, LOGIT_RTOL))
            atol = atol(ref) if callable(atol) else atol
            bounds[key] = (round(max(bounds.get(key, (0.0,))[0], atol), 6), rtol)
            torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol,
                                       msg=lambda m, key=key: f"{what} {key}: {m}")
    held = "; ".join(
        f"{key + ' ' if key else ''}{tuple(shapes[key])} max |kernel - plain| {errs[key]:.6g} "
        f"(tol {bounds[key]}, max |plain| {tops[key]:.4g})" for key in shapes)
    print(f"{what}: {len(requests)} requests, output {held}, launches {launches}", flush=True)
    return launches


def phase_modalities(seed: int, dev, profile: bool = False) -> dict:
    """All 12 modalities of ``pipeline.MODALITIES`` through ``Data2Seq`` at
    ViT-B16 width (seeded weights; one shared encoder, cast once to BF16),
    each answering MODALITY_REQUESTS requests twice: unpadded (the tokens
    straight into the encoder, mean-pooled: T from 1 to 1568) and bucketed
    (``pad_to_bucket``, then ``encode_bucketed_pooled``; the graph with its
    tokenizer's own keep-mask). Pooled features held against the plain
    versions on the card; then each modality's seq/s, unpadded (with
    ``profile``: device time by kernel of the text and audio passes).
    Returns the launches of each pass by path name."""
    from metatransformer_tpu_torch import pipeline
    from metatransformer_tpu_torch.core import encoder as enc
    from metatransformer_tpu_torch.tokenizers import graph as graph_tok

    ecfg = enc.BASE
    enc_params = enc.cast_params(enc.init(ecfg, torch.Generator().manual_seed(seed)), enc.BF16)
    launches, rates = {}, {}
    for i, (name, (b, t, bucket)) in enumerate(MODALITY_SPECS.items()):
        facade = pipeline.Data2Seq(name, D, config=_modality_config(name))
        tok_params = facade.init(torch.Generator().manual_seed(seed + 1 + i))  # on the card
        requests = [_modality_raw(name, seed + 100 * i + r, dev) for r in range(MODALITY_REQUESTS)]

        def unpadded(raw):
            tokens = facade(tok_params, raw)
            if tuple(tokens.shape) != (b, t, D):
                raise AssertionError(f"{name}: tokens {tuple(tokens.shape)}, expected {(b, t, D)}")
            return enc.encode(enc_params, tokens, ecfg, precision=enc.BF16).float().mean(dim=1)

        def bucketed(raw):
            if name == "graph":
                tokens, keep = graph_tok.apply(tok_params, raw, facade.config)
            else:
                tokens, keep = facade(tok_params, raw), None
            tokens, keep = pipeline.pad_to_bucket(tokens, keep)
            if tokens.shape[1] != bucket:
                raise AssertionError(f"{name}: bucket {tokens.shape[1]}, expected {bucket}")
            return pipeline.encode_bucketed_pooled(enc_params, tokens, keep, ecfg, enc.BF16)

        fps = name == "point"
        launches[f"modalities_{name}"] = _held(
            f"modality {name} b={b} T={t} unpadded", unpadded, requests,
            _expected_launches(t, ecfg.depth, fps), (b, D))
        launches[f"bucketed_{name}"] = _held(
            f"modality {name} b={b} T={t} -> bucket {bucket}", bucketed, requests,
            _expected_launches(bucket, ecfg.depth, fps), (b, D))
        with torch.no_grad():
            ms = _median_ms(lambda: unpadded(requests[0]), MODALITY_TIMING_REPS)
        rates[name] = b * 1000.0 / ms
        if profile and name in ("text", "audio"):
            with torch.no_grad():
                _profile_step(lambda: unpadded(requests[0]), f"modality {name} b={b} unpadded")
        print(f"modality {name} b={b} T={t}: {ms:.4f} ms, {rates[name]:.2f} seq/s (median of "
              f"{MODALITY_TIMING_REPS}, raw on the card -> Data2Seq -> BF16 encoder -> "
              f"mean-pooled features)", flush=True)
        del requests, tok_params, facade
        torch.cuda.empty_cache()
    print(f"modality seq/s: {json.dumps(rates)}", flush=True)
    return launches


def phase_fuse(seed: int, dev, profile: bool = False) -> dict:
    """The README trio through ``multimodal_classifier.forward`` at
    b = FUSE_BATCH (uint8 clips of 16 x 224^2, waveforms whose fbank runs on
    the card, 96 x 7 series): 2876 fused tokens, 12 flash-forward launches,
    under BF16 (the bf16 kernel) and FP32 (the fp32 route), logits against
    the plain versions; then its times: BF16 at b = FUSE_BATCH and 1, FP32
    at b = FUSE_BATCH (with ``profile``: device time by kernel of the BF16
    runs). Returns the launches of each policy's run."""
    from metatransformer_tpu_torch.core import encoder as enc
    from metatransformer_tpu_torch.models import multimodal_classifier as mm
    from metatransformer_tpu_torch.ops import fbank

    cfg = mm.MultimodalClassifierConfig(tokenizers=(None, None, _modality_config("time-series")))
    toks = [f.config for f in cfg.facades().values()]
    if toks[0].num_patches + toks[1].num_patches + 96 != FUSE_T:
        raise AssertionError("the trio does not give 2876 tokens")
    params = mm.init(cfg, torch.Generator().manual_seed(seed))  # lands on the card
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    requests = [{
        "video": torch.randint(0, 256, (FUSE_BATCH, 16, 224, 224, 3), generator=g, device=dev,
                               dtype=torch.uint8),
        "audio": torch.randn(FUSE_BATCH, FUSE_SAMPLES, generator=g, device=dev) * 0.1,
        "time-series": torch.randn(FUSE_BATCH, 96, 7, generator=g, device=dev),
    }]

    def trio(precision):
        def run(raw):
            wave = raw["audio"] - raw["audio"].mean(dim=-1, keepdim=True)
            return mm.forward(params, {**raw, "audio": fbank.fbank(wave)}, cfg, precision)
        return run

    launches = {}
    for tag, precision in (("bf16", enc.BF16), ("fp32", enc.FP32)):
        launches[f"fuse_{tag}"] = _held(
            f"fused trio {tag} b={FUSE_BATCH} T={FUSE_T}", trio(precision), requests,
            {"flash_fwd": cfg.encoder.depth}, (FUSE_BATCH, cfg.num_classes))
    one = {k: v[:1] for k, v in requests[0].items()}
    with torch.no_grad():
        for tag, precision, b, raw in (("BF16", enc.BF16, FUSE_BATCH, requests[0]),
                                       ("BF16", enc.BF16, 1, one),
                                       ("FP32", enc.FP32, FUSE_BATCH, requests[0])):
            ms = _median_ms(lambda: trio(precision)(raw), MODALITY_TIMING_REPS)
            print(f"fused trio forward {tag} b={b} T={FUSE_T}: {ms:.4f} ms, "
                  f"{b * 1000.0 / ms:.2f} seq/s (median of {MODALITY_TIMING_REPS}, raw on the "
                  f"card -> fbank -> Data2Seq x 3 -> encoder -> logits)", flush=True)
            if profile and tag == "BF16":
                _profile_step(lambda: trio(precision)(raw), f"fused trio BF16 b={b}")
    del params, requests, one
    torch.cuda.empty_cache()
    return launches


def phase_buckets(seed: int, dev) -> dict:
    """One ragged ``pad_to_bucket`` + ``encode_bucketed`` call at each bucket
    of the ladder: BUCKET_BATCH samples of (bucket - 3) tokens, sample i
    keeping the first (i + 1) / BUCKET_BATCH of them; kept positions held
    against the plain versions. Buckets up to 256 run the fused sublayers,
    512 and up the flash forward. Returns the launches of the whole ladder."""
    from metatransformer_tpu_torch import pipeline
    from metatransformer_tpu_torch.core import encoder as enc

    ecfg = enc.BASE
    enc_params = enc.cast_params(enc.init(ecfg, torch.Generator().manual_seed(seed)), enc.BF16)
    total = {}
    for bucket in pipeline.BUCKETS:
        t = bucket - 3
        g = torch.Generator(device=dev).manual_seed(seed + bucket)
        x = torch.randn(BUCKET_BATCH, t, D, generator=g, device=dev)
        keep = _prefix_bias(BUCKET_BATCH, t, dev) == 0
        tokens, mask = pipeline.pad_to_bucket(x, keep)
        counts = _held(
            f"bucket {bucket} b={BUCKET_BATCH} ragged", lambda m: pipeline.encode_bucketed(
                enc_params, tokens, m, ecfg, enc.BF16), [mask],
            _expected_launches(bucket, ecfg.depth), (BUCKET_BATCH, bucket, D), keep=lambda m: m)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    torch.cuda.empty_cache()
    return total


def phase_modality_models(seed: int, dev) -> dict:
    """One forward of each modality model at ViT-B16 width (seeded weights,
    BF16) against the plain versions: the audio classifier from waveforms at
    b = 8 (35 classes; fbank on the card, held against the numpy oracle),
    the hyper-spectral classifier at b = 64 in ViT and CAF modes (16
    classes; CAF's skip mix moved off the identity so that it acts), the
    tabular classifier at b = 512 and the time-series forecaster at b = 32
    (96 -> 96, 7 channels); then the CLIP text tower at b = 256 against
    itself in float64 on the card, and the audio batch-1 latency. Returns
    the launches of each model's run."""
    from metatransformer_tpu_torch.core import encoder as enc
    from metatransformer_tpu_torch.models import audio_classifier as ac
    from metatransformer_tpu_torch.models import hyper_classifier as hc
    from metatransformer_tpu_torch.models import tabular_classifier as tc
    from metatransformer_tpu_torch.models import time_series as tsm
    from metatransformer_tpu_torch.ops import fbank
    from metatransformer_tpu_torch.tokenizers import hyper, tabular, text

    g = torch.Generator(device=dev).manual_seed(seed + 3)
    randn = lambda *s: torch.randn(*s, generator=g, device=dev)
    ints = lambda hi, *s: torch.randint(0, hi, s, generator=g, device=dev)
    gen = lambda k: torch.Generator().manual_seed(seed + k)
    depth = enc.BASE.depth
    fused = {"attn_sublayer": depth, "mlp_sublayer": depth}
    launches = {}

    cfg = ac.AudioClassifierConfig()
    params = ac.init(cfg, gen(1))
    params["encoder"] = enc.cast_params(params["encoder"], enc.BF16)
    nb = MODEL_BATCHES
    wave = randn(nb["audio"], FUSE_SAMPLES) * 0.1
    spec = fbank.fbank(wave[:1])
    want = torch.from_numpy(fbank.fbank_np(wave[0].cpu().numpy())).to(dev)
    err = (spec[0] - want).abs().max().item()
    print(f"fbank on the card, 164080 samples -> {tuple(spec.shape)}: max |card - numpy oracle| "
          f"{err:.4g} (tol {FBANK_TOL})", flush=True)
    torch.testing.assert_close(spec[0], want, atol=FBANK_TOL, rtol=FBANK_TOL)
    serve = lambda w: ac.forward_waveform(params, w, cfg, enc.BF16)
    launches["audio_serve"] = _held(
        f"audio classifier b={nb['audio']} T=1212 (waveform -> logits)", serve, [wave],
        {"flash_fwd": depth}, (nb["audio"], cfg.num_classes))
    with torch.no_grad():
        for b in (nb["audio"], 1):
            w = wave[:b]
            ms = _median_ms(lambda: serve(w), MODALITY_TIMING_REPS)
            print(f"audio classifier forward BF16 b={b}: {ms:.4f} ms, {b * 1000.0 / ms:.2f} seq/s "
                  f"(median of {MODALITY_TIMING_REPS}, waveform on the card -> fbank -> logits)",
                  flush=True)
    del params, wave

    tok_cfg = hyper.HyperTokenizerConfig(img_size=1, near_band=49, num_tokens=200, dim=D)
    x = randn(nb["hyper"], 200, 49)
    for mode in ("vit", "caf"):
        cfg = hc.HyperClassifierConfig(tokenizer=tok_cfg, mode=mode)
        params = hc.init(cfg, gen(2))
        if mode == "caf":
            params["skipcat_w"] += 0.02 * torch.randn(params["skipcat_w"].shape,
                                                      generator=gen(3)).to(dev)
        launches[f"hyper_{mode}"] = _held(
            f"hyper classifier {mode} b={nb['hyper']} T=201",
            lambda r: hc.forward(params, r, cfg, enc.BF16), [x], fused,
            (nb["hyper"], cfg.num_classes))
        del params

    cfg = tc.TabularClassifierConfig(tabular.TabularTokenizerConfig(vocab_sizes=(8,) * 14, dim=D))
    params = tc.init(cfg, gen(4))
    launches["tabular_serve"] = _held(
        f"tabular classifier b={nb['tabular']} T=14",
        lambda r: tc.forward(params, r, cfg, precision=enc.BF16), [ints(8, nb["tabular"], 14)],
        fused, (nb["tabular"], cfg.num_classes))
    del params

    cfg = tsm.TimeSeriesModelConfig()  # long-term forecast, 96 -> 96, 7 channels
    params = tsm.init(cfg, gen(5))
    b = nb["time-series"]
    marks = lambda t: torch.stack([ints(n, b, t) for n in (13, 32, 7, 24)], dim=-1)
    x_enc = randn(b, 96, 7)
    batch = {"x_enc": x_enc, "x_mark_enc": marks(96),  # label length 48, then 96 to predict
             "x_dec": torch.cat([x_enc[:, -48:], torch.zeros(b, 96, 7, device=dev)], dim=1),
             "x_mark_dec": marks(144)}
    launches["ts_forecast"] = _held(
        f"time-series forecast b={b} 96 -> 96 (encoder T=96)",
        lambda r: tsm.forward(params, r["x_enc"], cfg, r["x_mark_enc"], r["x_dec"],
                              r["x_mark_dec"], enc.BF16), [batch], fused, (b, 96, 7))
    del params

    cfg = text.TextTokenizerConfig()
    params = text.init(cfg, gen(6))
    b = nb["text"]
    ids = ints(48_999, b, 77) + 1
    with torch.no_grad():
        got = text.encode_text(params, ids, cfg)
        want = text.encode_text({k: v.double() for k, v in params.items()}, ids, cfg)
        ms = _median_ms(lambda: text.encode_text(params, ids, cfg), MODALITY_TIMING_REPS)
    err = (got.double() - want).abs().max().item()
    print(f"CLIP text tower b={b} x 77 (12 x 512, fp32): {tuple(got.shape)}, max |fp32 - "
          f"float64| {err:.4g} (tol {TEXT_TOL}); {ms:.4f} ms, {b * 1000.0 / ms:.2f} texts/s",
          flush=True)
    if got.shape != (b, cfg.proj_dim) or not torch.isfinite(got).all():
        raise AssertionError(f"text tower: {tuple(got.shape)} or non-finite")
    torch.testing.assert_close(got.double(), want, atol=TEXT_TOL, rtol=TEXT_TOL)
    del params
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------------------
# The serving edge: Dispatcher, ServingDaemon, byte payloads; graphs; demo
# --------------------------------------------------------------------------

# scripts/bench_serving.py: 2 requests a modality in one mixed flush, then
# a daemon at max_batch 24 / max_wait 0.3 s taking one warm-up storm and
# SERVING_STORMS timed storms of SERVING_PER_MODALITY requests a modality.
SERVING_FLUSH_PER_MODALITY, SERVING_PER_MODALITY, SERVING_STORMS = 2, 6, 2
SERVING_MAX_BATCH, SERVING_MAX_WAIT_S = 24, 0.3
SERVING_TIMEOUT_S = 300
# The graph predictor of recipes.py build_graph (PCQM4Mv2 TokenGT): buckets
# of 64 nodes and 128 edges, T = 2 + 64 + 128 = 194; GRAPH_CPU_BATCH of its
# GRAPH_BATCH molecules also run on the CPU for the FP32 check.
GRAPH_BATCH, GRAPH_MAX_NODES, GRAPH_MAX_EDGES, GRAPH_LAP_K = 64, 64, 128, 16
GRAPH_CPU_BATCH, GRAPH_TOL = 8, 1e-4


def _serving_raw(name: str, rng: np.random.Generator):
    """One batch-1 request of ``name`` as a client sends it (host numpy):
    the RAW table of scripts/bench_serving.py (uint8 pixels, a padded graph
    dict), copied because that script imports JAX."""
    if name == "graph":
        n_nodes, n_edges = 32, 48
        return {
            "node_data": rng.integers(0, 16, (1, n_nodes, 9)).astype(np.int32),
            "edge_data": rng.integers(0, 4, (1, n_edges, 3)).astype(np.int32),
            "edge_index": rng.integers(0, n_nodes, (1, n_edges, 2)).astype(np.int32),
            "node_num": np.asarray([n_nodes], np.int32),
            "edge_num": np.asarray([n_edges], np.int32),
            "lap_eigvec": rng.standard_normal((1, n_nodes, 16)).astype(np.float32),
        }
    pixels = lambda *s: rng.integers(0, 256, s, dtype=np.uint8)
    return {
        "image": lambda: pixels(1, 224, 224, 3), "x-ray": lambda: pixels(1, 224, 224, 3),
        "infrared": lambda: pixels(1, 224, 224, 1), "video": lambda: pixels(1, 16, 224, 224, 3),
        "audio": lambda: rng.standard_normal((1, 1024, 128)).astype(np.float32),
        "point": lambda: (rng.standard_normal((1, 1024, 3)) * 0.5).astype(np.float32),
        "time-series": lambda: rng.standard_normal((1, 96, 7)).astype(np.float32),
        "imu": lambda: rng.standard_normal((1, 256, 6)).astype(np.float32),
        "tabular": lambda: rng.integers(0, 8, (1, 14)).astype(np.int32),
        "hyper": lambda: rng.standard_normal((1, 200, 49)).astype(np.float32),
        "text": lambda: rng.integers(1, 49000, (1, 77)).astype(np.int32),
    }[name]()


def _serving_dispatcher(seed: int, fused: bool, enc_params=None, toks=None):
    """All 12 ``Data2Seq`` facades (``_modality_config``'s configs, seeded
    weights on the card) behind one ``Dispatcher`` over one ViT-B16 encoder,
    BF16, as scripts/bench_serving.py builds it."""
    from metatransformer_tpu_torch import pipeline, serving
    from metatransformer_tpu_torch.core import encoder as enc

    if toks is None:
        toks = {}
        for i, name in enumerate(MODALITY_SPECS):
            facade = pipeline.Data2Seq(name, D, config=_modality_config(name))
            toks[name] = (facade, facade.init(torch.Generator().manual_seed(seed + 1 + i)))
    if enc_params is None:
        enc_params = enc.init(enc.BASE, torch.Generator().manual_seed(seed))
    cfg = serving.ServingConfig(encoder=enc.BASE, precision=enc.BF16, fused=fused)
    return serving.Dispatcher(toks, enc_params, cfg)


def _flush_launches(disp, fused: bool) -> dict:
    """The launches one flush must make: per encoded group 12 of #1 and #2
    at T <= 256 or 12 of #4 from 512 (bucketed: per (bucket, batch) group;
    packed: per modality group at its own T), one #7 per point group."""
    want = {}
    if fused:
        groups = [MODALITY_SPECS[name][1] for name, _ in disp.tok_stats]
    else:
        groups = [lb for lb, _ in disp.stats]
    for t in groups:
        for k, v in _expected_launches(t, 12).items():
            want[k] = want.get(k, 0) + v
    want["fps"] = sum(n for (name, _), n in disp.tok_stats.items() if name == "point")
    return want


def _host_ms(fn, reps: int = 5) -> float:
    """Median host-clock time of ``fn``, which ends in a device readback."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_serving(seed: int, dev, profile: bool = False) -> dict:
    """The serving edge at ViT-B16 width, BF16, seeded weights: (a) one
    mixed flush of SERVING_FLUSH_PER_MODALITY requests of each of the 12
    modalities through ``Dispatcher.serve``, bucketed and packed, launches
    held to what the groups need and every answer against the same flush
    under the plain versions; (b) ``ServingDaemon`` storms on the packed
    path (as scripts/bench_serving.py runs it) and on the bucketed path: one
    warm-up, SERVING_STORMS timed, every future read; (c) byte payloads (npy, npz,
    WAV, UTF-8, a DIB AVI, PNG where Pillow imports) through the daemon,
    each decoded equal to its array twin on the host and answered as the
    twin is. Flush times by the host clock (``serve`` returns host
    arrays); with ``profile``, device time by kernel of each flush. Returns
    the launches of each path."""
    from metatransformer_tpu_torch import ops, serving

    smi = _smi()
    names = list(MODALITY_SPECS)
    rng = np.random.default_rng(seed + 21)
    flush = [serving.Request(name, _serving_raw(name, rng), request_id=i)
             for i, name in enumerate(names * SERVING_FLUSH_PER_MODALITY)]
    if profile:  # a process's first profiled window holds the profiler's start-up
        from torch.profiler import ProfilerActivity

        with torch.profiler.profile(activities=[ProfilerActivity.CUDA]):
            torch.ones(1, device=dev).add_(1)
            torch.cuda.synchronize()
    bucketed = _serving_dispatcher(seed, fused=False)
    packed = _serving_dispatcher(seed, True, bucketed.encoder_params, bucketed.tokenizers)
    launches = {}
    for path, disp in (("serving_bucketed", bucketed), ("serving_packed", packed)):
        fused = disp.cfg.fused
        disp.serve(flush)  # warm-up: allocator, cuBLAS handles
        disp.stats.clear()
        disp.tok_stats.clear()
        ops.reset_launch_counts()
        answers = disp.serve(flush)
        torch.cuda.synchronize()
        launches[path] = ops.launch_counts()
        want = _flush_launches(disp, fused)
        got = {k: v for k, v in launches[path].items() if v}
        if got != want:
            raise AssertionError(f"{path}: launches {got}, expected {want}")
        with _plain_versions():
            plain = disp.serve(flush)
        err = top = 0.0
        for req, a, p in zip(flush, answers, plain):
            if a.shape != (D,) or a.dtype != np.float32 or not np.isfinite(a).all():
                raise AssertionError(f"{path} {req.modality}: answer {a.shape} {a.dtype}")
            err = max(err, float(np.abs(a - p).max()))
            top = max(top, float(np.abs(p).max()))
            np.testing.assert_allclose(a, p, atol=LOGIT_ATOL, rtol=LOGIT_RTOL,
                                       err_msg=f"{path} {req.modality}")
        ms = _host_ms(lambda: disp.serve(flush))
        if profile:
            _profile_step(lambda: disp.serve(flush), f"{path} flush of {len(flush)}")
        print(f"{path}: one flush of {len(flush)} requests (12 modalities x "
              f"{SERVING_FLUSH_PER_MODALITY}) in {ms:.4f} ms (median of 5, host clock, host "
              f"arrays in and out), num_programs {disp.num_programs} "
              f"({sorted(disp.stats)}), packed_retraces {disp.packed_retraces}, "
              f"packed_fallbacks {disp.packed_fallbacks}, tokenizer groups "
              f"{len(disp.tok_stats)}; max |kernel - plain| {err:.6g} (tol {LOGIT_ATOL} / "
              f"{LOGIT_RTOL}, max |plain| {top:.4g}); launches {launches[path]}", flush=True)

    # (b) the daemon storms of scripts/bench_serving.py: the packed path it
    # runs, then the bucketed path; (c) byte payloads on the packed daemon
    for path, disp in (("serving_daemon", packed), ("serving_daemon_bucketed", bucketed)):
        daemon = serving.ServingDaemon(disp, max_batch=SERVING_MAX_BATCH,
                                       max_wait_s=SERVING_MAX_WAIT_S)
        try:
            launches[path] = _daemon_storms(daemon, rng, names, path, smi)
            if path == "serving_daemon":
                _payloads_through(daemon, rng)
        finally:
            daemon.stop()
    del bucketed, packed
    torch.cuda.empty_cache()
    return launches


def _daemon_storms(daemon, rng: np.random.Generator, names, path: str, smi: str) -> dict:
    """One warm-up storm, then SERVING_STORMS timed storms of
    SERVING_PER_MODALITY requests of each modality submitted round-robin
    (the adversarial mix for the buckets: every flush holds every native
    length); every future read. Prints requests/s, p50, p99 and the
    dispatch split; returns the timed storms' launches."""
    from metatransformer_tpu_torch import ops, serving

    disp = daemon.dispatcher

    def storm():
        reqs = [serving.Request(m, _serving_raw(m, rng))
                for _ in range(SERVING_PER_MODALITY) for m in names]
        t0 = time.perf_counter()
        futs = [daemon.submit(r) for r in reqs]
        outs = [f.result(timeout=SERVING_TIMEOUT_S) for f in futs]
        dt = time.perf_counter() - t0
        for o in outs:
            if o.shape != (D,) or not np.isfinite(o).all():
                raise AssertionError(f"{path} answer {o.shape}, finite {np.isfinite(o).all()}")
        return len(outs), dt

    n_warm, warm_s = storm()
    daemon.reset_stats()
    disp.dispatch_s = 0.0
    retraces = disp.packed_retraces
    ops.reset_launch_counts()
    n = dt = 0
    for _ in range(SERVING_STORMS):
        sn, sdt = storm()
        n, dt = n + sn, dt + sdt
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    lat = daemon.latency_percentiles()
    route = "packed" if disp.cfg.fused else "bucketed"
    split = (f"dispatch_s {disp.dispatch_s:.4f} s of {dt:.4f} s, packed compositions {retraces} "
             f"-> {disp.packed_retraces}, fallbacks {disp.packed_fallbacks}" if disp.cfg.fused
             else f"(length, batch) groups {sorted(disp.stats)}")
    print(f"{path} (max_batch {SERVING_MAX_BATCH}, max_wait {SERVING_MAX_WAIT_S} s, {route}, "
          f"BF16): warm-up {n_warm} requests in {warm_s:.3f} s; {SERVING_STORMS} storms of "
          f"{n // SERVING_STORMS} requests (12 modalities x {SERVING_PER_MODALITY}, "
          f"round-robin): {n / dt:.2f} requests/s, p50 {lat['p50_ms']:.2f} ms, p99 "
          f"{lat['p99_ms']:.2f} ms over {lat['n']} requests, {split}; launches {launches} "
          f"({smi})", flush=True)
    if lat["n"] != n:
        raise AssertionError(f"{path} recorded {lat['n']} latencies of {n} requests")
    return launches


def _payloads_through(daemon, rng: np.random.Generator) -> None:
    """Byte payloads submitted beside their array twins; every future read,
    each answer within the serving tolerance of its twin's."""
    from metatransformer_tpu_torch import serving

    formats = _serving_payloads(rng)
    futs = [(fmt, daemon.submit(serving.Request(m, payload)),
             daemon.submit(serving.Request(m, twin)))
            for fmt, m, payload, twin in formats]
    err = 0.0
    for fmt, fb, ft in futs:
        got, want = fb.result(timeout=SERVING_TIMEOUT_S), ft.result(timeout=SERVING_TIMEOUT_S)
        if got.shape != (D,) or not np.isfinite(got).all():
            raise AssertionError(f"{fmt} payload: answer {got.shape}")
        err = max(err, float(np.abs(got - want).max()))
        np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=LOGIT_RTOL,
                                   err_msg=f"{fmt} payload")
    print(f"serving byte payloads through the daemon: {', '.join(f for f, *_ in formats)}; "
          f"each decoded equal to its array twin on the host, answers within {err:.6g} of the "
          f"twin's (tol {LOGIT_ATOL} / {LOGIT_RTOL})", flush=True)


def _serving_payloads(rng: np.random.Generator) -> list:
    """[(format, modality, payload bytes, array twin)]: each payload decoded
    on the host and held equal to its twin, made without the codec (the
    twin of a WAV is fbank_np of its samples, padded to 1024 frames; of the
    AVI the sampled frames' centre crop; of a PNG the centre crop of a
    256^2 image, which the codec's resize leaves as it is)."""
    import io
    import tempfile
    import wave

    from metatransformer_tpu_torch.data import codecs, video_dataset, video_decode
    from metatransformer_tpu_torch.ops import fbank
    from metatransformer_tpu_torch.tokenizers import bpe

    out = []
    points = (rng.standard_normal((1024, 3)) * 0.5).astype(np.float32)
    series = rng.standard_normal((96, 7)).astype(np.float32)
    out.append(("npy (point)", "point", codecs.encode_npy(points), points[None]))
    out.append(("npy (time-series)", "time-series", codecs.encode_npy(series), series[None]))
    graph = {k: v[0] for k, v in _serving_raw("graph", rng).items()}
    out.append(("npz (graph)", "graph", codecs.encode_npz(graph),
                {k: v[None] for k, v in graph.items()}))
    pcm = (np.clip(rng.standard_normal(FUSE_SAMPLES) * 0.1, -1, 1) * 32767).astype(np.int16)
    bio = io.BytesIO()
    with wave.open(bio, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    spec = fbank.fbank_np(pcm.astype(np.float32) / 32768.0)[:1024]
    spec = np.pad(spec, ((0, 1024 - len(spec)), (0, 0)))[None].astype(np.float32)
    out.append(("WAV (audio)", "audio", bio.getvalue(), spec))
    text = "a photo of a cat on a mat"
    out.append(("UTF-8 (text)", "text", text.encode(), bpe.CLIPBPE().tokenize(text)))
    frames = rng.integers(0, 256, (20, 240, 320, 3), dtype=np.uint8)
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/clip.avi"
        video_decode.write_dib_avi(frames, path)
        with open(path, "rb") as f:
            avi = f.read()
    idx = video_dataset.sample_frame_indices(20, 16, test_clip=0, test_num_clips=1)
    out.append(("DIB AVI (video)", "video", avi,
                video_dataset.three_crop(frames[idx], 224)[1][None]))
    try:
        from PIL import Image
    except ImportError:
        Image = None
    if Image is not None:
        still = rng.integers(0, 256, (256, 256, 3), dtype=np.uint8)
        bio = io.BytesIO()
        Image.fromarray(still).save(bio, "PNG")
        out.append(("PNG (image)", "image", bio.getvalue(), still[16:240, 16:240][None]))
    for fmt, modality, payload, twin in out:
        got = codecs.decode_payload(modality, payload)
        pairs = [(got[k], twin[k]) for k in twin] if isinstance(twin, dict) else [(got, twin)]
        for g, t in pairs:
            if g.dtype != t.dtype or g.shape != t.shape or not np.array_equal(g, t):
                raise AssertionError(f"{fmt}: decoded {g.dtype} {g.shape} differs from its twin "
                                     f"{t.dtype} {t.shape}")
    if Image is None:
        print("serving byte payloads: Pillow does not import here, so no PNG / JPEG payload ran",
              flush=True)
    return out


def _molecules(rng: np.random.Generator, n: int) -> list:
    """Random molecule-like graphs in the PCQM4Mv2 format (9 atom and 3 bond
    feature columns at the dataset's offsets of 512 a column): 9 to 30
    atoms, a chain plus a few ring closures, each bond listed both ways."""
    graphs = []
    for _ in range(n):
        atoms = int(rng.integers(9, 31))
        bonds = [(i, i + 1) for i in range(atoms - 1)]
        for _ in range(int(rng.integers(0, 4))):
            u, v = sorted(int(x) for x in rng.choice(atoms, 2, replace=False))
            if v > u + 2:
                bonds.append((u, v))
        edges = np.array(bonds + [(v, u) for u, v in bonds], np.int32)
        graphs.append({
            "node_data": (rng.integers(1, 512, (atoms, 9)) + 512 * np.arange(9)).astype(np.int32),
            "edge_index": edges,
            "edge_data": (rng.integers(1, 512, (len(edges), 3))
                          + 512 * np.arange(3)).astype(np.int32),
        })
    return graphs


def phase_graph(seed: int, dev, profile: bool = False) -> dict:
    """The graph predictor of recipes.py build_graph at ``enc.GRAPH_BASE``
    (12 x 768, 32 heads of 24; num_atoms 4608, num_edge_types 1536, lap k
    16) on GRAPH_BATCH random molecules through ``graph_collate.collate``
    (T = 194), BF16 as the recipe runs it, with the plain attention and with
    ``attn_impl="performer"``: no kernel of the port admits head_dim 24, so
    both launch none. The card's FP32 predictions are held against the
    CPU's on GRAPH_CPU_BATCH molecules at GRAPH_TOL (TF32 off). Returns the
    launches of each BF16 run."""
    from metatransformer_tpu_torch import ops
    from metatransformer_tpu_torch.core import encoder as enc
    from metatransformer_tpu_torch.data import graph_collate
    from metatransformer_tpu_torch.models import graph_predictor as gp
    from metatransformer_tpu_torch.tokenizers import graph as graph_tok

    smi = _smi()
    tok = graph_tok.GraphTokenizerConfig(num_atoms=4608, num_edge_types=1536, dim=D,
                                         lap_node_id_k=GRAPH_LAP_K)
    cpu_params = gp.init(gp.GraphPredictorConfig(tokenizer=tok),
                         torch.Generator().manual_seed(seed + 31), device="cpu")
    params = {k: ({kk: vv.to(dev) for kk, vv in v.items()} if isinstance(v, dict) else v.to(dev))
              for k, v in cpu_params.items()}
    batch = graph_collate.collate(_molecules(np.random.default_rng(seed + 32), GRAPH_BATCH),
                                  GRAPH_MAX_NODES, GRAPH_MAX_EDGES, GRAPH_LAP_K)
    on_card = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    small = {k: torch.from_numpy(v[:GRAPH_CPU_BATCH]) for k, v in batch.items()}
    t = 2 + GRAPH_MAX_NODES + GRAPH_MAX_EDGES
    launches = {}
    for impl in ("xla", "performer"):
        cfg = gp.GraphPredictorConfig(tokenizer=tok,
                                      encoder=dataclasses.replace(enc.GRAPH_BASE, attn_impl=impl))
        with torch.no_grad():
            ops.reset_launch_counts()
            pred = gp.forward(params, on_card, cfg, precision=enc.BF16)
            torch.cuda.synchronize()
            path = "graph_bf16" if impl == "xla" else "graph_performer_bf16"
            launches[path] = ops.launch_counts()
            if any(launches[path].values()):
                raise AssertionError(f"{path}: launches {launches[path]}, expected none")
            if pred.shape != (GRAPH_BATCH, 1) or not torch.isfinite(pred).all():
                raise AssertionError(f"graph {impl}: predictions {tuple(pred.shape)}")
            ms = _median_ms(lambda: gp.forward(params, on_card, cfg, precision=enc.BF16),
                            MODALITY_TIMING_REPS)
            if profile:
                _profile_step(lambda: gp.forward(params, on_card, cfg, precision=enc.BF16),
                              f"graph predictor ({impl}) BF16 b={GRAPH_BATCH}")
            fp32_card = gp.forward(params, on_card, cfg)[:GRAPH_CPU_BATCH].cpu()
            fp32_cpu = gp.forward(cpu_params, small, cfg)
        err = (fp32_card - fp32_cpu).abs().max().item()
        bf16_gap = (pred[:GRAPH_CPU_BATCH].cpu() - fp32_cpu).abs().max().item()
        print(f"graph predictor ({impl}) b={GRAPH_BATCH} T={t} BF16: {ms:.4f} ms, "
              f"{GRAPH_BATCH * 1000.0 / ms:.2f} graphs/s (median of {MODALITY_TIMING_REPS}, "
              f"collated batch on the card -> predictions); FP32 card vs CPU on "
              f"{GRAPH_CPU_BATCH} molecules: max |diff| {err:.4g} (tol {GRAPH_TOL}); BF16 vs "
              f"FP32 {bf16_gap:.4g}; launches {launches[path]} ({smi})", flush=True)
        torch.testing.assert_close(fp32_card, fp32_cpu, atol=GRAPH_TOL, rtol=GRAPH_TOL)
    del params, cpu_params, on_card
    torch.cuda.empty_cache()
    return launches


def phase_demo(seed: int) -> None:
    """``demo.main`` as a user runs it, with no device named (the card):
    ``--modality image --synthetic`` and a WAV file (audio, through the
    codecs); the printed lines checked."""
    import contextlib
    import io
    import tempfile
    import wave

    from metatransformer_tpu_torch import demo

    pcm = (np.sin(np.arange(48_000) * 0.07) * 2**14).astype(np.int16)
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/tone.wav"
        with wave.open(path, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes(pcm.tobytes())
        for args, tokens in ((["--modality", "image", "--synthetic"], "tokens=(1, 196, 768)"),
                             (["--modality", "audio", "--input", path], "tokens=(1, 1212, 768)")):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = demo.main(args + ["--seed", str(seed)])
            text = out.getvalue()
            for want in (f"modality={args[1]}", "device=cuda", tokens, "pooled[0:8]"):
                if rc != 0 or want not in text:
                    raise AssertionError(f"demo {args}: rc {rc}, {want!r} not in {text!r}")
            print(f"demo {' '.join(args[:3])}: " + " | ".join(text.strip().splitlines()),
                  flush=True)


# --------------------------------------------------------------------------
# Dense prediction: ViT-Adapter, UperNet, TTA, the windowed adapter and
# Mask2Former at the ADE20K YAMLs' full width
# --------------------------------------------------------------------------


class _Replayed:
    """Functions whose outputs carry no gradient, taken as recorded: under
    ``record()`` each call's output is kept, in call order; under
    ``replay()`` each call returns the kept output of the same call (again
    in every later pass). Mask2Former's attention masks are
    ``sigmoid(x) < 0.5`` of a resized logit, its assignment is a linear sum
    assignment on a cost and its loss points the most uncertain of an
    oversampled set: a rounding difference flips each of them at its edge.
    A run recorded with the plain versions and replayed with the kernels
    takes the same masks, matches and points, so what differs is the
    kernels' rounding alone."""

    def __init__(self, *targets):
        self.targets, self.kept, self.calls = targets, {}, {}

    def _patched(self, mode):
        from contextlib import ExitStack

        stack = ExitStack()
        for mod, name in self.targets:
            kept = self.kept.setdefault(name, [])
            self.calls[name] = 0

            def fn(*a, _orig=getattr(mod, name), _kept=kept, _name=name, **k):
                if mode == "record":
                    _kept.append(_orig(*a, **k))
                    return _kept[-1]
                self.calls[_name] += 1
                return _kept[(self.calls[_name] - 1) % len(_kept)]

            stack.enter_context(mock.patch.object(mod, name, fn))
        return stack

    def record(self):
        self.kept.clear()
        return self._patched("record")

    def replay(self):
        return self._patched("replay")

    def check(self, what: str) -> None:
        """Every replayed function ran as often as it was recorded (or a
        whole multiple of it)."""
        for name, kept in self.kept.items():
            if not kept or self.calls[name] % len(kept):
                raise AssertionError(f"{what}: {name} replayed {self.calls[name]} times, "
                                     f"recorded {len(kept)}")


def _m2f_head_highest():
    """The Mask2Former head (and its pixel decoder) at matmul precision
    "highest" whatever the caller asks for."""
    from metatransformer_tpu_torch.heads import mask2former as m2f

    apply = m2f.apply
    return mock.patch.object(m2f, "apply", lambda p, f, c, mm="highest": apply(p, f, c, "highest"))


def _mask2former_pins() -> _Replayed:
    from metatransformer_tpu_torch.heads import mask2former as m2f

    return _Replayed((m2f, "attention_mask"), (m2f, "_host_lsa"),
                     (m2f, "uncertain_point_coords"))


def _dense_cfgs():
    """(UperNet segmentor, Mask2Former segmentor) configs at the published
    widths of ``DENSE_YAML``, as ``recipes.py`` builds its backbone."""
    from metatransformer_tpu_torch import recipes
    from metatransformer_tpu_torch.configs import load_config
    from metatransformer_tpu_torch.models import segmentor

    cfg = load_config(_recipe_yaml(DENSE_YAML))
    bcfg, m = recipes._adapter_cfg(cfg, smoke=False), cfg.model
    return (segmentor.SegmentorConfig(backbone=bcfg, num_classes=m.num_classes),
            segmentor.Mask2FormerSegmentorConfig(
                backbone=bcfg, num_classes=m.num_classes, head_channels=m.head_channels,
                num_queries=m.num_queries, num_decoder_layers=m.num_decoder_layers,
                num_encoder_layers=m.num_encoder_layers, num_heads=m.num_heads))


def _resize_on_card(seed: int, dev) -> float:
    """``vit_adapter.resize`` (``jax.image.resize``: antialiased
    ``F.interpolate``) forward and backward on the card against the CPU at
    each of DENSE_RESIZES; the worst error over max(1, max |value|)."""
    from metatransformer_tpu_torch.models import vit_adapter as va

    g = torch.Generator().manual_seed(seed)
    worst = 0.0
    for hin, hout, c, method in DENSE_RESIZES:
        x = torch.randn(1, hin, hin, c, generator=g)
        cot = torch.randn(1, hout, hout, c, generator=g)
        runs = []
        for where in ("cpu", dev):
            leaf = x.to(where).detach().requires_grad_(True)
            y = va.resize(leaf, (hout, hout), method)
            y.backward(cot.to(where))
            runs.append((y.detach().cpu(), leaf.grad.cpu()))
        (y_cpu, g_cpu), (y_card, g_card) = runs
        errs = [(b - a).abs().max().item() / max(1.0, a.abs().max().item())
                for a, b in ((y_cpu, y_card), (g_cpu, g_card))]
        ulps = 2 * float(np.spacing(np.float32(max(hin, hout))))
        step = max(x.diff(dim=1).abs().max().item(), x.diff(dim=2).abs().max().item())
        tols = [max(RESIZE_TOL, ulps * step), max(RESIZE_TOL, ulps * 4 * cot.abs().max().item())]
        print(f"resize {method} {hin}->{hout} x{c} on the card vs the CPU: forward "
              f"{errs[0]:.3g} (tol {tols[0]:.3g}), backward {errs[1]:.3g} (tol {tols[1]:.3g})",
              flush=True)
        if errs[0] > tols[0] or errs[1] > tols[1]:
            raise AssertionError(f"resize {method} {hin}->{hout}: the card disagrees with the CPU")
        worst = max(worst, *errs)
    return worst


def _dense_windowed_step(params, cfg, images, seed: int, n_win: int, n_global: int) -> dict:
    """The forward and backward of ``seg_loss`` through the windowed
    segmentor, with the kernels and again with the plain versions from the
    same weights: the windowed blocks' backward is #3, the global blocks'
    #5 and #6, one launch each a block; loss within LOSS_TOL, the gradient
    of the largest leaf within GRAD_STEP_REL_L2. Returns the launches."""
    from metatransformer_tpu_torch import ops
    from metatransformer_tpu_torch.core import encoder as enc
    from metatransformer_tpu_torch.models import segmentor
    from metatransformer_tpu_torch.train import trainer as trainer_lib

    b, img = images.shape[:2]
    g = torch.Generator().manual_seed(seed + 2)
    labels = torch.randint(0, cfg.num_classes, (b, img, img), generator=g).to(images.device)

    def step():
        tree = trainer_lib._to_device_tree(params, images.device, trainable=True)
        loss = segmentor.seg_loss(segmentor.forward(tree, images, cfg, enc.BF16), labels)
        loss.backward()
        path, leaf = _largest_leaf(tree)
        return loss.item(), path, leaf.grad

    ops.reset_launch_counts()
    loss, path, grad = step()
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    with _plain_versions():
        ref_loss, _, ref_grad = step()
    want = {"attn_sublayer": n_win, "mlp_sublayer": n_win, "attn_sublayer_bwd": n_win,
            "flash_fwd": n_global, "flash_bwd_dq": n_global, "flash_bwd_dkv": n_global}
    if launches != {k: want.get(k, 0) for k in launches}:
        raise AssertionError(f"dense windowed step: launches {launches}, expected {want}")
    rel_l2 = ((grad - ref_grad).norm() / ref_grad.norm()).item()
    print(f"dense windowed step b={b}: loss {loss:.5f} against plain {ref_loss:.5f} (tol "
          f"{LOSS_TOL}); gradient of {'/'.join(path)} {tuple(grad.shape)} relative L2 "
          f"{rel_l2:.4f} (max {GRAD_STEP_REL_L2}); launches {launches}", flush=True)
    if abs(loss - ref_loss) > LOSS_TOL or not rel_l2 <= GRAD_STEP_REL_L2:
        raise AssertionError("dense windowed step differs from the plain versions")
    return launches


def phase_dense(seed: int, dev, profile: bool = False) -> dict:
    """The dense-prediction slice at ``DENSE_YAML``'s full width (ViT-B16
    adapter, 512^2, 150 classes, BF16, seeded weights), through the port's
    entry points with no device named: (a) the UperNet segmentor serves
    b = 1 and 2, 12 flash forwards a request; (b) ``tta_inference`` at
    b = 1, six forwards at T = 576, 1024, 1600 (72 flash forwards), its
    probabilities summing to 1; (c) the windowed adapter serves b = 2, 8
    of each fused sublayer and 4 flash forwards; (d) the Mask2Former
    segmentor (256 channels, 100 queries, 9 decoder and 6 encoder layers)
    serves b = 2 with its attention masks pinned (``_Replayed``); each held
    against the plain versions on the card, launches exactly; the windowed
    segmentor's loss is also backpropagated once (#3 on the windowed
    blocks, #5 / #6 on the global ones); (e) the card's antialiased resize
    against the CPU; (f) the forward times of (a), (c) and (d) at b = 2,
    and under ``profile`` their device time by kernel and the share of the
    UperNet forward spent outside the 12 ViT blocks. Returns the launches
    by path."""
    from metatransformer_tpu_torch.core import encoder as enc
    from metatransformer_tpu_torch.heads import mask2former as m2f
    from metatransformer_tpu_torch.models import segmentor

    t0 = time.perf_counter()
    ucfg, mcfg = _dense_cfgs()
    bcfg = ucfg.backbone
    img, classes, depth = bcfg.img_size, ucfg.num_classes, bcfg.encoder.depth
    gen = torch.Generator().manual_seed(seed)
    params = segmentor.init(ucfg, gen)  # no device named: the card
    mparams = {"backbone": params["backbone"], "head": m2f.init(mcfg.head, gen)}
    if params["head"]["cls_b"].device.type != "cuda":
        raise AssertionError("the segmentor did not land on the card")
    g = torch.Generator().manual_seed(seed + 1)
    images = {b: torch.randn(b, img, img, 3, generator=g).to(dev) for b in DENSE_BATCHES}
    flash = _expected_launches((img // bcfg.patch_size) ** 2, depth)
    launches = {}

    def upernet(x):
        return segmentor.forward(params, x, ucfg, enc.BF16)

    runs = [_held(f"dense upernet b={b}", upernet, [images[b]], flash, (b, img, img, classes))
            for b in DENSE_BATCHES]
    launches["dense_upernet"] = {k: sum(r[k] for r in runs) for k in runs[0]}

    def tta(x):
        return segmentor.tta_inference(params, x, ucfg, precision=enc.BF16)

    scales = (0.75, 1.0, 1.25)
    tokens = [(round(img * s / bcfg.patch_size)) ** 2 for s in scales]
    if any(_expected_launches(t, depth) != flash for t in tokens):
        raise AssertionError(f"TTA's T = {tokens} do not all resolve to flash")
    launches["dense_tta"] = _held("dense tta b=1", tta, [images[1]],
                                  {"flash_fwd": 2 * len(scales) * depth}, (1, img, img, classes))
    with torch.no_grad():
        total = tta(images[1]).sum(-1)
    if (total - 1).abs().max().item() > DENSE_PROB_TOL:
        raise AssertionError(f"TTA probabilities sum to {total.min().item()} ... "
                             f"{total.max().item()}")
    print(f"dense tta: T = {tokens}, probabilities sum to 1 within "
          f"{(total - 1).abs().max().item():.3g} (tol {DENSE_PROB_TOL})", flush=True)

    wcfg = dataclasses.replace(ucfg, backbone=dataclasses.replace(bcfg, window_attn=DENSE_WINDOWS))
    n_win = sum(DENSE_WINDOWS)

    def windowed(x):
        return segmentor.forward(params, x, wcfg, enc.BF16)

    launches["dense_windowed"] = _held(
        "dense windowed b=2", windowed, [images[2]],
        {"attn_sublayer": n_win, "mlp_sublayer": n_win, "flash_fwd": depth - n_win},
        (2, img, img, classes))
    launches["dense_windowed_step"] = _dense_windowed_step(
        params, wcfg, images[2], seed, n_win, depth - n_win)

    def mask2former(x):
        all_cls, all_masks = segmentor.forward_mask2former(mparams, x, mcfg, enc.BF16)
        return segmentor.mask2former_semantic(all_cls, all_masks, x.shape[1:3])

    pins = _Replayed((m2f, "attention_mask"))
    launches["dense_mask2former"] = _held("dense mask2former b=2", mask2former, [images[2]],
                                          flash, (2, img, img, classes), pins=pins)
    pins.check("dense mask2former")

    worst_resize = _resize_on_card(seed, dev)

    smi, x = _smi(), images[2]
    paths = {"upernet": upernet, "windowed": windowed, "mask2former": mask2former}
    with torch.no_grad():
        times = {name: _median_ms(lambda fn=fn: fn(x)) for name, fn in paths.items()}
        print(f"dense forward times b=2 (ms, median of {TIMING_REPS}, {smi}): "
              + json.dumps({k: round(v, 4) for k, v in times.items()}), flush=True)
        if profile:
            busy = {name: _profile_step(lambda fn=fn: fn(x), f"dense {name} forward b=2", top=16)
                    for name, fn in paths.items()}
            blocks_params = enc.cast_params(params["backbone"]["encoder"], enc.BF16)
            h0 = torch.randn(2, (img // bcfg.patch_size) ** 2, bcfg.encoder.dim,
                             generator=g).to(dev, torch.bfloat16)

            def vit_blocks():
                h = h0
                for j in range(depth):
                    h = enc.block(h, {k: v[j] for k, v in blocks_params.items()},
                                  bcfg.encoder, None, enc.BF16)
                return h

            inside = _profile_step(vit_blocks, "the 12 ViT blocks alone b=2", top=8)
            print(f"dense upernet forward b=2: {100 * (1 - inside / busy['upernet']):.2f}% of "
                  f"its device time outside the ViT blocks (SPM, MSDeformAttn, ConvFFN, "
                  f"UperNet, resizes)", flush=True)
    del params, mparams
    torch.cuda.empty_cache()
    print(f"phase_dense: {time.perf_counter() - t0:.1f} s, worst resize error "
          f"{worst_resize:.3g}", flush=True)
    return launches


# --------------------------------------------------------------------------
# 2D detection: Mask R-CNN, Cascade R-CNN and HTC++ over the ViT-Adapter at
# the COCO YAMLs' full width
# --------------------------------------------------------------------------

# The COCO YAMLs' published widths: the ViT-B16 adapter at 1024^2 (a 64 x 64
# grid, no cls token: T = 4096, where 12 heads fail the fused gate, so every
# block is flash), FPN 768 -> 256 over 5 levels, RPN top 512 of each level
# and 256 proposals, 80 classes, mask 14 -> 28, BF16.
DET_YAMLS = {"mask_rcnn": "coco_mask_rcnn_metatransformer",
             "cascade": "coco_cascade_rcnn_metatransformer",
             "htc": "coco_htcpp_metatransformer"}
DET_BATCHES = (1, 2)
DET_T = 4096
# Boxes are held in pixels of the 1024^2 image: with the choices replayed a
# box moves only by what the kernels' rounding moves its deltas, times its
# side (a delta of 1e-3 on a 1000-pixel box is one pixel). Labels are
# replayed and held equal; scores at the serving bound. The mask and
# semantic logits come out of deep fp32 conv stacks with He-initialised
# weights and no normalisation (HTC++: 4 convs a stage and 3 stages chained
# by the info flow), so their scale grows with depth: they are held at the
# serving bound taken relative to their scale, an atol of DET_REL_ATOL of
# the plain run's largest |value| (the serving bound's 0.15 is 0.03 of a
# largest logit of 5) and LOGIT_RTOL. The kernels' drift reaches them in
# proportion: the card measured the Mask R-CNN and Cascade masks' max abs
# error at 0.9% and 2.2% of their largest value.
DET_BOX_ATOL = 1.0
DET_REL_ATOL = 0.03


def _scaled_atol(ref: torch.Tensor) -> float:
    return max(LOGIT_ATOL, DET_REL_ATOL * ref.float().abs().max().item())


DET_TOLS = {"boxes": (DET_BOX_ATOL, 0.0), "labels": (0.0, 0.0),
            "masks": (_scaled_atol, LOGIT_RTOL), "semantic": (_scaled_atol, LOGIT_RTOL)}
DET_TIMING_REPS = 10  # forwards and recipe steps of the detection family
DET_LSJ_SCALES = (0.3, 0.8, 1.7)


def _detection_pins(train: bool = False) -> _Replayed:
    """The detection path's discrete choices, recorded from the plain run
    and replayed: each level's top-k, the NMS keeps, each box's RoI level
    and, serving, its top class; training, each proposal's assignment. A
    rounding difference flips any of them at its edge, and then the two
    runs' boxes are no longer the same boxes."""
    from metatransformer_tpu_torch.heads import detection2d as det2d

    names = ("level_topk", "nms_xyxy", "roi_levels") + (
        ("rcnn_assign",) if train else ("top_class",))
    return _Replayed(*((det2d, name) for name in names))


def _detection_cfgs():
    """(Mask R-CNN, Cascade R-CNN, HTC++) configs of the COCO YAMLs, as
    ``recipes.py`` builds them."""
    from metatransformer_tpu_torch import recipes
    from metatransformer_tpu_torch.configs import load_config

    cfgs = {name: load_config(_recipe_yaml(stem)) for name, stem in DET_YAMLS.items()}
    return (recipes.detection2d_config(cfgs["mask_rcnn"]),
            recipes.detection2d_config(cfgs["cascade"]), recipes.htc_config(cfgs["htc"]))


def _lsj_on_card(seed: int, dev) -> float:
    """``large_scale_jitter`` on the card against the CPU at DET_LSJ_SCALES
    on a b = 2 batch of 1024^2 images: the resize within RESIZE_TOL of
    max(1, max |value|), the boxes equal; then one draw from a generator on
    the card, in range. Returns the worst resize error."""
    from metatransformer_tpu_torch.train import augment

    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, 1024, 1024, 3, generator=g)
    boxes = torch.rand(2, 4, 4, generator=g) * 1100
    worst = 0.0
    for scale in DET_LSJ_SCALES:
        want = augment.large_scale_jitter(None, x, boxes, scale=scale)
        got = augment.large_scale_jitter(None, x.to(dev), boxes.to(dev), scale=scale)
        err = (got[0].cpu() - want[0]).abs().max().item() / max(1.0, want[0].abs().max().item())
        same_boxes = torch.equal(got[1].cpu(), want[1])
        print(f"large_scale_jitter scale {scale} b=2 1024^2 on the card vs the CPU: image "
              f"{err:.3g} (tol {RESIZE_TOL}), boxes equal {same_boxes}", flush=True)
        if err > RESIZE_TOL or not same_boxes:
            raise AssertionError(f"large_scale_jitter at {scale}: the card disagrees with the CPU")
        worst = max(worst, err)
    scale = augment.large_scale_jitter(torch.Generator(device=dev).manual_seed(seed), x[:1].to(dev),
                                       boxes[:1].to(dev))[2].item()
    if not 0.1 <= scale < 2.0:
        raise AssertionError(f"large_scale_jitter drew the scale {scale} on the card")
    return worst


def _detection_step(params, cfg, images, seed: int) -> dict:
    """The forward and backward of the Mask R-CNN loss at ``images``' batch
    on a synthetic COCO batch of the recipe (2 boxes an image, their masks),
    first with the plain versions recording the choices, then with the
    kernels replaying them, from the same weights: 12 launches each of #4,
    #5 and #6 and no other; loss within LOSS_TOL, the gradient of the
    largest leaf within GRAD_STEP_REL_L2; peak memory. Returns the
    launches."""
    from metatransformer_tpu_torch import ops, recipes
    from metatransformer_tpu_torch.core import encoder as enc
    from metatransformer_tpu_torch.models import mask_rcnn
    from metatransformer_tpu_torch.train import trainer as trainer_lib

    b, img = images.shape[:2]
    synth = recipes._detection_synth(img, cfg.rcnn.num_classes)
    gt = {k: torch.as_tensor(v).to(images.device)
          for k, v in next(iter(synth(b, 1, seed + 2)))["input"].items()}
    pins = _detection_pins(train=True)

    def step():
        tree = trainer_lib._to_device_tree(params, images.device, trainable=True)
        loss, logs = mask_rcnn.forward_train(
            tree, images, gt["gt_boxes"], gt["gt_labels"], gt["gt_valid"], cfg,
            gt_masks=gt["gt_masks"], precision=enc.BF16)
        loss.backward()
        path, leaf = _largest_leaf(tree)
        return loss.item(), {k: round(v.item(), 5) for k, v in logs.items()}, path, leaf.grad

    with _plain_versions(), pins.record():
        ref_loss, ref_logs, _, ref_grad = step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with pins.replay():
        loss, logs, path, grad = step()
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    pins.check("detection step")
    depth = cfg.backbone.encoder.depth
    want = {k: depth for k in FLASH_KERNELS}
    if launches != {k: want.get(k, 0) for k in launches}:
        raise AssertionError(f"detection step: launches {launches}, expected {want}")
    rel_l2 = ((grad - ref_grad).norm() / ref_grad.norm()).item()
    print(f"detection mask_rcnn step b={b}: loss {loss:.5f} against plain {ref_loss:.5f} (tol "
          f"{LOSS_TOL}), terms {logs} (plain {ref_logs}); gradient of {'/'.join(map(str, path))} "
          f"{tuple(grad.shape)} relative L2 {rel_l2:.4f} (max {GRAD_STEP_REL_L2}); peak memory "
          f"{peak:.3f} GiB; launches {launches}", flush=True)
    if abs(loss - ref_loss) > LOSS_TOL or not rel_l2 <= GRAD_STEP_REL_L2:
        raise AssertionError("detection step differs from the plain versions")
    return launches


def phase_detection(seed: int, dev, profile: bool = False) -> dict:
    """2D detection at the COCO YAMLs' full width (ViT-B16 adapter, 1024^2,
    T = 4096, 80 classes, BF16, seeded weights), through the port's entry
    points with no device named: (a) the backbone, FPN and RPN of Mask
    R-CNN at b = 1 and 2, every FPN map and RPN output held (the tensors
    before the first choice); (b) ``forward_test`` of Mask R-CNN, Cascade
    R-CNN and HTC++ at b = 1 and 2, 12 flash forwards a request and no other
    launch, boxes, scores, labels and masks (HTC++: also its semantic
    logits) against the plain versions with the choices replayed
    (``_detection_pins``); (c) one backward of the Mask R-CNN loss at b = 2
    (``_detection_step``); (d) ``large_scale_jitter`` on the card against
    the CPU; (e) the three forwards and the NMS loop timed at b = 2, and
    under ``profile`` their device time by kernel, their idle share, the
    NMS loop's kernels and the share of the Mask R-CNN forward outside the
    12 ViT blocks. Returns the launches by path."""
    from contextlib import ExitStack

    from metatransformer_tpu_torch.core import encoder as enc
    from metatransformer_tpu_torch.heads import detection2d as det2d
    from metatransformer_tpu_torch.models import htc, mask_rcnn, vit_adapter

    t0 = time.perf_counter()
    mcfg, ccfg, hcfg = _detection_cfgs()
    bcfg = mcfg.backbone
    img, depth = mcfg.img_size, bcfg.encoder.depth
    flash = _expected_launches((img // bcfg.patch_size) ** 2, depth)
    if (img // bcfg.patch_size) ** 2 != DET_T or flash != {"flash_fwd": depth}:
        raise AssertionError(f"the COCO backbone at {img}^2 does not resolve to flash at {DET_T}")
    gen = torch.Generator().manual_seed(seed)
    mparams = mask_rcnn.init(mcfg, gen)  # no device named: the card
    if mparams["rcnn"]["stages"][0]["cls"]["w"].device.type != "cuda":
        raise AssertionError("the detector did not land on the card")
    cparams = {**mparams, "rcnn": det2d.rcnn_init(ccfg.rcnn, gen)}
    hparams = htc.init(hcfg, gen)
    g = torch.Generator().manual_seed(seed + 1)
    images = {b: torch.randn(b, img, img, 3, generator=g).to(dev) for b in DET_BATCHES}

    def common(x):
        feats = vit_adapter.apply(mparams["backbone"], x, bcfg, enc.BF16)
        fpn = det2d.fpn_apply(mparams["fpn"], feats, mcfg.fpn)
        out = {f"fpn{i}": f for i, f in enumerate(fpn)}
        for i, (cls, reg) in enumerate(det2d.rpn_apply(mparams["rpn"], fpn, mcfg.rpn)):
            out[f"rpn_cls{i}"], out[f"rpn_reg{i}"] = cls, reg
        return out

    def common_shapes(b):
        shapes = {}
        for i, st in enumerate(mcfg.rpn.strides):
            s, a = img // st, mcfg.rpn.num_anchors
            shapes.update({f"fpn{i}": (b, s, s, mcfg.fpn.out_channels),
                           f"rpn_cls{i}": (b, s * s * a), f"rpn_reg{i}": (b, s * s * a, 4)})
        return shapes

    def outputs(b, cfg):
        p, m = cfg.rpn.max_proposals, 2 * cfg.rcnn.mask_size
        shapes = {"boxes": (b, p, 4), "scores": (b, p), "labels": (b, p),
                  "masks": (b, p, m, m, cfg.rcnn.num_classes)}
        if cfg is hcfg:
            shapes["semantic"] = (b, img // 8, img // 8, hcfg.semantic_classes)
        return shapes

    models = {
        "mask_rcnn": lambda x: mask_rcnn.forward_test(mparams, x, mcfg, enc.BF16),
        "cascade": lambda x: mask_rcnn.forward_test(cparams, x, ccfg, enc.BF16),
        "htc": lambda x: htc.forward_test(hparams, x, hcfg, enc.BF16),
    }
    cfgs = {"mask_rcnn": mcfg, "cascade": ccfg, "htc": hcfg}
    launches = {}

    def run_all(path, fn, shape_of, pins=None):
        runs = [_held(f"detection {path} b={b}", fn, [images[b]], flash, shape_of(b),
                      pins=pins, tols=DET_TOLS) for b in DET_BATCHES]
        launches[f"detection_{path}"] = {k: sum(r[k] for r in runs) for k in runs[0]}

    run_all("common", common, common_shapes)
    pins = _detection_pins()
    for name, fn in models.items():
        run_all(name, fn, lambda b, name=name: outputs(b, cfgs[name]), pins)
        pins.check(f"detection {name}")
    launches["detection_step"] = _detection_step(mparams, mcfg, images[2], seed)
    worst_lsj = _lsj_on_card(seed, dev)

    smi, x = _smi(), images[2]
    nms_args = []
    nms = det2d.nms_xyxy
    with torch.no_grad():
        with ExitStack() as stack:
            stack.enter_context(mock.patch.object(
                det2d, "nms_xyxy", lambda *a: nms_args.append(a) or nms(*a)))
            models["mask_rcnn"](x)
        times = {name: _median_ms(lambda fn=fn: fn(x), DET_TIMING_REPS)
                 for name, fn in models.items()}
        nms_ms = _median_ms(lambda: nms(*nms_args[0]), DET_TIMING_REPS)
        b, n = nms_args[0][0].shape[:2]
        print(f"detection forward times b=2 (ms, median of {DET_TIMING_REPS}, {smi}): "
              + json.dumps({k: round(v, 4) for k, v in times.items()}) + f"; the NMS loop "
              f"alone (b={b}, {n} boxes -> {nms_args[0][3]} proposals an image, {n} x {n} IoU "
              f"matrices): {nms_ms:.4f} ms", flush=True)
        if profile:
            busy = {name: _profile_step(lambda fn=fn: fn(x), f"detection {name} forward b=2",
                                        top=16) for name, fn in models.items()}
            _profile_step(lambda: nms(*nms_args[0]), "the NMS loop alone b=2", top=12)
            blocks_params = enc.cast_params(mparams["backbone"]["encoder"], enc.BF16)
            h0 = torch.randn(2, DET_T, bcfg.encoder.dim, generator=g).to(dev, torch.bfloat16)

            def vit_blocks():
                h = h0
                for j in range(depth):
                    h = enc.block(h, {k: v[j] for k, v in blocks_params.items()},
                                  bcfg.encoder, None, enc.BF16)
                return h

            inside = _profile_step(vit_blocks, "the 12 ViT blocks alone b=2 T=4096", top=8)
            for name in models:
                print(f"detection {name} forward b=2: {100 * (1 - inside / busy[name]):.2f}% of "
                      f"its device time outside the ViT blocks", flush=True)
    del mparams, cparams, hparams, nms_args
    torch.cuda.empty_cache()
    print(f"phase_detection: {time.perf_counter() - t0:.1f} s, worst LSJ resize error "
          f"{worst_lsj:.3g}", flush=True)
    return launches


# --------------------------------------------------------------------------
# 3D detection: the KITTI detectors and their ops at full width
# --------------------------------------------------------------------------

DET3D_YAMLS = {"pointpillars": "kitti_pointpillars", "second": "kitti_second",
               "voxel_rcnn": "kitti_voxel_rcnn", "pv_rcnn": "kitti_pv_rcnn"}
# The four KITTI recipes train at their YAMLs' own batch sizes (32, 4, 2, 2).
DET3D_RECIPES = tuple(sorted(DET3D_YAMLS.values()))
DET3D_CASES = ((1, 16384), (2, 1024))  # (clouds a request, points a cloud): a scan, the recipes'
DET3D_NMS_BOXES = 1024  # proposal_pre / nms_pre
DET3D_FPS_CASES = ((2, 1024, 2048), (1, 16384, 2048))  # PV-RCNN's keypoints: G > N at 1024
# The card against the same code on the CPU, both fp32 with TF32 off and the
# choices replayed: every float output within DET3D_REL of the CPU run's
# largest |value| (at least 1) plus DET3D_REL relative, boxes within
# DET3D_BOX_ATOL metres; IoUs within DET3D_IOU_TOL; losses within DET3D_REL
# relative. The sums run
# in other orders on the two devices (cuDNN and cuBLAS against oneDNN and
# MKL, atomics in the scatters), a few fp32 roundings a layer. A box corner
# 64-80 m out carries an fp32 spacing of 7.6e-6 m, and sin / cos round
# differently on the two devices, so a car's IoU (perimeter over area about
# 3.5 a metre) moves by about 3e-5 for one unit in the last place of a
# corner: the card measured 3.08e-5 over 1024 KITTI boxes against a first
# bound of 1e-5, with the NMS keep set equal.
DET3D_REL = 1e-4
DET3D_BOX_ATOL = 1e-3
DET3D_IOU_TOL = 1e-4
# The training step's gradients are held against a float64 run on the CPU
# with the same choices: the card's relative L2 distance from it, for the
# whole tree and for each leaf, at most DET3D_LEAF_FACTOR times the CPU fp32
# run's own, or DET3D_LEAF_REL. A leaf's fp32 gradient can stand well off
# the exact one on either device (the CPU's PV-RCNN roi_0_a/b at 2.1e-3);
# held against the CPU's fp32 alone, such a leaf says nothing about which
# side is off. The float64 run caught the card's gradient through cuDNN's
# FFT convolution at 20 x the CPU's distance (PV-RCNN's sparse stages,
# 1.4e-3-4.1e-3), gone with the patch-GEMM conv of ``detector3d``. The
# factor is read off the card: of the leaves at half DET3D_LEAF_REL or
# more, the furthest stood at 1.02 x the CPU's (PointPillars' vfe/norm_bias,
# 5.4e-4) and 0.43 x (PV-RCNN's roi_0_a/b, 8.8e-4); larger ratios, up to
# 106 x on PointPillars' block2 weights, sit at 1.1e-4 or less, a ninth
# of DET3D_LEAF_REL.
DET3D_LEAF_FACTOR = 3
DET3D_LEAF_REL = 1e-3


class _ReplayedOn(_Replayed):
    """A ``_Replayed`` recorded on the CPU and replayed on the card: after
    ``record()`` call ``to(device)`` to move what it kept. A target the path
    never called is left out of ``check``."""

    def check(self, what: str) -> None:
        for name, kept in self.kept.items():
            if kept and (not self.calls[name] or self.calls[name] % len(kept)):
                raise AssertionError(f"{what}: {name} replayed {self.calls[name]} times, "
                                     f"recorded {len(kept)}")

    def to(self, device) -> "_ReplayedOn":
        from metatransformer_tpu_torch.core.tree import tree_map

        for name, kept in self.kept.items():
            kept[:] = [tree_map(lambda t: t.to(device) if isinstance(t, torch.Tensor) else t, k)
                       for k in kept]
        return self


def _det3d_pins(train: bool = False) -> _ReplayedOn:
    """The 3D detectors' discrete choices: the voxel set, the top-k and NMS
    keeps, the grid pool's voxels and ball groups' members; training, also
    the anchor assignment and the RoI sampling. fp32 rounding on either
    side of a floor, a threshold or a radius flips any of them."""
    from metatransformer_tpu_torch.models import detector3d, pv_rcnn, voxel_rcnn
    from metatransformer_tpu_torch.ops import iou3d
    from metatransformer_tpu_torch.ops import sparse_conv as sp

    targets = [(sp, "voxel_assignment"), (detector3d, "top_scores"), (iou3d, "nms_bev"),
               (voxel_rcnn, "pool_members"), (pv_rcnn, "ball_members")]
    if train:
        targets += [(detector3d, "assign_targets"), (voxel_rcnn, "sample_rois")]
    return _ReplayedOn(*targets)


def _det3d_cfgs() -> dict:
    """The four KITTI YAMLs' model configs, as ``recipes.py`` builds them."""
    from metatransformer_tpu_torch import recipes
    from metatransformer_tpu_torch.configs import load_config

    cfgs = {name: load_config(_recipe_yaml(stem)) for name, stem in DET3D_YAMLS.items()}
    return {"pointpillars": recipes.pointpillars_config(cfgs["pointpillars"]),
            "second": recipes.second_config(cfgs["second"]),
            "voxel_rcnn": recipes.two_stage_config("voxel_rcnn", cfgs["voxel_rcnn"]),
            "pv_rcnn": recipes.two_stage_config("pv_rcnn", cfgs["pv_rcnn"])}


def _det3d_models(seed: int) -> dict:
    """name -> (cfg, anchors [A, 7] on the CPU, parameters on the card): each
    model built with no device named."""
    from metatransformer_tpu_torch.models import detector3d, pv_rcnn, second, voxel_rcnn

    out = {}
    for name, cfg in _det3d_cfgs().items():
        mod = {"pointpillars": detector3d, "second": second, "voxel_rcnn": voxel_rcnn,
               "pv_rcnn": pv_rcnn}[name]
        params = mod.init(cfg, torch.Generator().manual_seed(seed))  # the card
        anchors = (detector3d.generate_anchors(cfg) if name == "pointpillars"
                   else second.generate_anchors(getattr(cfg, "stage1", cfg)))
        out[name] = (cfg, torch.as_tensor(anchors), params)
    return out


def _det3d_batch(cfg, b: int, n: int, seed: int) -> dict:
    """The recipes' synthetic KITTI batch (``_det3d_synth``) at ``n`` points
    a cloud, as CPU tensors."""
    from metatransformer_tpu_torch import recipes

    s1 = getattr(cfg, "stage1", cfg)
    pc_range = s1.vfe.voxel.pc_range if hasattr(s1, "vfe") else s1.pc_range
    batch = next(iter(recipes._det3d_synth(pc_range, s1.num_classes, n)(b, 1, seed)))["input"]
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _det3d_fns(name: str, cfg, anchors):
    """(forward, predict, loss) of one model: forward -> a dict of its
    outputs, predict -> a dict of [B, ...] tensors, loss -> (total, logs)."""
    from metatransformer_tpu_torch.models import detector3d, pv_rcnn, second, voxel_rcnn

    def stacked(dets):
        return {k: torch.stack([d[k] for d in dets]) for k in dets[0]}

    if name in ("pointpillars", "second"):
        mod = detector3d if name == "pointpillars" else second

        def forward(p, pts):
            return mod.forward(p, pts, cfg)

        def predict(p, pts):
            return stacked(detector3d.predict(mod.forward(p, pts, cfg), anchors.to(pts.device),
                                              cfg))

        def loss(p, x):
            labels = x["gt_labels"] if name == "pointpillars" else None
            return detector3d.detection_loss(mod.forward(p, x["points"], cfg),
                                             anchors.to(x["points"].device), x["gt_boxes"],
                                             x["gt_valid"], cfg, gt_labels=labels)
    else:
        mod = voxel_rcnn if name == "voxel_rcnn" else pv_rcnn

        def forward(p, pts):
            if name == "voxel_rcnn":
                preds, _, bev = voxel_rcnn.forward_stage1(p, pts, cfg)
                return {**preds, "bev": bev}
            preds, keypoints, weighted, logits = pv_rcnn.forward(p, pts, cfg)
            return {**preds, "keypoints": keypoints, "weighted": weighted, "point_logits": logits}

        def predict(p, pts):
            return stacked(mod.predict(p, pts, anchors.to(pts.device), cfg))

        def loss(p, x):
            return mod.training_loss(p, x["points"], x["gt_boxes"], x["gt_valid"],
                                     anchors.to(x["points"].device), cfg)
    return forward, predict, loss


def _det3d_close(what: str, got: dict, want: dict) -> dict:
    """The card's outputs against the CPU's: integers and flags equal,
    floats at the DET3D bounds. Returns the worst error of each key."""
    errs = {}
    for key, ref in want.items():
        out = got[key].cpu()
        if out.shape != ref.shape or not torch.isfinite(out.float()).all():
            raise AssertionError(f"{what} {key}: {tuple(out.shape)} against {tuple(ref.shape)}, "
                                 f"finite {bool(torch.isfinite(out.float()).all())}")
        if not ref.is_floating_point():
            if not torch.equal(out, ref):
                raise AssertionError(f"{what} {key}: {int((out != ref).sum())} of {ref.numel()} "
                                     "differ from the CPU")
            errs[key] = 0.0
            continue
        atol = DET3D_BOX_ATOL if key == "boxes" else DET3D_REL * max(1.0, ref.abs().max().item())
        errs[key] = (out - ref).abs().max().item()
        torch.testing.assert_close(out, ref, atol=atol, rtol=DET3D_REL,
                                   msg=lambda m, key=key: f"{what} {key}: {m}")
    return errs


def _det3d_held(what: str, fn, params, cpu_params, x, expected: dict, dev) -> dict:
    """``fn(params, x)`` on the CPU recording the choices, then on the card
    replaying them (launches held to ``expected`` exactly); every output
    against the CPU's. Returns the card run's launches."""
    from metatransformer_tpu_torch import ops

    pins = _det3d_pins()
    with torch.no_grad():
        with pins.record():
            want = fn(cpu_params, x)
        pins.to(dev)
        ops.reset_launch_counts()
        with pins.replay():
            got = fn(params, x.to(dev))
        torch.cuda.synchronize()
    launches = ops.launch_counts()
    pins.check(what)
    ran = {k: v for k, v in launches.items() if v}
    if ran != expected:
        raise AssertionError(f"{what}: launches {ran}, expected {expected}")
    errs = _det3d_close(what, got, want)
    print(f"{what}: " + ", ".join(f"{k} {tuple(want[k].shape)} {errs[k]:.3g}" for k in want)
          + f" (max |card - CPU|; launches {ran})", flush=True)
    return launches


def _det3d_ops(seed: int, dev) -> None:
    """(a) The ops at KITTI scale on the card against the CPU: one scan of
    DET3D_CASES[0] points voxelised into the SECOND grid (max_voxels 16000,
    (41, 1600, 1408) at 0.05 x 0.05 x 0.1 m), a submanifold, a strided and an
    inverse conv on it (the active sets equal, features at DET3D_REL), and
    the rotated IoU and NMS of DET3D_NMS_BOXES boxes (IoUs at DET3D_IOU_TOL,
    the keep set equal)."""
    from metatransformer_tpu_torch.ops import iou3d
    from metatransformer_tpu_torch.ops import sparse_conv as sp

    cfg = _det3d_cfgs()["second"]
    pts = _det3d_batch(cfg, 1, DET3D_CASES[0][1], seed)["points"]
    g = torch.Generator().manual_seed(seed)
    w1 = torch.randn(3, 3, 3, 4, 16, generator=g) * 0.2
    w2 = torch.randn(3, 3, 3, 16, 32, generator=g) * 0.1
    w3 = torch.randn(3, 3, 3, 32, 16, generator=g) * 0.1

    def convs(points, dv):
        mask = torch.ones(points.shape[:2], dtype=torch.bool, device=dv)
        st = sp.voxelize_points(points, mask, cfg.voxel_size, cfg.pc_range, cfg.spatial_shape,
                                cfg.max_voxels)
        subm = sp.subm_conv3d(st, w1.to(dv))
        down = sp.sparse_conv3d(subm, w2.to(dv), (2, 2, 2), (1, 1, 1))
        up = sp.inverse_sparse_conv3d(down, subm, w3.to(dv), (2, 2, 2), (1, 1, 1))
        return {name: t for name, t in (("voxels", st), ("subm", subm), ("strided", down),
                                         ("inverse", up))}

    with torch.no_grad():
        want, got = convs(pts, "cpu"), convs(pts.to(dev), dev)
    for name, ref in want.items():
        out = got[name]
        same = (torch.equal(out.valid.cpu(), ref.valid)
                and torch.equal(out.coords.cpu()[ref.valid], ref.coords[ref.valid]))
        err = (out.features.cpu() - ref.features).abs().max().item()
        bound = DET3D_REL * max(1.0, ref.features.abs().max().item())
        print(f"det3d ops {name} ({DET3D_CASES[0][1]} points, {int(ref.valid.sum())} of "
              f"{ref.capacity} rows active, {ref.spatial_shape}): active set equal {same}, "
              f"features max |card - CPU| {err:.3g} (tol {bound:.3g})", flush=True)
        if not same or err > bound:
            raise AssertionError(f"det3d ops {name}: the card disagrees with the CPU")

    rng = np.random.default_rng(seed)
    ctr = rng.uniform([0, -40, -2], [70, 40, 0], (64, 3))[rng.integers(0, 64, DET3D_NMS_BOXES)]
    boxes = np.concatenate([ctr + rng.normal(0, 0.6, ctr.shape),
                            rng.uniform([3.2, 1.4, 1.4], [4.6, 1.9, 1.8], (DET3D_NMS_BOXES, 3)),
                            rng.uniform(-np.pi, np.pi, (DET3D_NMS_BOXES, 1))], -1)
    boxes = torch.tensor(boxes, dtype=torch.float32)
    scores = torch.rand(DET3D_NMS_BOXES, generator=g)
    iou = iou3d.boxes_iou3d(boxes, boxes)
    iou_card = iou3d.boxes_iou3d(boxes.to(dev), boxes.to(dev)).cpu()
    err = (iou_card - iou).abs().max().item()
    want = iou3d.nms_bev(boxes, scores, 0.1, 128)
    got = [t.cpu() for t in iou3d.nms_bev(boxes.to(dev), scores.to(dev), 0.1, 128)]
    same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    print(f"det3d ops rotated IoU {DET3D_NMS_BOXES} x {DET3D_NMS_BOXES}: max |card - CPU| "
          f"{err:.3g} (tol {DET3D_IOU_TOL}), {int((iou > 0).sum())} overlapping pairs; NMS at "
          f"0.1 to 128: keep set equal {same}, {int(want[1].sum())} kept", flush=True)
    if err > DET3D_IOU_TOL or not same:
        raise AssertionError("det3d ops: rotated IoU or NMS differs from the CPU")


def _det3d_step(name, fns, params, cpu_params, x, dev) -> dict:
    """(d) One backward of the training loss on the card against the CPU:
    the choices recorded by the CPU's fp32 run and replayed by a float64 run
    on the CPU and by the card's. The loss within DET3D_REL of the CPU's;
    the gradient tree and each leaf within the DET3D_LEAF bounds of the
    float64 gradient (see there); the relative L2 to the CPU's fp32
    gradient printed beside. Peak memory of the card's step. Returns the
    card's launches."""
    from metatransformer_tpu_torch import ops
    from metatransformer_tpu_torch.core.tree import leaves_with_path, tree_map

    pins = _det3d_pins(train=True)

    def step(tree_params, batch):
        tree = tree_map(lambda t: t.detach().clone().requires_grad_(t.is_floating_point()),
                        tree_params)
        loss, _ = fns[2](tree, batch)
        loss.backward()
        return loss.item(), [(p, leaf.grad) for p, leaf in leaves_with_path(tree)]

    def f64(t):
        return t.double() if t.is_floating_point() else t

    with pins.record():
        ref_loss, ref_grads = step(cpu_params, x)
    with pins.replay():
        loss64, grads64 = step(tree_map(f64, cpu_params), tree_map(f64, x))
    pins.check(f"det3d {name} step, float64 on the CPU")
    pins.to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with pins.replay():
        loss, grads = step(params, {k: v.to(dev) for k, v in x.items()})
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    pins.check(f"det3d {name} step")
    expected = {"fps": 1} if name == "pv_rcnn" else {}
    if {k: v for k, v in launches.items() if v} != expected:
        raise AssertionError(f"det3d {name} step: launches {launches}, expected {expected}")

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item() if b.norm() > 0 else float((a - b).norm() > 0)

    def flat(gs, like):
        return [torch.zeros(r.numel(), dtype=torch.float64) if t is None
                else t.cpu().double().flatten() for (_, t), (_, r) in zip(gs, like)]

    card_all, cpu_all, f64_all = (flat(g, ref_grads) for g in (grads, ref_grads, grads64))
    leaves = [("the whole tree", torch.cat(card_all), torch.cat(cpu_all), torch.cat(f64_all))] + [
        ("/".join(map(str, p)), g, r, e)
        for (p, _), g, r, e in zip(grads, card_all, cpu_all, f64_all)]
    worst, ratios, failed = ("", 0.0, 0.0), [], []
    for leaf, g, ref, g64 in leaves:
        card, cpu = rel(g, g64), rel(ref, g64)
        if not card <= max(DET3D_LEAF_FACTOR * cpu, DET3D_LEAF_REL):
            failed.append(f"{leaf} {card:.3g} (CPU fp32 {cpu:.3g})")
        if leaf != "the whole tree" and card > worst[1]:
            worst = (leaf, card, cpu)
        if cpu > 0:
            ratios.append((card / cpu, leaf, card, cpu))
    ratios.sort(reverse=True)
    tree = leaves[0]
    print(f"det3d {name} step b={x['points'].shape[0]}: loss {loss:.6f} against the CPU's "
          f"{ref_loss:.6f} (float64 {loss64:.6f}); gradient relative L2 from float64: the tree "
          f"card {rel(tree[1], tree[3]):.3g}, CPU fp32 {rel(tree[2], tree[3]):.3g}; the leaf "
          f"furthest {worst[0]}: card {worst[1]:.3g}, CPU fp32 {worst[2]:.3g} (max "
          f"{DET3D_LEAF_FACTOR} x the CPU's or {DET3D_LEAF_REL}); the largest card / CPU ratios "
          f"{'; '.join(f'{lf} {q:.3g} ({c:.3g} / {u:.3g})' for q, lf, c, u in ratios[:3])}; "
          f"card to CPU fp32 "
          f"{rel(tree[1], tree[2]):.3g}; peak memory {peak:.3f} GiB; launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    if abs(loss - ref_loss) > DET3D_REL * max(1.0, abs(ref_loss)) or failed:
        raise AssertionError(f"det3d {name} step differs from the CPU: {failed}")
    return launches


def phase_det3d(seed: int, dev, profile: bool = False) -> dict:
    """3D detection at the KITTI YAMLs' full width (seeded weights, fp32),
    through the port's entry points with no device named: (a) the ops at
    KITTI scale against the CPU (``_det3d_ops``); (b) ``forward`` and
    ``predict`` of PointPillars, SECOND, Voxel R-CNN and PV-RCNN at each of
    DET3D_CASES against the same code on the CPU, the choices recorded there
    and replayed (``_det3d_pins``); PV-RCNN launches #7 once a forward, the
    others nothing; (c) #7 at PV-RCNN's shapes (DET3D_FPS_CASES) index for
    index against its plain version; (d) one backward of each training loss
    at b = 2 against the CPU (``_det3d_step``); (e) the forwards, predicts
    and the NMS loop timed at each case (median of DET_TIMING_REPS), and
    under ``profile`` their device time by kernel, idle share and the NMS
    loop's share of each predict. Returns the launches by path."""
    from metatransformer_tpu_torch.core.tree import leaves, tree_map
    from metatransformer_tpu_torch.ops import iou3d

    t0 = time.perf_counter()
    smi = _smi()
    _det3d_ops(seed, dev)
    models = _det3d_models(seed)
    launches, times = {}, {}
    for name, (cfg, anchors, params) in models.items():
        if leaves(params)[0].device.type != dev.type:
            raise AssertionError(f"det3d {name}: the parameters did not land on the card")
        cpu_params = tree_map(lambda t: t.cpu(), params)
        fns = _det3d_fns(name, cfg, anchors)
        expected = {"fps": 1} if name == "pv_rcnn" else {}
        counts = []
        for b, n in DET3D_CASES:
            pts = _det3d_batch(cfg, b, n, seed + b)["points"]
            for kind, fn in (("forward", fns[0]), ("predict", fns[1])):
                counts.append(_det3d_held(f"det3d {name} {kind} b={b} N={n}", fn, params,
                                          cpu_params, pts, expected, dev))
        launches[f"det3d_{name}"] = {k: sum(c[k] for c in counts) for k in counts[0]}
        x = _det3d_batch(cfg, *DET3D_CASES[1], seed + 7)
        launches[f"det3d_{name}_step"] = _det3d_step(name, fns, params, cpu_params, x, dev)

        nms_args = []
        nms = iou3d.nms_bev
        with torch.no_grad():
            for b, n in DET3D_CASES:
                pts = _det3d_batch(cfg, b, n, seed + b)["points"].to(dev)
                with mock.patch.object(iou3d, "nms_bev",
                                       lambda *a, **k: nms_args.append((a, k)) or nms(*a, **k)):
                    fns[1](params, pts)
                calls = list(nms_args)
                nms_args.clear()
                fwd = _median_ms(lambda: fns[0](params, pts), DET_TIMING_REPS)
                pred = _median_ms(lambda: fns[1](params, pts), DET_TIMING_REPS)
                loop = sum(_median_ms(lambda a=a, k=k: nms(*a, **k), DET_TIMING_REPS)
                           for a, k in calls)
                times[f"{name} b={b}"] = {"forward": fwd, "predict": pred, "nms": loop}
                shapes = [(*a[0].shape[:-1], a[3]) for a, _ in calls]
                print(f"det3d {name} b={b} N={n} ({smi}): forward {fwd:.4f} ms, predict "
                      f"{pred:.4f} ms, of which the NMS loops {loop:.4f} ms "
                      f"({100 * loop / pred:.2f}%; calls [B, boxes, max_out] {shapes}); median of "
                      f"{DET_TIMING_REPS}", flush=True)
                if profile:
                    busy = _profile_step(lambda: fns[1](params, pts),
                                         f"det3d {name} predict b={b} N={n}", top=12)
                    nms_busy = sum(_profile_step(lambda a=a, k=k: nms(*a, **k),
                                                 f"det3d {name} NMS loop {i} b={b}", top=4)
                                   for i, (a, k) in enumerate(calls))
                    print(f"det3d {name} predict b={b}: the NMS loops {100 * nms_busy / busy:.2f}% "
                          f"of its device busy time", flush=True)
        del params, cpu_params
        torch.cuda.empty_cache()

    from metatransformer_tpu_torch.ops import point_ops as po

    for b, n, g in DET3D_FPS_CASES:
        pts = _det3d_batch(models["pv_rcnn"][0], b, n, seed + 11)["points"][..., :3]
        pts = pts.contiguous().to(dev)
        _check_fps(f"PV-RCNN keypoints B={b} N={n} G={g}", pts, g)
        with torch.no_grad():
            ms = _loop_ms(lambda: po.fps_cuda(pts, g))
            plain = _median_ms(lambda: po.furthest_point_sample_plain(pts, g), 3)
        bound = _fps_bound(b, n, g)
        times[f"fps B={b} N={n} G={g}"] = {"kernel": ms, "plain": plain, "bound": bound["bound_ms"]}
        print(f"fps PV-RCNN keypoints B={b} N={n} G={g} ({smi}): {ms:.4f} ms a launch (loop of "
              f"{TIMING_REPS}), plain version {plain:.4f} ms, bound {bound['bound_ms']:.4f} ms "
              f"({bound['bound_by']})", flush=True)
    del models
    torch.cuda.empty_cache()
    print(f"det3d times (ms, median of {DET_TIMING_REPS}, {smi}): "
          + json.dumps({k: {kk: round(vv, 4) for kk, vv in v.items()} for k, v in times.items()}),
          flush=True)
    print(f"phase_det3d: {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


# --------------------------------------------------------------------------
# The training entry point: every ported recipe YAML through train_cli
# --------------------------------------------------------------------------

RECIPE_FLAGSHIP = "modelnet40_metatransformer"  # runs at its own batch, 32
RECIPE_BATCH, RECIPE_STEPS = 8, 2  # the others: min(yaml, 8), 1 epoch of 2 steps
# The dense recipes train at the reference's 2 images a GPU
# (ade20k_upernet_metatransformer.yaml: 8 GPUs x 2), where a full-width
# Mask2Former step fits the card.
DENSE_RECIPES = ("ade20k_mask2former_metatransformer", "ade20k_upernet_metatransformer",
                 "coco_mask2former_metatransformer")
DENSE_RECIPE_BATCH = 2
# The COCO detection recipes too (coco_mask_rcnn_metatransformer.yaml: batch
# 16 = 8 GPUs x 2); their steps are timed by a median of DET_TIMING_REPS.
DETECTION_RECIPES = ("coco_cascade_rcnn_metatransformer", "coco_htcpp_metatransformer",
                     "coco_mask_rcnn_metatransformer", "coco_upgraded_mask_rcnn_metatransformer")
FUSED_PATH, FLASH_PATH = FUSED_KERNELS, FLASH_KERNELS
# The kernels each recipe's training launches, by where its encoder's T
# falls (``core/encoder.py`` ``_resolve_impl``): the fused sublayers and
# their backward at T <= 512 under BF16, flash at T >= 512, FPS on every
# point path; under FP32 (the two MAE losses) no fused kernel, and only
# flash past 512 tokens.
RECIPE_KERNELS = {
    "ade20k_mask2former_metatransformer": FLASH_PATH,  # adapter, 32 x 32 grid: T = 1024
    "ade20k_upernet_metatransformer": FLASH_PATH,  # T = 1024
    "adult_tabtransformer": FUSED_PATH,  # T = 9
    "bankm_tabtransformer": FUSED_PATH,  # T = 10
    "coco_cascade_rcnn_metatransformer": FLASH_PATH,  # adapter at 1024^2, 64 x 64: T = 4096
    "coco_htcpp_metatransformer": FLASH_PATH,  # T = 4096
    "coco_mask2former_metatransformer": FLASH_PATH,  # T = 1024
    "coco_mask_rcnn_metatransformer": FLASH_PATH,  # T = 4096
    "coco_upgraded_mask_rcnn_metatransformer": FLASH_PATH,  # T = 4096
    "etth1_metatransformer": FUSED_PATH,  # T = 96
    "ettm1_imputation_metatransformer": FUSED_PATH,  # T = 96
    "imagenet_large_metatransformer": FUSED_PATH,  # ViT-L14, T = 257
    "imagenet_metatransformer": FUSED_PATH,  # T = 197
    "indianpines_caf_metatransformer": FUSED_PATH,  # T = 201
    # the KITTI detectors run no encoder; PV-RCNN takes its keypoints by FPS
    "kitti_pointpillars": (),
    "kitti_pv_rcnn": ("fps",),  # 2048 keypoints from 1024 points a cloud
    "kitti_second": (),
    "kitti_voxel_rcnn": (),
    "indianpines_hyper_metatransformer": FUSED_PATH,  # T = 201
    "kinetics400_metatransformer": FLASH_PATH,  # T = 1568, accum_steps 2
    "kinetics400_videomae_pretrain": FLASH_PATH,  # fp32: decoder T = 1568
    "m4_metatransformer": FUSED_PATH,  # T = 36
    "modelnet40_metatransformer": ("fps", *FUSED_PATH),  # T = 257
    "modelnet40_pointmae_pretrain": ("fps",),  # fp32: T = 17 and 65
    "multimodal_fusion_metatransformer": FLASH_PATH,  # T = 2876
    "pavia_hyper_metatransformer": FUSED_PATH,  # T = 104
    # 32 heads of 24: no kernel admits head_dim 24, in either package
    "pcqm4mv2_tokengt": (),
    "pcqm4mv2_tokengt_performer": (),
    "s3dis_metatransformer": ("fps", *FLASH_PATH),  # 4096 points, T = 1025
    "scannet_metatransformer": ("fps", *FLASH_PATH),  # 8192 points, T = 2049
    "scanobjectnn_metatransformer": ("fps", *FUSED_PATH),  # T = 257
    "shapenetpart_metatransformer": ("fps", *FLASH_PATH),  # 2048 points, T = 513
    "smd_anomaly_metatransformer": FUSED_PATH,  # T = 100
    "speechcommands_metatransformer": FUSED_PATH,  # 12 x 21 patches, T = 252
    "uea_metatransformer": FLASH_PATH,  # T = 1751
    "xray_chest_metatransformer": FUSED_PATH,  # T = 197
}
# held against the plain versions (losses, first gradient and update of the
# largest trainable leaf, at the point bounds); Mask2Former with its masks,
# assignments and loss points pinned to the plain run's (_mask2former_pins),
# the detectors with their proposals, RoI levels and assignments
# (_detection_pins)
RECIPE_HELD = ("ade20k_mask2former_metatransformer", "ade20k_upernet_metatransformer",
               "coco_htcpp_metatransformer", "coco_mask_rcnn_metatransformer",
               "modelnet40_metatransformer", "s3dis_metatransformer")


def _recipe_yaml(stem: str) -> str:
    import os

    from metatransformer_tpu_torch.configs import CONFIG_DIR

    return os.path.join(CONFIG_DIR, f"{stem}.yaml")


def _call_shape(name: str, arg: dict) -> tuple:
    """The shape of one kernel call from its bound arguments: the fused
    sublayers (b, T, D, heads, masked) or, for the MLP, (b, T, D, F); flash
    (b, h, T, d, dtype, masked), as a ``FLASH_CASES`` entry; FPS (b, N, G)."""
    import math

    if name == "fps":
        return (*arg["points"].shape[:2], arg["n_samples"])
    if name in FLASH_KERNELS:
        b, t, h, d = arg["q"].shape
        return (b, h, t, d, arg["q"].dtype, arg["bias"] is not None)
    x = arg["x"]
    b, t, d = x.shape[0], math.prod(x.shape[1:-1]), x.shape[-1]
    if name == "mlp_sublayer":
        return (b, t, d, arg["fc1_w"].shape[1])
    return (b, t, d, arg["num_heads"], arg["bias"] is not None)


class _Recorded:
    """A kernel entry that adds ``(kernel, shape)`` of each call to ``seen``
    and then calls the entry. The entry counts its launches on the name it
    is bound to, which is this object while it stands in: ``launches``
    reads and writes the entry's own count."""

    def __init__(self, name: str, entry, seen: set):
        import inspect

        self.name, self.entry, self.seen = name, entry, seen
        self.signature = inspect.signature(entry)

    def __call__(self, *a, **kw):
        arguments = self.signature.bind(*a, **kw).arguments
        self.seen.add((self.name, _call_shape(self.name, arguments)))
        return self.entry(*a, **kw)

    @property
    def launches(self) -> int:
        return self.entry.launches

    @launches.setter
    def launches(self, value: int) -> None:
        self.entry.launches = value


def _recording_shapes(seen: set):
    """Context: a ``_Recorded`` stands in for every kernel entry."""
    from contextlib import ExitStack

    from metatransformer_tpu_torch.ops import flash_attention as fa
    from metatransformer_tpu_torch.ops import fused_block as fb
    from metatransformer_tpu_torch.ops import point_ops as po

    stack = ExitStack()
    for mod, name in ((fb, "attn_sublayer"), (fb, "mlp_sublayer"), (fb, "attn_sublayer_bwd"),
                      (fa, "flash_fwd"), (fa, "flash_bwd_dq"), (fa, "flash_bwd_dkv"),
                      (po, "fps")):
        entry = f"{name}_cuda"
        recorded = _Recorded(name, getattr(mod, entry), seen)
        stack.enter_context(mock.patch.object(mod, entry, recorded))
    return stack


def _hold_shapes(seen: set, seed: int, dev) -> dict:
    """Each kernel against its plain version at every shape in ``seen``
    (``_recording_shapes``), on seeded inputs of that shape (a masked call
    under a ragged key bias), with the bounds of phases 3, 9 and 10.
    Returns the worst error of each kernel."""
    worst = {}

    def keep(kind, err):
        worst[kind] = max(worst.get(kind, 0.0), err)

    for name, shape in sorted(seen, key=str):
        if name in ("attn_sublayer", "attn_sublayer_bwd"):
            b, t, d, heads, masked = shape
            bias = _prefix_bias(b, t, dev) if masked else None
            if name == "attn_sublayer_bwd":
                keep(name, phase_bwd_kernel(seed, dev, [(b, t, bias)], d, heads, "recipe "))
                continue
            kernel, plain = _pair(name, heads)
            args = _sublayer_inputs(name, b, seed + b + t, dev, t, d)
            keep(name, _check_sublayer(name, kernel, plain, args, bias, "recipe "))
        elif name == "mlp_sublayer":
            b, t, d, mlp = shape
            kernel, plain = _pair(name)
            args = _sublayer_inputs(name, b, seed + b + t, dev, t, d, mlp)
            keep(name, _check_sublayer(name, kernel, plain, args, None, "recipe "))
        elif name == "fps":
            b, n, g = shape
            keep(name, _check_fps(f"recipe B={b} N={n} G={g}",
                                  _clouds(seed + n + g, b, n).to(dev), g))
    flash = sorted({shape for name, shape in seen if name in FLASH_KERNELS}, key=str)
    for kind, err in phase_flash_kernels(seed, dev, flash).items():
        keep(kind, err)
    torch.cuda.empty_cache()
    return worst


def _cli(argv) -> str:
    """``train_cli.main(argv)`` with its standard output kept and echoed."""
    import contextlib
    import io

    from metatransformer_tpu_torch import train_cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = train_cli.main(argv)
    text = out.getvalue()
    for line in text.strip().splitlines():
        print(f"  | {line}", flush=True)
    if rc != 0:
        raise AssertionError(f"train_cli {argv}: exit code {rc}")
    return text


def _final_loss(text: str, what: str) -> float:
    import re

    found = re.search(r"^final: .*'loss': ([^,}]+)", text, re.M)
    loss = float(found.group(1)) if found else float("nan")
    if not np.isfinite(loss):
        raise AssertionError(f"{what}: no finite final loss in {text!r}")
    return loss


def _recipe_batch(stem: str) -> int:
    from metatransformer_tpu_torch.configs import load_config

    yaml_batch = load_config(_recipe_yaml(stem)).train.batch_size
    if stem == RECIPE_FLAGSHIP or stem in DET3D_RECIPES:
        return yaml_batch
    return min(yaml_batch, DENSE_RECIPE_BATCH if stem in DENSE_RECIPES + DETECTION_RECIPES
               else RECIPE_BATCH)


def _hold_recipe(stem: str, seed: int) -> None:
    """Two Trainer steps of the recipe as ``train_cli`` builds it (its
    optimizer, schedule and frozen keys) on its first synthetic batch, then
    the same two steps from the same weights with the plain versions:
    losses within LOSS_TOL (Mask2Former: M2F_LOSS_RTOL of the plain run's),
    the first gradient and the update of the largest trainable leaf at the
    point bounds. Mask2Former and detection recipes run the plain versions
    first, recording their masks, assignments and loss points (detection:
    proposals, RoI levels and assignments, ``_detection_pins``), and the
    kernels replay them."""
    from metatransformer_tpu_torch import train_cli

    argv = _recipe_argv(stem, seed)

    def run():
        session = train_cli.setup(argv)
        trainer = session.trainer
        batch = next(iter(session.train_batches()))
        path, leaf = _largest_leaf(trainer.trainable)
        start = leaf.detach().clone()
        losses, grad = [], None
        for step in range(RECIPE_STEPS):
            losses.append(trainer.train_epoch([batch])["loss"])
            if step == 0:
                grad = leaf.grad.detach().clone()
        update = leaf.detach() - start
        return path, losses, grad, update, start

    if "mask2former" in stem:
        pins = _mask2former_pins()
        with _plain_versions(), pins.record():
            _, ref_losses, ref_grad, ref_update, _ = run()
        with pins.replay():
            path, losses, grad, update, start = run()
        pins.check(f"recipe {stem}")
        # the control: both runs again with the head's products at full
        # precision, to see how much of the loss gap the head's bf16
        # operand rounding adds to the kernels' own
        with _m2f_head_highest():
            with _plain_versions(), pins.record():
                _, hi_ref_losses, _, _, _ = run()
            with pins.replay():
                _, hi_losses, _, _, _ = run()
        pins.check(f"recipe {stem}, head at highest")
        hi_diffs = [abs(a - b) for a, b in zip(hi_losses, hi_ref_losses)]
        print(f"recipe {stem} vs plain versions, head products at 'highest' in both: "
              f"losses " + " ".join(f"{v:.5f}" for v in hi_losses) + ", |loss diff| "
              + " ".join(f"{v:.5f}" for v in hi_diffs) + f" (tol {LOSS_TOL})", flush=True)
        if not all(np.isfinite(hi_losses)) or max(hi_diffs) > LOSS_TOL:
            raise AssertionError(f"recipe {stem} with the head at 'highest': losses "
                                 f"{hi_losses} against plain {hi_ref_losses}")
    elif stem in DETECTION_RECIPES:
        pins = _detection_pins(train=True)
        with _plain_versions(), pins.record():
            _, ref_losses, ref_grad, ref_update, _ = run()
        with pins.replay():
            path, losses, grad, update, start = run()
        pins.check(f"recipe {stem}")
    else:
        path, losses, grad, update, start = run()
        with _plain_versions():
            _, ref_losses, ref_grad, ref_update, _ = run()
    diffs = [abs(a - b) for a, b in zip(losses, ref_losses)]
    loss_tol = max(LOSS_TOL, M2F_LOSS_RTOL * max(map(abs, ref_losses))) if (
        "mask2former" in stem) else LOSS_TOL
    grad_rel_l2 = ((grad - ref_grad).norm() / ref_grad.norm()).item()
    atol = 2.0 ** (int(np.floor(np.log2(start.abs().max().item()))) - 7)
    inside = ((update - ref_update).abs()
              <= atol + UPDATE_RTOL * ref_update.abs()).float().mean().item()
    rel_l2 = ((update - ref_update).norm() / ref_update.norm()).item()
    min_fraction, max_rel_l2 = POINT_UPDATE_BOUNDS
    print(f"recipe {stem} vs plain versions, {RECIPE_STEPS} steps at batch "
          f"{_recipe_batch(stem)}: "
          f"losses " + " ".join(f"{v:.5f}" for v in losses) + ", |loss diff| "
          + " ".join(f"{v:.5f}" for v in diffs) + f" (tol {loss_tol:.4g}); {'/'.join(path)} "
          f"{tuple(start.shape)}: first gradient relative L2 {grad_rel_l2:.4f} (max "
          f"{GRAD_STEP_REL_L2}), update {inside:.4f} of elements inside (min {min_fraction}), "
          f"relative L2 {rel_l2:.4f} (max {max_rel_l2})", flush=True)
    if not all(np.isfinite(losses)) or max(diffs) > loss_tol:
        raise AssertionError(f"recipe {stem}: losses {losses} against plain {ref_losses}")
    if not grad_rel_l2 <= GRAD_STEP_REL_L2:
        raise AssertionError(f"recipe {stem}: first gradient of {path} differs from the plain run")
    if inside < min_fraction or not rel_l2 <= max_rel_l2:
        raise AssertionError(f"recipe {stem}: update of {path} differs from the plain run")


def _jpeg_tree(root: str, seed: int, classes: int = 2, per_class: int = 8) -> None:
    """A small ImageFolder tree of JPEGs of mixed sizes."""
    import os

    from PIL import Image

    rng = np.random.default_rng(seed)
    for c in range(classes):
        os.makedirs(f"{root}/class{c}")
        for i in range(per_class):
            h, w = int(rng.integers(200, 400)), int(rng.integers(200, 400))
            Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(
                f"{root}/class{c}/{i}.jpg", quality=90)


def _recipe_argv(stem: str, seed: int) -> list:
    return ["--cfg", _recipe_yaml(stem), "--epochs", "1",
            "--steps-per-epoch", str(RECIPE_STEPS), f"train.batch_size={_recipe_batch(stem)}",
            f"seed={seed}"]


def _recipe_reps(stem: str) -> int:
    return DET_TIMING_REPS if stem in DETECTION_RECIPES + DET3D_RECIPES else TIMING_REPS


def phase_family_recipes(stems, what: str, seed: int, dev, profile: bool = False) -> None:
    """``--dense`` and ``--detection`` only: the holds (those in RECIPE_HELD)
    and step times of one family's recipes, as ``phase_recipes`` takes them,
    without the other recipes."""
    import gc

    from metatransformer_tpu_torch import train_cli

    times = {}
    for stem in stems:
        if stem in RECIPE_HELD:
            _hold_recipe(stem, seed)
        session = train_cli.setup(_recipe_argv(stem, seed))
        times[stem] = _time_step(
            f"recipe {stem} step", session.trainer, next(iter(session.train_batches())),
            "samples", torch.Generator(device=dev).manual_seed(seed),
            f"recipe {stem} step b={DENSE_RECIPE_BATCH}" if profile else None,
            size=DENSE_RECIPE_BATCH, top=6, reps=_recipe_reps(stem))
        del session
        gc.collect()
        torch.cuda.empty_cache()
    print(f"{what} recipe step times (ms, median of {_recipe_reps(stems[0])}, {_smi()}): "
          + json.dumps({k: round(v, 4) for k, v in times.items()}), flush=True)


def _train_recipe(stem: str, seed: int, dev, profile: bool, shapes: set, extra=()) -> tuple:
    """``train_cli.main`` on one recipe YAML as a user runs it (its launches
    held to RECIPE_KERNELS, the shape of each kernel call added to
    ``shapes``, a finite final loss), then its step timed as
    ``train_cli.setup`` builds it, with its peak memory. Returns (launches,
    ms)."""
    import gc

    from metatransformer_tpu_torch import ops, train_cli

    batch = _recipe_batch(stem)
    argv = _recipe_argv(stem, seed) + list(extra)
    print(f"recipe {stem}: train_cli {' '.join(argv)}", flush=True)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with _recording_shapes(shapes):
        text = _cli(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    loss = _final_loss(text, stem)
    ran = {k for k, v in counts.items() if v}
    if ran != set(RECIPE_KERNELS[stem]):
        raise AssertionError(f"recipe {stem}: launched {sorted(ran)}, expected "
                             f"{sorted(RECIPE_KERNELS[stem])}")
    print(f"recipe {stem}: batch {batch}, final loss {loss:.4f}, {wall:.2f} s in "
          f"train_cli.main (build, steps, validation); launches {counts}", flush=True)
    session = train_cli.setup(_recipe_argv(stem, seed))
    ms = _time_step(
        f"recipe {stem} step", session.trainer, next(iter(session.train_batches())),
        "samples", torch.Generator(device=dev).manual_seed(seed),
        f"recipe {stem} step b={batch}" if profile else None, size=batch, top=6,
        reps=_recipe_reps(stem))
    del session
    gc.collect()
    torch.cuda.empty_cache()
    return counts, ms


def phase_det3d_recipes(seed: int, dev, profile: bool = False) -> dict:
    """``--det3d`` only: the four KITTI recipes through ``train_cli`` at full
    width and their own batch sizes, as ``phase_recipes`` trains them, and
    #7 held against its plain version at the shapes they gave it. Returns
    the launches by path."""
    launches, times, shapes = {}, {}, set()
    for stem in DET3D_RECIPES:
        launches[f"recipes_{stem}"], times[stem] = _train_recipe(stem, seed, dev, profile, shapes)
    _hold_shapes(shapes, seed, dev)
    print(f"det3d recipe step times (ms, median of {DET_TIMING_REPS}, {_smi()}): "
          + json.dumps({k: round(v, 4) for k, v in times.items()}), flush=True)
    return launches


def phase_recipes(seed: int, dev, profile: bool = False) -> tuple:
    """``train_cli.main`` on every ported recipe YAML, as a user runs it: no
    ``--device`` (the card), no ``--smoke`` (full width), 1 epoch of 2 steps
    at ``train.batch_size=min(yaml, 8)`` (the flagship at its own 32). Each
    recipe's kernel launches are counted under ``recipes_<stem>``, with the
    shape of every kernel call, and its final loss must be finite; then its
    step is timed as ``train_cli.setup`` builds it (median of TIMING_REPS,
    first batch on the card). ``--eval`` and ``--eval-all`` run on
    modelnet40's work dir and ``--data`` on a JPEG tree for imagenet. Every
    kernel is then held against its plain version at each shape these runs
    gave it, and modelnet40 and s3dis train against the plain versions.
    ``profile``: device time by kernel and idle share of each recipe's
    step. Returns the launches by path and each kernel's worst error."""
    import gc
    import os
    import tempfile

    from metatransformer_tpu_torch import ops, train_cli
    from metatransformer_tpu_torch.configs import CONFIG_DIR

    ported = sorted(RECIPE_KERNELS)
    shipped = sorted(n[:-5] for n in os.listdir(CONFIG_DIR) if n.endswith(".yaml"))
    if not set(ported) <= set(shipped):
        raise AssertionError(f"recipes not shipped: {set(ported) - set(shipped)}")
    smi = _smi()
    launches, times, shapes = {}, {}, set()
    # modelnet40 trains with a --work-dir that --eval and --eval-all then read
    with tempfile.TemporaryDirectory() as work:
        for stem in ported:
            extra = ["--work-dir", f"{work}/{stem}"] if stem == RECIPE_FLAGSHIP else []
            launches[f"recipes_{stem}"], times[stem] = _train_recipe(stem, seed, dev, profile,
                                                                     shapes, extra)

        flagship = ["--cfg", _recipe_yaml(RECIPE_FLAGSHIP), "--steps-per-epoch", str(RECIPE_STEPS),
                    f"train.batch_size={_recipe_batch(RECIPE_FLAGSHIP)}", f"seed={seed}",
                    "--work-dir", f"{work}/{RECIPE_FLAGSHIP}"]
        with _recording_shapes(shapes):
            text = _cli(flagship + ["--eval"])
            if "eval:" not in text or "'acc'" not in text:
                raise AssertionError(f"--eval printed {text!r}")
            text = _cli(flagship + ["--eval-all"])
            if text.count("eval epoch") != 1 or "best:" not in text:
                raise AssertionError(f"--eval-all printed {text!r}")
    with tempfile.TemporaryDirectory() as tree:
        _jpeg_tree(tree, seed)
        ops.reset_launch_counts()
        with _recording_shapes(shapes):
            text = _cli(["--cfg", _recipe_yaml("imagenet_metatransformer"), "--epochs", "1",
                         "--data", tree, f"train.batch_size={RECIPE_BATCH}", f"seed={seed}"])
        launches["recipes_imagenet_data"] = ops.launch_counts()
        _final_loss(text, "imagenet --data")
        if "val_acc" not in text:
            raise AssertionError(f"--data printed {text!r}")
    gc.collect()
    torch.cuda.empty_cache()

    launched = {k for counts in launches.values() for k, v in counts.items() if v}
    if {name for name, _ in shapes} != launched:
        raise AssertionError(f"kernels launched {sorted(launched)}, shapes recorded for "
                             f"{sorted({name for name, _ in shapes})}")
    print(f"recipe kernel shapes ({len(shapes)} kernel calls of distinct shape): "
          + "; ".join(f"{name} {shape}" for name, shape in sorted(shapes, key=str)), flush=True)
    worst = _hold_shapes(shapes, seed, dev)
    for stem in RECIPE_HELD:
        _hold_recipe(stem, seed)
        gc.collect()
        torch.cuda.empty_cache()

    # the bare point-classifier step of phase_point_train beside the flagship's
    trainer = _make_point_trainer("frozen", seed)
    _time_step("point train step frozen (phase_point_train's Trainer)", trainer,
               _point_batch(seed), "clouds", _dropout_generator(seed))
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    print(f"recipe step times (ms, median of {TIMING_REPS}, the detection recipes of "
          f"{DET_TIMING_REPS}, {smi}): " + json.dumps({k: round(v, 4) for k, v in times.items()}),
          flush=True)
    return launches, worst


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also print device time by kernel of one full-track image step, "
                         "one video forward at b=8, one full-track video step, the point "
                         "and segmenter forwards at their largest batch, one full-track "
                         "point step, the text and audio modalities, the fused trio at "
                         "b=8 and b=1, one bucketed and one packed serving flush, the "
                         "graph predictor, the dense forwards (UperNet, windowed, "
                         "Mask2Former at b=2, with the share outside the ViT blocks) and "
                         "one step of each ported recipe")
    ap.add_argument("--bwd-times", action="store_true",
                    help="only build and time the flash backward kernels and one step of "
                         "each video track, to compare checkouts in turns; prints no result")
    ap.add_argument("--kernel-times", action="store_true",
                    help="only build and time kernels #1-#4 beside their library calls, "
                         "the image and point forwards, one image step of each track, the "
                         "video forward and one video step of each track, to compare "
                         "checkouts in turns; prints no result")
    ap.add_argument("--fps-plans", action="store_true",
                    help="only build and time kernel #7 at every FPS case under its launch "
                         "plan and plans with one knob changed; prints no result")
    ap.add_argument("--serving", action="store_true",
                    help="only build and drive the serving edge (Dispatcher, ServingDaemon, "
                         "byte payloads), the graph predictor and the demo; prints no result")
    ap.add_argument("--dense", action="store_true",
                    help="only build and run phase_dense, then hold and time the three dense "
                         "recipes (DENSE_RECIPES) as phase_recipes does; prints no result")
    ap.add_argument("--detection", action="store_true",
                    help="only build and run phase_detection, then hold and time the four COCO "
                         "detection recipes (DETECTION_RECIPES) as phase_recipes does; prints "
                         "no result")
    ap.add_argument("--det3d", action="store_true",
                    help="only build and run phase_det3d, then train the four KITTI recipes "
                         "(DET3D_RECIPES) through train_cli as phase_recipes does; prints no "
                         "result")
    ap.add_argument("--recipes", action="store_true",
                    help="only build and train every ported recipe YAML through train_cli "
                         "at full width (phase_recipes); prints no result")
    args = ap.parse_args()

    phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    if args.bwd_times:
        phase_bwd_times(args.seed, dev)
        return
    if args.kernel_times:
        phase_kernel_times(args.seed, dev, args.profile)
        return
    if args.fps_plans:
        phase_fps_plans(args.seed, dev)
        return
    if args.serving:
        phase_serving(args.seed, dev, args.profile)
        phase_graph(args.seed, dev, args.profile)
        phase_demo(args.seed)
        return
    if args.recipes:
        phase_recipes(args.seed, dev, args.profile)
        return
    if args.dense:
        phase_dense(args.seed, dev, args.profile)
        phase_family_recipes(DENSE_RECIPES, "dense", args.seed, dev, args.profile)
        return
    if args.detection:
        phase_detection(args.seed, dev, args.profile)
        phase_family_recipes(DETECTION_RECIPES, "detection", args.seed, dev, args.profile)
        return
    if args.det3d:
        phase_det3d(args.seed, dev, args.profile)
        phase_det3d_recipes(args.seed, dev, args.profile)
        return
    errs = phase_kernels(args.seed, dev)
    phase_autograd(args.seed, dev)
    model, serve_launches = phase_serve(args.seed, dev)
    times = phase_times(model, args.seed, dev)
    del model
    large_launches = phase_large_serve(args.seed, dev)
    train_launches = phase_train(args.seed, dev)
    torch.cuda.empty_cache()
    phase_train_times(args.seed, dev, args.profile)
    large_train_launches = phase_large_train(args.seed, dev)
    torch.cuda.empty_cache()

    errs.update(phase_flash_kernels(args.seed, dev))
    phase_flash_autograd(args.seed, dev)
    video_model, video_serve_launches = phase_video_serve(args.seed, dev)
    times.update(phase_flash_times(args.seed, dev))
    phase_video_times(video_model, args.seed, dev, args.profile)
    del video_model
    torch.cuda.empty_cache()
    video_train_launches = phase_video_train(args.seed, dev)
    video_remat_launches, video_remat_save_launches = phase_video_remat(args.seed, dev)
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
    pinned_launches = phase_point_train_pinned(args.seed, dev)
    point_mae_launches = phase_point_mae(args.seed, dev)
    multiview_launches = phase_multiview_serve(args.seed, dev)

    modality_launches = phase_modalities(args.seed, dev, args.profile)
    fuse_launches = phase_fuse(args.seed, dev, args.profile)
    bucket_launches = phase_buckets(args.seed, dev)
    model_launches = phase_modality_models(args.seed, dev)
    serving_launches = phase_serving(args.seed, dev, args.profile)
    graph_launches = phase_graph(args.seed, dev, args.profile)
    phase_demo(args.seed)
    dense_launches = phase_dense(args.seed, dev, args.profile)
    detection_launches = phase_detection(args.seed, dev, args.profile)
    det3d_launches = phase_det3d(args.seed, dev, args.profile)
    recipe_launches, recipe_errs = phase_recipes(args.seed, dev, args.profile)
    for name, err in recipe_errs.items():
        errs[name] = max(errs[name], err)
    phase_native_host(args.seed)
    phase_host_copies(args.seed, dev)

    by_path = {
        "serve": serve_launches,
        "large_serve": large_launches,
        **{f"train_{k}": v for k, v in train_launches.items()},
        "large_train": large_train_launches,
        "video_serve": video_serve_launches,
        **{f"video_train_{k}": v for k, v in video_train_launches.items()},
        "video_remat": video_remat_launches,
        "video_remat_save": video_remat_save_launches,
        "video_mae": mae_launches,
        "point_serve": point_serve_launches,
        **{f"point_train_{k}": v for k, v in point_train_launches.items()},
        **{f"point_train_pinned_{k}": v for k, v in pinned_launches.items()},
        "seg_serve": seg_serve_launches,
        "point_mae": point_mae_launches,
        "multiview_serve": multiview_launches,
        **modality_launches,
        **fuse_launches,
        "buckets": bucket_launches,
        **model_launches,
        **serving_launches,
        **graph_launches,
        **dense_launches,
        **detection_launches,
        **det3d_launches,
        **recipe_launches,
    }
    on_path = {  # the kernels each path must have gone through
        "serve": ("attn_sublayer", "mlp_sublayer"),
        "large_serve": ("attn_sublayer", "mlp_sublayer"),
        "train_frozen": FUSED_KERNELS, "train_full": FUSED_KERNELS,
        "large_train": FUSED_KERNELS,
        "video_serve": ("flash_fwd",),
        "video_train_frozen": FLASH_KERNELS, "video_train_full": FLASH_KERNELS,
        "video_remat": FLASH_KERNELS,
        "video_remat_save": FLASH_KERNELS,
        "video_mae": FLASH_KERNELS,
        "point_serve": ("fps", "attn_sublayer", "mlp_sublayer"),
        "point_train_frozen": ("fps", *FUSED_KERNELS),
        "point_train_full": ("fps", *FUSED_KERNELS),
        "point_train_pinned_frozen": ("fps", *FUSED_KERNELS),
        "point_train_pinned_full": ("fps", *FUSED_KERNELS),
        "seg_serve": ("fps", "flash_fwd"),
        "point_mae": ("fps",),
        "multiview_serve": ("attn_sublayer", "mlp_sublayer"),
        "fuse_bf16": ("flash_fwd",), "fuse_fp32": ("flash_fwd",),
        "buckets": ("attn_sublayer", "mlp_sublayer", "flash_fwd"),
        "audio_serve": ("flash_fwd",),
        **{path: ("attn_sublayer", "mlp_sublayer")
           for path in ("hyper_vit", "hyper_caf", "tabular_serve", "ts_forecast")},
        **{path: ("attn_sublayer", "mlp_sublayer", "flash_fwd", "fps")
           for path in ("serving_bucketed", "serving_packed", "serving_daemon",
                        "serving_daemon_bucketed")},
        # head_dim 24: no kernel admits it, in either package (phase_graph
        # asserts that these ran none)
        "graph_bf16": (), "graph_performer_bf16": (),
        "dense_upernet": ("flash_fwd",), "dense_tta": ("flash_fwd",),
        "dense_windowed": ("attn_sublayer", "mlp_sublayer", "flash_fwd"),
        "dense_windowed_step": FUSED_KERNELS + FLASH_KERNELS,
        "dense_mask2former": ("flash_fwd",),
        **{f"detection_{path}": ("flash_fwd",)
           for path in ("common", "mask_rcnn", "cascade", "htc")},
        "detection_step": FLASH_KERNELS,
        # no 3D detector runs the encoder; PV-RCNN takes its keypoints by FPS
        # (phase_det3d asserts that the others launched nothing)
        **{f"det3d_{name}{part}": ("fps",) if name == "pv_rcnn" else ()
           for name in DET3D_YAMLS for part in ("", "_step")},
        **{f"recipes_{stem}": kinds for stem, kinds in RECIPE_KERNELS.items()},
        "recipes_imagenet_data": FUSED_KERNELS,
    }
    for name, (_, t, bucket) in MODALITY_SPECS.items():
        depth, fps = 12, name == "point"
        on_path[f"modalities_{name}"] = tuple(_expected_launches(t, depth, fps))
        on_path[f"bucketed_{name}"] = tuple(_expected_launches(bucket, depth, fps))
    if set(on_path) != set(by_path):
        raise AssertionError(f"paths without kernels named: {set(by_path) ^ set(on_path)}")
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
            "ms": times[name]["ms"],  # a loop of launches between two events, over the count
            "ms_single_call": times[name]["ms_single_call"],  # one timed call, host work included
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
            **({"port_backward_ms": times[name]["port_backward_ms"]}
               if "port_backward_ms" in times[name] else {}),
        }
        for name, (replaces, source) in KERNELS.items()
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
