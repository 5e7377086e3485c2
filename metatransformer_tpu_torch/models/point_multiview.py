"""Multi-view point classifier: point cloud -> multi-view pseudo-images ->
frozen 2D encoder.

Port of ``metatransformer_tpu/models/point_multiview.py``: rotate the cloud
into up to 10 canonical camera poses, render each view to a 2D grid by
splatting kNN graph features over a 3x3 pixel footprint, conv the feature
image to 3 channels (sigmoid + ImageNet normalisation), and classify every
view with the ViT, fusing views by mean pooling. Views fold into the batch
axis. The renderer is fp32 under both policies; the path runs no
furthest-point sampling. At the default 224^2 image the encoder sees 197
tokens and, under BF16, the fused sublayers.

The splat is ``index_add_`` over a flattened (view, pixel) axis; on a CUDA
device its sum order, and so the last bits of the image, vary from run to
run.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from metatransformer_tpu_torch.core import device as _device
from metatransformer_tpu_torch.core import encoder as enc
from metatransformer_tpu_torch.heads import cls as cls_head
from metatransformer_tpu_torch.ops import point_ops
from metatransformer_tpu_torch.tokenizers import image as image_tok

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

_TRANS = -1.4
# the 10 canonical camera poses: (z, y, x) euler angles and a translation
VIEWS = np.array(
    [
        [[0 * np.pi / 2, 0, np.pi / 2], [0, 0, _TRANS]],
        [[1 * np.pi / 2, 0, np.pi / 2], [0, 0, _TRANS]],
        [[2 * np.pi / 2, 0, np.pi / 2], [0, 0, _TRANS]],
        [[3 * np.pi / 2, 0, np.pi / 2], [0, 0, _TRANS]],
        [[5 * np.pi / 4, -np.pi / 4, np.pi / 2], [0, 0, _TRANS]],
        [[5 * np.pi / 4, np.pi / 4, np.pi / 2], [0, 0, _TRANS]],
        [[7 * np.pi / 4, -np.pi / 4, np.pi / 2], [0, 0, _TRANS]],
        [[7 * np.pi / 4, np.pi / 4, np.pi / 2], [0, 0, _TRANS]],
        [[0, -np.pi / 2, np.pi / 2], [0, 0, _TRANS]],
        [[0, np.pi / 2, np.pi / 2], [0, 0, _TRANS]],
    ],
    np.float32,
)


def euler2mat(angles: torch.Tensor) -> torch.Tensor:
    """[V, 3] (z, y, x intrinsic) -> rotation matrices [V, 3, 3]."""
    z, y, x = angles[:, 0], angles[:, 1], angles[:, 2]
    cz, sz = torch.cos(z), torch.sin(z)
    cy, sy = torch.cos(y), torch.sin(y)
    cx, sx = torch.cos(x), torch.sin(x)
    ones, zeros = torch.ones_like(z), torch.zeros_like(z)
    rz = torch.stack([cz, -sz, zeros, sz, cz, zeros, zeros, zeros, ones], -1).reshape(-1, 3, 3)
    ry = torch.stack([cy, zeros, sy, zeros, ones, zeros, -sy, zeros, cy], -1).reshape(-1, 3, 3)
    rx = torch.stack([ones, zeros, zeros, zeros, cx, -sx, zeros, sx, cx], -1).reshape(-1, 3, 3)
    return rz @ ry @ rx


@dataclasses.dataclass(frozen=True)
class ProjEncConfig:
    local_size: int = 20  # kNN for graph features
    trans_dim: int = 32
    graph_dim: int = 32
    obj_size: int = 56  # splat grid
    img_size: int = 224


@dataclasses.dataclass(frozen=True)
class MultiViewConfig:
    num_views: int = 4
    proj: ProjEncConfig = ProjEncConfig()
    encoder: enc.EncoderConfig = enc.BASE
    patch_size: int = 16
    num_classes: int = 40

    @property
    def tokenizer(self) -> image_tok.ImageTokenizerConfig:
        return image_tok.ImageTokenizerConfig(
            self.proj.img_size, self.patch_size, 3, self.encoder.dim
        )

    @property
    def head(self) -> cls_head.ClsHeadConfig:
        return cls_head.ClsHeadConfig(in_dim=self.encoder.dim, num_classes=self.num_classes)


def init(
    cfg: MultiViewConfig,
    generator: torch.Generator,
    device: _device.Device = None,
) -> Dict[str, Any]:
    """Seeded random parameters (drawn on the CPU, then moved to ``device``;
    None: the card). Conv weights are HWIO."""
    device = _device.resolve(device)
    p = cfg.proj
    randn = lambda *shape: torch.randn(*shape, generator=generator)
    zeros = lambda n: torch.zeros(n, dtype=torch.float32, device=device)

    def conv(k, cin, cout):
        return {"w": (randn(k, k, cin, cout) * (2.0 / (k * k * cin)) ** 0.5).to(device),
                "b": zeros(cout)}

    return {
        "input_trans": {"w": (randn(3, p.trans_dim) * 3**-0.5).to(device),
                        "b": zeros(p.trans_dim)},
        "graph": {
            "w": (randn(2 * p.trans_dim, p.graph_dim) * (2 * p.trans_dim) ** -0.5).to(device),
            "gn_scale": torch.ones(p.graph_dim, dtype=torch.float32, device=device),
            "gn_bias": zeros(p.graph_dim),
        },
        "proj": {"w": (randn(p.graph_dim, p.graph_dim) * p.graph_dim**-0.5).to(device),
                 "b": zeros(p.graph_dim)},
        "block1": conv(3, p.graph_dim, p.graph_dim),
        "block2": conv(3, p.graph_dim, p.graph_dim),
        "block_out": conv(1, p.graph_dim, p.graph_dim),
        "img_layer": conv(1, p.graph_dim, 3),
        "tokenizer": image_tok.init(cfg.tokenizer, generator, device),
        "encoder": enc.init(cfg.encoder, generator, device),
        "cls_token": (randn(1, 1, cfg.encoder.dim) * 0.02).to(device),
        "pos_embed": (
            randn(1, cfg.tokenizer.num_patches + 1, cfg.encoder.dim) * 0.02).to(device),
        "head": cls_head.init(cfg.head, generator, device),
    }


def point_transform(points: torch.Tensor, num_views: int) -> torch.Tensor:
    """[B, N, 3] -> [B*V, N, 3]: each cloud rotated into every view pose
    (a cloud's views are consecutive)."""
    views = torch.tensor(VIEWS[:num_views], device=points.device)
    rot = euler2mat(views[:, 0]).transpose(1, 2)  # [V, 3, 3]
    trans = views[:, 1][:, None, :]  # [V, 1, 3]
    b = points.shape[0]
    pts = points.repeat_interleave(num_views, dim=0)  # [B*V, N, 3]
    return pts @ rot.repeat(b, 1, 1) - trans.repeat(b, 1, 1)


def _group_norm_points(x, scale, bias, groups=4, eps=1e-5):
    """GroupNorm over [B, N, k, C]: stats per (group-channels, N, k)."""
    b, n, k, c = x.shape
    g = min(groups, c)
    xg = x.reshape(b, n, k, g, c // g).float()
    var, mean = torch.var_mean(xg, dim=(1, 2, 4), keepdim=True, correction=0)
    xg = (xg - mean) * torch.rsqrt(var + eps)
    return (xg.reshape(b, n, k, c) * scale + bias).to(x.dtype)


def _conv2d(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Stride-1 SAME convolution of an NHWC image with an HWIO kernel."""
    k = p["w"].shape[0]
    out = F.conv2d(x.permute(0, 3, 1, 2), p["w"].permute(3, 2, 0, 1), p["b"], padding=k // 2)
    return out.permute(0, 2, 3, 1)


def proj_enc(
    params: Dict[str, Any],
    original_pc: torch.Tensor,  # [B*V, N, 3] (pre-rotation cloud, repeated)
    pc: torch.Tensor,  # [B*V, N, 3] view-rotated cloud
    cfg: ProjEncConfig,
) -> torch.Tensor:
    """Render -> images [B*V, img_size, img_size, 3], ImageNet-normalised.
    The convolutions are fp32: on a CUDA card keep
    ``torch.backends.cudnn.allow_tf32`` False."""
    bv, n, _ = pc.shape
    dev = pc.device

    # grid coordinates from the rotated cloud's xy extent
    lo = pc.amin(dim=1)  # [BV, 3]
    extent = pc.amax(dim=1) - lo
    grid = extent[:, :2].amax(dim=-1) / (cfg.obj_size - 3)  # [BV]
    idx_xy = torch.floor((pc[:, :, :2] - lo[:, None, :2]) / grid[:, None, None])
    offset = torch.tensor(
        [[-1, -1], [-1, 0], [-1, 1], [0, -1], [0, 0], [0, 1], [1, -1], [1, 0], [1, 1]],
        dtype=torch.float32, device=dev,
    )
    dense = (idx_xy[:, :, None, :] + offset[None, None]).reshape(bv, n * 9, 2) + 1
    center = torch.floor((dense.amax(dim=1) + dense.amin(dim=1)) / 2)
    dense = dense + (cfg.obj_size / 2 - center - 1)[:, None, :]

    # kNN graph features on the ORIGINAL cloud
    f = original_pc @ params["input_trans"]["w"] + params["input_trans"]["b"]
    _, idx = point_ops.knn(original_pc, original_pc, cfg.local_size)  # [BV, N, k]
    neigh = point_ops.gather_points(f, idx)  # [BV, N, k, td]
    center_f = f[:, :, None, :]
    feat = torch.cat([neigh - center_f, center_f.expand_as(neigh)], dim=-1)
    feat = feat @ params["graph"]["w"]
    feat = _group_norm_points(feat, params["graph"]["gn_scale"], params["graph"]["gn_bias"])
    feat = F.leaky_relu(feat, 0.2).amax(dim=2)  # [BV, N, gd]
    feat = feat @ params["proj"]["w"] + params["proj"]["b"]

    # scatter-add splat over the 3x3 footprint
    gd = feat.shape[-1]
    f9 = feat.repeat_interleave(9, dim=1)  # [BV, N*9, gd]
    ix = dense[..., 0].clamp(0, cfg.obj_size - 1).long()
    iy = dense[..., 1].clamp(0, cfg.obj_size - 1).long()
    pixels = cfg.obj_size * cfg.obj_size
    flat = ix * cfg.obj_size + iy + torch.arange(bv, device=dev)[:, None] * pixels
    img = torch.zeros(bv * pixels, gd, dtype=feat.dtype, device=dev)
    img = img.index_add(0, flat.reshape(-1), f9.reshape(-1, gd))
    img = img.reshape(bv, cfg.obj_size, cfg.obj_size, gd)

    # center-pad to img_size
    if cfg.obj_size < cfg.img_size:
        pad = (cfg.img_size - cfg.obj_size) // 2
        img = F.pad(img, (0, 0, pad, pad, pad, pad))

    # conv image block (BasicBlock + 1x1) -> 3 channels
    h = torch.relu(_conv2d(img, params["block1"]))
    h = torch.relu(_conv2d(h, params["block2"]) + img)  # residual
    h = _conv2d(h, params["block_out"])
    rgb = torch.sigmoid(_conv2d(h, params["img_layer"]))
    mean, std = (torch.tensor(a, device=dev) for a in (IMAGENET_MEAN, IMAGENET_STD))
    return (rgb - mean) / std


def forward(
    params: Dict[str, Any],
    points: torch.Tensor,  # [B, N, 3]
    cfg: MultiViewConfig,
    precision: enc.Precision = enc.FP32,
) -> torch.Tensor:
    """points -> logits [B, num_classes]: render num_views pseudo-images,
    encode all with the ViT (views folded into the batch), mean-fuse the
    per-view cls features, classify."""
    b, v = points.shape[0], cfg.num_views
    pc = point_transform(points, v)  # [B*V, N, 3]
    original = points.repeat_interleave(v, dim=0)
    images = proj_enc(params, original, pc, cfg.proj)

    tokens = image_tok.apply(params["tokenizer"], images, cfg.tokenizer)
    cls_tok = params["cls_token"].expand(tokens.shape[0], 1, tokens.shape[-1])
    x = torch.cat([cls_tok, tokens], dim=1) + params["pos_embed"]
    x = enc.encode(params["encoder"], x, cfg.encoder, precision=precision)
    feats = x[:, 0].reshape(b, v, -1).mean(dim=1)  # mean view fusion
    return cls_head.apply(params["head"], feats, cfg.head)
