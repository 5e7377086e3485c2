"""ViT-Adapter backbone: ViT blocks + spatial prior + deformable interaction.

Port of ``metatransformer_tpu/models/vit_adapter.py``: a SpatialPriorModule
conv stem giving a 4-scale pyramid, Injector (pyramid -> ViT tokens, cross
deformable attention with a zero-init gamma) and Extractor (ViT tokens ->
pyramid, plus a depthwise ConvFFN) around slices of the ViT blocks; outputs
f1 ... f4 at 1/4, 1/8, 1/16, 1/32 with the ViT feature added back. Feature
maps are NHWC and conv weights HWIO, as in the reference; they are permuted
at the call.

Three helpers keep XLA's semantics, which plain torch calls do not:

* :func:`conv2d` pads as XLA's ``"SAME"``: the total pad is
  ``max((out - 1) * stride + k - in, 0)``, the lower side gets half of it
  rounded down, so a stride-2 conv on an even input pads (0, 1);
* the stem's max-pool is ``reduce_window`` ``"SAME"``: the same pads, with
  -inf;
* :func:`resize` is ``jax.image.resize``, which antialiases when it
  downsamples and whose bicubic is Keys' a = -0.5: ``F.interpolate`` with
  ``antialias=True``, always.

The ViT blocks run through :func:`..core.encoder.block` (``"timm"``) or
:mod:`..core.beit` (``"beit"``, ``"uniperceiver"``) on the fp32 token
stream, as the reference's do: each casts to the compute dtype of the
precision policy inside, and a block that resolves to the fused sublayers
(windowed blocks under BF16) takes the stream in bf16 and hands it back
widened. Everything else runs in fp32 at full precision, as the
reference's ``Precision.HIGHEST``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from metatransformer_tpu_torch.core import device as _device
from metatransformer_tpu_torch.core import encoder as enc
from metatransformer_tpu_torch.core.tree import tree_map
from metatransformer_tpu_torch.ops import ms_deform_attn as msda


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x_nchw: torch.Tensor, k: int, stride: int, value: float = 0.0) -> torch.Tensor:
    top, bottom = _same_pads(x_nchw.shape[2], k, stride)
    left, right = _same_pads(x_nchw.shape[3], k, stride)
    if top or bottom or left or right:
        x_nchw = F.pad(x_nchw, (left, right, top, bottom), value=value)
    return x_nchw


def conv2d(x, w, b=None, stride=1, groups=1):
    """NHWC ``x``, HWIO ``w`` -> NHWC, XLA "SAME" padding."""
    k = w.shape[0]
    xc = _pad_same(x.permute(0, 3, 1, 2), k, stride)
    out = F.conv2d(xc, w.permute(3, 2, 0, 1), b, stride=stride, groups=groups)
    return out.permute(0, 2, 3, 1)


def max_pool_same(x, k: int = 3, stride: int = 2):
    """NHWC max-pool, XLA ``reduce_window`` "SAME" (-inf padding)."""
    xc = _pad_same(x.permute(0, 3, 1, 2), k, stride, value=float("-inf"))
    return F.max_pool2d(xc, k, stride).permute(0, 2, 3, 1)


def group_norm(x, scale, bias, groups=32, eps=1e-5):
    b, h, w, c = x.shape
    g = min(groups, c)
    xg = x.reshape(b, h, w, g, c // g).to(torch.promote_types(x.dtype, torch.float32))
    var, mean = torch.var_mean(xg, dim=(1, 2, 4), keepdim=True, correction=0)
    xg = (xg - mean) * torch.rsqrt(var + eps)
    return (xg.reshape(b, h, w, c) * scale + bias).to(x.dtype)


def resize(x, hw, method: str = "bilinear"):
    """NHWC ``jax.image.resize`` to ``hw`` (half-pixel centres; antialiased
    when it downsamples; bicubic with a = -0.5). Its ``"nearest"`` takes the
    input pixel under each output pixel's centre, which is torch's
    ``"nearest-exact"`` (torch's ``"nearest"`` floors the scaled corner)."""
    if method == "nearest":
        out = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(hw), mode="nearest-exact")
    else:
        out = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(hw), mode=method,
                            align_corners=False, antialias=True)
    return out.permute(0, 2, 3, 1)


@dataclasses.dataclass(frozen=True)
class ViTAdapterConfig:
    encoder: enc.EncoderConfig = enc.BASE
    img_size: int = 512
    patch_size: int = 16
    conv_inplane: int = 64
    deform_num_heads: int = 12
    n_points: int = 4
    deform_ratio: float = 0.5
    interaction_indexes: Tuple[Tuple[int, int], ...] = (
        (0, 2), (3, 5), (6, 8), (9, 11),
    )
    add_vit_feature: bool = True
    # "timm": the Meta-Transformer blocks; "beit": BEiT blocks with per-layer
    # rel-pos bias + LayerScale; "uniperceiver": BertLayer blocks, LayerScale
    # (zero-init), full qkv bias, no rel-pos bias
    block_type: str = "timm"
    layerscale_init: float = 0.1
    # per-block window-attention flags; None = all global
    window_attn: Optional[Tuple[bool, ...]] = None
    window_size: int = 14

    def beit_cfg(self, window: Tuple[int, int]):
        from metatransformer_tpu_torch.core import beit as beit_mod

        e = self.encoder
        return beit_mod.BEiTConfig(
            dim=e.dim, depth=e.depth, num_heads=e.num_heads,
            mlp_ratio=e.mlp_ratio, window=window, init_values=self.layerscale_init,
        )

    @property
    def injector_cfg(self) -> msda.MSDeformAttnConfig:
        return msda.MSDeformAttnConfig(
            dim=self.encoder.dim, num_heads=self.deform_num_heads,
            num_levels=3, num_points=self.n_points, ratio=self.deform_ratio,
        )

    @property
    def extractor_cfg(self) -> msda.MSDeformAttnConfig:
        return msda.MSDeformAttnConfig(
            dim=self.encoder.dim, num_heads=self.deform_num_heads,
            num_levels=1, num_points=self.n_points, ratio=self.deform_ratio,
        )


def _conv_block_init(randn, cin, cout, k=3):
    return {
        "w": randn(k, k, cin, cout) * np.sqrt(2.0 / (k * k * cin)),
        "b": torch.zeros(cout),
        "gn_scale": torch.ones(cout),
        "gn_bias": torch.zeros(cout),
    }


def _spm_init(cfg: ViTAdapterConfig, randn) -> Dict[str, Any]:
    c, d = cfg.conv_inplane, cfg.encoder.dim
    params = {
        "stem1": _conv_block_init(randn, 3, c),
        "stem2": _conv_block_init(randn, c, c),
        "stem3": _conv_block_init(randn, c, c),
        "conv2": _conv_block_init(randn, c, 2 * c),
        "conv3": _conv_block_init(randn, 2 * c, 4 * c),
        "conv4": _conv_block_init(randn, 4 * c, 4 * c),
    }
    for i, cin in zip((1, 2, 3, 4), (c, 2 * c, 4 * c, 4 * c)):
        params[f"fc{i}"] = {"w": randn(1, 1, cin, d) * cin**-0.5, "b": torch.zeros(d)}
    return params


def _cb(x, p, stride=1):
    x = conv2d(x, p["w"], p["b"], stride=stride)
    return torch.relu(group_norm(x, p["gn_scale"], p["gn_bias"]))


def _spm_apply(params, images):
    """images [B, H, W, 3] -> c1 (1/4), c2 (1/8), c3 (1/16), c4 (1/32)."""
    x = _cb(images, params["stem1"], stride=2)
    x = _cb(x, params["stem2"])
    x = _cb(x, params["stem3"])
    c1 = max_pool_same(x)
    c2 = _cb(c1, params["conv2"], stride=2)
    c3 = _cb(c2, params["conv3"], stride=2)
    c4 = _cb(c3, params["conv4"], stride=2)
    outs = []
    for i, c in enumerate((c1, c2, c3, c4), 1):
        outs.append(conv2d(c, params[f"fc{i}"]["w"], params[f"fc{i}"]["b"]))
    return outs


def _ref_points(shapes: Sequence[Tuple[int, int]]) -> np.ndarray:
    """Normalized pixel-centre reference points of the given level grids,
    concatenated: [1, sum(H*W), 2] (x, y)."""
    pts = []
    for h, w in shapes:
        yy, xx = np.meshgrid((np.arange(h) + 0.5) / h, (np.arange(w) + 0.5) / w, indexing="ij")
        pts.append(np.stack([xx, yy], -1).reshape(-1, 2))
    return np.concatenate(pts, 0)[None].astype(np.float32)


def _ln(x, p, name, eps=1e-6):
    return enc.layer_norm(x, p[f"{name}_scale"], p[f"{name}_bias"], eps)


def _interaction_init(cfg: ViTAdapterConfig, generator) -> Dict[str, Any]:
    d = cfg.encoder.dim
    hidden = d // 4
    randn = lambda *s: torch.randn(*s, generator=generator)  # noqa: E731
    ones, zeros = torch.ones(d), torch.zeros(d)
    return {
        # Injector
        "inj_query_norm_scale": ones.clone(), "inj_query_norm_bias": zeros.clone(),
        "inj_feat_norm_scale": ones.clone(), "inj_feat_norm_bias": zeros.clone(),
        "inj_attn": msda.init(cfg.injector_cfg, generator, "cpu"),
        "inj_gamma": zeros.clone(),  # zero-init residual gate
        # Extractor
        "ext_query_norm_scale": ones.clone(), "ext_query_norm_bias": zeros.clone(),
        "ext_feat_norm_scale": ones.clone(), "ext_feat_norm_bias": zeros.clone(),
        "ext_attn": msda.init(cfg.extractor_cfg, generator, "cpu"),
        # ConvFFN (fc1 -> DWConv3x3 -> GELU -> fc2) on the pyramid tokens
        "ffn_norm_scale": ones.clone(), "ffn_norm_bias": zeros.clone(),
        "ffn_fc1_w": randn(d, hidden) * d**-0.5,
        "ffn_fc1_b": torch.zeros(hidden),
        "ffn_dw_w": randn(3, 3, 1, hidden) * np.sqrt(2.0 / 9),
        "ffn_dw_b": torch.zeros(hidden),
        "ffn_fc2_w": randn(hidden, d) * hidden**-0.5,
        "ffn_fc2_b": zeros.clone(),
    }


def _to(tree, device):
    """A tree of tensors, moved to ``device``."""
    return tree_map(lambda t: t.to(device), tree)


def init(
    cfg: ViTAdapterConfig, generator: torch.Generator, device: _device.Device = None
) -> Dict[str, Any]:
    """Seeded random parameters in the reference's tree (drawn on the CPU,
    then moved to ``device``; None: the card)."""
    device = _device.resolve(device)
    d = cfg.encoder.dim
    grid = cfg.img_size // cfg.patch_size
    randn = lambda *s: torch.randn(*s, generator=generator)  # noqa: E731
    if cfg.block_type in ("beit", "uniperceiver"):
        from metatransformer_tpu_torch.core import beit as beit_mod

        enc_params = beit_mod.init(cfg.beit_cfg((grid, grid)), generator, "cpu")
        if cfg.block_type == "uniperceiver":
            del enc_params["rel_pos_table"]  # BertLayer has no rel-pos bias
            enc_params["k_bias"] = torch.zeros(cfg.encoder.depth, d)
            # UniPerceiver initialises LayerScale at zero
            enc_params["gamma_1"] = torch.zeros_like(enc_params["gamma_1"])
            enc_params["gamma_2"] = torch.zeros_like(enc_params["gamma_2"])
    else:
        enc_params = enc.init(cfg.encoder, generator, "cpu")
    pd = cfg.patch_size * cfg.patch_size * 3
    params: Dict[str, Any] = {
        "encoder": enc_params,
        "patch_w": randn(pd, d) * pd**-0.5,
        "patch_b": torch.zeros(d),
        "pos_embed": randn(1, grid * grid, d) * 0.02,
        "spm": _spm_init(cfg, randn),
        "level_embed": randn(3, d) * 0.02,
    }
    for i in range(len(cfg.interaction_indexes)):
        params[f"interaction{i}"] = _interaction_init(cfg, generator)
    return _to(params, device)


def _slice_flags(cfg: ViTAdapterConfig) -> List[Optional[Tuple[bool, ...]]]:
    """Each interaction slice's window flags (None: all global)."""
    if cfg.window_attn is None:
        return [None] * len(cfg.interaction_indexes)
    return [tuple(cfg.window_attn[lo: hi + 1]) for lo, hi in cfg.interaction_indexes]


def apply(
    params: Dict[str, Any],
    images: torch.Tensor,  # [B, H, W, 3]
    cfg: ViTAdapterConfig,
    precision: enc.Precision = enc.FP32,
) -> List[torch.Tensor]:
    """-> [f1, f2, f3, f4] NHWC feature maps at 1/4, 1/8, 1/16, 1/32."""
    from metatransformer_tpu_torch.tokenizers import image as image_tok

    b, H, W, _ = images.shape
    d = cfg.encoder.dim
    gh, gw = H // cfg.patch_size, W // cfg.patch_size
    dev = images.device

    # spatial prior pyramid
    c1, c2, c3, c4 = _spm_apply(params["spm"], images)
    shapes_c = [tuple(c.shape[1:3]) for c in (c2, c3, c4)]
    lvl = params["level_embed"]
    c_tokens = torch.cat(
        [c.reshape(b, -1, d) + lvl[i] for i, c in enumerate((c2, c3, c4))], dim=1)

    # ViT patch tokens
    x = image_tok.patchify(images, cfg.patch_size) @ params["patch_w"] + params["patch_b"]
    pos = params["pos_embed"]
    if pos.shape[1] != gh * gw:  # bicubic pos-embed resize
        g0 = int(np.sqrt(pos.shape[1]))
        pos = resize(pos.reshape(1, g0, g0, d), (gh, gw), "bicubic").reshape(1, -1, d)
    x = x + pos

    refp_x3 = torch.from_numpy(_ref_points([(gh, gw)])).to(dev)[:, :, None, :].expand(b, -1, 3, -1)
    refp_c1 = torch.from_numpy(_ref_points(shapes_c)).to(dev)[:, :, None, :].expand(b, -1, 1, -1)

    if cfg.block_type in ("beit", "uniperceiver"):
        from metatransformer_tpu_torch.core import beit as beit_mod

        bcfg = cfg.beit_cfg((gh, gw))
        rel_idx = rel_idx_win = None
        if cfg.block_type == "beit":
            # adapter tokens carry no cls: drop the table's cls row and column
            rel_idx = torch.from_numpy(beit_mod.relative_position_index((gh, gw))[1:, 1:]).to(dev)
            rel_idx_win = torch.from_numpy(
                beit_mod.windowed_relative_position_index((gh, gw), cfg.window_size)).to(dev)

        def blk(h, lp, windowed=False):
            return beit_mod.block(h, lp, bcfg, rel_idx_win if windowed else rel_idx, precision)
    else:
        def blk(h, lp, windowed=False):
            if enc._resolve_impl(cfg.encoder, h.shape[1], precision) != "fused":
                return enc.block(h, lp, cfg.encoder, None, precision)
            # the fused kernels take the stream in the compute dtype
            cd = precision.compute_dtype
            return enc.block(h.to(cd), lp, cfg.encoder, None, precision).to(h.dtype)

    def vit_slice(x, enc_layers, win_flags):
        """The slice's blocks on the fp32 stream, as the reference runs them
        (each casts to the compute dtype inside), windowed where
        ``win_flags`` says so."""
        from metatransformer_tpu_torch.ops import window_attention as win

        if cfg.block_type == "timm":
            enc_layers = enc.cast_params(enc_layers, precision)
        layers = {k: v.unbind(0) for k, v in enc_layers.items()}
        n = next(iter(enc_layers.values())).shape[0]
        for j in range(n):
            lp = {k: v[j] for k, v in layers.items()}
            if win_flags is not None and win_flags[j]:
                x = win.windowed_block(x, lambda h, lp=lp: blk(h, lp, True), gh, gw,
                                       cfg.window_size)
            else:
                x = blk(x, lp)
        return x

    def interaction_step(x, c_tokens, ip, enc_layers, win_flags):
        # Injector: ViT tokens attend the spatial pyramid
        q = _ln(x, ip, "inj_query_norm")
        v = _ln(c_tokens, ip, "inj_feat_norm")
        x = x + ip["inj_gamma"] * msda.apply(
            ip["inj_attn"], q, refp_x3, v, shapes_c, cfg.injector_cfg)
        x = vit_slice(x, enc_layers, win_flags)
        # Extractor: pyramid tokens attend ViT tokens
        q = _ln(c_tokens, ip, "ext_query_norm")
        v = _ln(x, ip, "ext_feat_norm")
        c_tokens = c_tokens + msda.apply(
            ip["ext_attn"], q, refp_c1, v, [(gh, gw)], cfg.extractor_cfg)
        # ConvFFN with a depthwise conv per pyramid level
        hffn = _ln(c_tokens, ip, "ffn_norm") @ ip["ffn_fc1_w"] + ip["ffn_fc1_b"]
        parts, off = [], 0
        for hs, ws in shapes_c:
            seg = hffn[:, off: off + hs * ws].reshape(b, hs, ws, -1)
            seg = conv2d(seg, ip["ffn_dw_w"], ip["ffn_dw_b"], groups=seg.shape[-1])
            parts.append(seg.reshape(b, hs * ws, -1))
            off += hs * ws
        hffn = F.gelu(torch.cat(parts, 1))
        hffn = hffn @ ip["ffn_fc2_w"] + ip["ffn_fc2_b"]
        return x, c_tokens + hffn

    # The reference scans one interaction body over stacked interactions
    # when the slices are uniform, to compile it once; eager torch has no
    # compile to save, so every configuration takes the per-slice loop.
    slice_flags = _slice_flags(cfg)
    for i, (lo, hi) in enumerate(cfg.interaction_indexes):
        enc_layers = {k: v[lo: hi + 1] for k, v in params["encoder"].items()}
        x, c_tokens = interaction_step(
            x, c_tokens, params[f"interaction{i}"], enc_layers, slice_flags[i])

    # split the pyramid back into maps
    n2 = shapes_c[0][0] * shapes_c[0][1]
    n3 = n2 + shapes_c[1][0] * shapes_c[1][1]
    f2 = c_tokens[:, :n2].reshape(b, *shapes_c[0], d)
    f3 = c_tokens[:, n2:n3].reshape(b, *shapes_c[1], d)
    f4 = c_tokens[:, n3:].reshape(b, *shapes_c[2], d)
    f1 = c1 + resize(f2, c1.shape[1:3])

    if cfg.add_vit_feature:
        xmap = x.reshape(b, gh, gw, d)
        f1 = f1 + resize(xmap, f1.shape[1:3])
        f2 = f2 + resize(xmap, f2.shape[1:3])
        f3 = f3 + (xmap if tuple(f3.shape[1:3]) == (gh, gw) else resize(xmap, f3.shape[1:3]))
        f4 = f4 + resize(xmap, f4.shape[1:3])
    return [f1, f2, f3, f4]
