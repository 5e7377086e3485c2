"""Mask2Former head with the multi-scale MSDeformAttn pixel decoder.

Port of ``metatransformer_tpu/heads/mask2former.py``: a deformable encoder
over the three low-resolution pyramid levels and an FPN fuse to stride 4
(the pixel decoder), a masked-attention transformer decoder cycling over
those levels with class and mask heads after every layer, and the
point-sampled, Hungarian-matched losses of every layer. NHWC maps, HWIO
conv weights, ``[in, out]`` linear weights; the decoder layers are a list of
dicts, as in the reference's tree.

The linear-sum assignment runs on the host, as the reference's
``jax.pure_callback`` does: one device-to-host copy of the [B, Q, G] cost a
layer, then scipy. Random points come from a ``torch.Generator`` on the
parameters' device; :func:`loss` also takes them drawn elsewhere
(``draws``), which is how the tests pass JAX's draws in.

``mm`` is the port's matmul precision convention
(:func:`..core.encoder.linear_at`, :func:`..core.encoder.matmul_at`).
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
from metatransformer_tpu_torch.models.vit_adapter import _to, conv2d, group_norm, resize
from metatransformer_tpu_torch.ops import ms_deform_attn as msda
from metatransformer_tpu_torch.ops.ms_deform_attn import bilinear_sample

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Sine positional encoding (mmcv SinePositionalEncoding, normalize=True)
# ---------------------------------------------------------------------------


def sine_positional_encoding(h: int, w: int, num_feats: int = 128,
                             temperature: float = 10000.0,
                             device: _device.Device = "cpu") -> torch.Tensor:
    """-> [H, W, 2*num_feats]; mmcv's normalize=True, scale 2 pi."""
    eps, scale = 1e-6, 2.0 * np.pi
    f32 = dict(dtype=torch.float32, device=device)
    y = (torch.arange(1, h + 1, **f32) / (h + eps) * scale)[:, None]
    x = (torch.arange(1, w + 1, **f32) / (w + eps) * scale)[None, :]
    dim_t = temperature ** (2.0 * torch.div(torch.arange(num_feats, **f32), 2,
                                            rounding_mode="floor") / num_feats)
    pos_x = x[:, :, None] * torch.ones(h, w, 1, **f32) / dim_t
    pos_y = y[:, :, None] * torch.ones(h, w, 1, **f32) / dim_t
    pos_x = torch.stack([pos_x[..., 0::2].sin(), pos_x[..., 1::2].cos()], -1).reshape(
        h, w, num_feats)
    pos_y = torch.stack([pos_y[..., 0::2].sin(), pos_y[..., 1::2].cos()], -1).reshape(
        h, w, num_feats)
    return torch.cat([pos_y, pos_x], -1)


# ---------------------------------------------------------------------------
# MSDeformAttn pixel decoder
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PixelDecoderConfig:
    in_channels: Tuple[int, ...] = (768, 768, 768, 768)  # ViT-Adapter c1 ... c4
    strides: Tuple[int, ...] = (4, 8, 16, 32)
    feat_channels: int = 256
    out_channels: int = 256
    num_encoder_layers: int = 6
    num_encoder_levels: int = 3
    num_heads: int = 8
    num_points: int = 4
    ffn_dim: int = 1024

    @property
    def msda(self) -> msda.MSDeformAttnConfig:
        return msda.MSDeformAttnConfig(
            dim=self.feat_channels, num_heads=self.num_heads,
            num_levels=self.num_encoder_levels, num_points=self.num_points, ratio=1.0,
        )


def _linear_init(randn, cin, cout):
    return {"w": randn(cin, cout) * cin**-0.5, "b": torch.zeros(cout)}


def _enc_layer_init(cfg: PixelDecoderConfig, generator, randn) -> Params:
    c = cfg.feat_channels
    return {
        "msda": msda.init(cfg.msda, generator, "cpu"),
        "ln1_scale": torch.ones(c), "ln1_bias": torch.zeros(c),
        "ffn1": _linear_init(randn, c, cfg.ffn_dim),
        "ffn2": _linear_init(randn, cfg.ffn_dim, c),
        "ln2_scale": torch.ones(c), "ln2_bias": torch.zeros(c),
    }


def pixel_decoder_init(cfg: PixelDecoderConfig, generator: torch.Generator) -> Params:
    """On the CPU; :func:`init` moves the whole head."""
    randn = lambda *s: torch.randn(*s, generator=generator)  # noqa: E731
    nl, c = cfg.num_encoder_levels, cfg.feat_channels
    n_fpn = len(cfg.in_channels) - nl
    params: Params = {"level_embed": randn(nl, c)}
    # input 1x1 convs + GN on the nl lowest-resolution levels (top-down)
    for i in range(nl):
        cin = cfg.in_channels[len(cfg.in_channels) - 1 - i]
        params[f"input{i}"] = {
            "w": randn(1, 1, cin, c) * cin**-0.5, "b": torch.zeros(c),
            "gn_scale": torch.ones(c), "gn_bias": torch.zeros(c),
        }
    params["encoder"] = tree_map(lambda *ls: torch.stack(ls),
                                 *[_enc_layer_init(cfg, generator, randn)
                                   for _ in range(cfg.num_encoder_layers)])
    # FPN for the remaining high-resolution levels
    for i in range(n_fpn):
        cin = cfg.in_channels[n_fpn - 1 - i]
        params[f"lateral{i}"] = {
            "w": randn(1, 1, cin, c) * cin**-0.5,
            "gn_scale": torch.ones(c), "gn_bias": torch.zeros(c),
        }
        params[f"output{i}"] = {
            "w": randn(3, 3, c, c) * (9 * c) ** -0.5,
            "gn_scale": torch.ones(c), "gn_bias": torch.zeros(c),
        }
    params["mask_feature"] = {"w": randn(1, 1, c, cfg.out_channels) * c**-0.5,
                              "b": torch.zeros(cfg.out_channels)}
    return params


def _layer_norm(x, scale, bias):
    return enc.layer_norm(x, scale, bias, 1e-5)


def _lin(x, p, mm):
    return enc.linear_at(x, p["w"], p["b"], mm)


def _ref_points(h: int, w: int, device) -> torch.Tensor:
    """Normalized pixel-centre reference points [H*W, 2] (x, y)."""
    ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
    xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
    return torch.stack(torch.meshgrid(xs, ys, indexing="xy"), -1).reshape(-1, 2)


def pixel_decoder_apply(
    params: Params,
    feats: Sequence[torch.Tensor],  # NHWC, high-res -> low-res (c1 ... c4)
    cfg: PixelDecoderConfig,
    mm: str = "highest",
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """-> (mask_feature [B, H/4, W/4, out_c], the nl encoder levels NHWC,
    low-res -> high-res)."""
    b = feats[0].shape[0]
    dev = feats[0].device
    nl, c = cfg.num_encoder_levels, cfg.feat_channels
    n_in = len(feats)

    tokens, poss, shapes, refs = [], [], [], []
    for i in range(nl):  # top-down: lowest resolution first
        feat = feats[n_in - 1 - i]
        h, w = feat.shape[1], feat.shape[2]
        p = params[f"input{i}"]
        proj = group_norm(conv2d(feat, p["w"], p["b"]), p["gn_scale"], p["gn_bias"])
        pos = sine_positional_encoding(h, w, c // 2, device=dev) + params["level_embed"][i]
        tokens.append(proj.reshape(b, h * w, -1))
        poss.append(pos.reshape(1, h * w, c).expand(b, -1, -1))
        shapes.append((h, w))
        refs.append(_ref_points(h, w, dev))

    x = torch.cat(tokens, 1)  # [B, S, C]
    pos = torch.cat(poss, 1)
    ref = torch.cat(refs, 0)
    ref = ref[None, :, None, :].expand(b, -1, nl, -1)

    for i in range(params["encoder"]["ln1_scale"].shape[0]):
        lp = tree_map(lambda v: v[i], params["encoder"])
        attn = msda.apply(lp["msda"], x + pos, ref, x, shapes, cfg.msda, mm)
        h1 = _layer_norm(x + attn, lp["ln1_scale"], lp["ln1_bias"])
        f = _lin(torch.relu(_lin(h1, lp["ffn1"], mm)), lp["ffn2"], mm)
        x = _layer_norm(h1 + f, lp["ln2_scale"], lp["ln2_bias"])

    # split back into level maps (low-res -> high-res)
    outs, off = [], 0
    for h, w in shapes:
        outs.append(x[:, off: off + h * w].reshape(b, h, w, -1))
        off += h * w

    # FPN fuse toward stride 4
    n_fpn = n_in - nl
    for i in range(n_fpn):
        feat = feats[n_fpn - 1 - i]
        p = params[f"lateral{i}"]
        lat = group_norm(conv2d(feat, p["w"]), p["gn_scale"], p["gn_bias"])
        y = lat + resize(outs[-1], feat.shape[1:3])
        po = params[f"output{i}"]
        outs.append(torch.relu(group_norm(conv2d(y, po["w"]), po["gn_scale"], po["gn_bias"])))

    mp = params["mask_feature"]
    return conv2d(outs[-1], mp["w"], mp["b"]), outs[:nl]


# ---------------------------------------------------------------------------
# Mask2Former head
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Mask2FormerConfig:
    num_classes: int = 150  # ADE20K
    num_queries: int = 100
    feat_channels: int = 256
    out_channels: int = 256
    num_decoder_layers: int = 9
    num_heads: int = 8
    ffn_dim: int = 2048
    num_points: int = 12544  # point-sampled losses (train_cfg.num_points)
    oversample_ratio: float = 3.0
    importance_sample_ratio: float = 0.75
    cls_weight: float = 2.0
    mask_weight: float = 5.0
    dice_weight: float = 5.0
    no_object_weight: float = 0.1
    pixel_decoder: PixelDecoderConfig = PixelDecoderConfig()


def _mha_init(randn, c):
    return {k: _linear_init(randn, c, c) for k in ("q", "k", "v", "o")}


def _dec_layer_init(cfg: Mask2FormerConfig, randn) -> Params:
    c = cfg.feat_channels
    return {
        "cross": _mha_init(randn, c),
        "ln1_scale": torch.ones(c), "ln1_bias": torch.zeros(c),
        "self": _mha_init(randn, c),
        "ln2_scale": torch.ones(c), "ln2_bias": torch.zeros(c),
        "ffn1": _linear_init(randn, c, cfg.ffn_dim),
        "ffn2": _linear_init(randn, cfg.ffn_dim, c),
        "ln3_scale": torch.ones(c), "ln3_bias": torch.zeros(c),
    }


def init(cfg: Mask2FormerConfig, generator: torch.Generator,
         device: _device.Device = None) -> Params:
    """Seeded random parameters in the reference's tree (drawn on the CPU,
    then moved to ``device``; None: the card)."""
    device = _device.resolve(device)
    randn = lambda *s: torch.randn(*s, generator=generator)  # noqa: E731
    c, nl = cfg.feat_channels, cfg.pixel_decoder.num_encoder_levels
    params: Params = {
        "pixel_decoder": pixel_decoder_init(cfg.pixel_decoder, generator),
        "query_feat": randn(cfg.num_queries, c) * 0.02,
        "query_embed": randn(cfg.num_queries, c) * 0.02,
        "level_embed": randn(nl, c) * 0.02,
        "layers": [_dec_layer_init(cfg, randn) for _ in range(cfg.num_decoder_layers)],
        "post_norm_scale": torch.ones(c), "post_norm_bias": torch.zeros(c),
        "cls": _linear_init(randn, c, cfg.num_classes + 1),
        "mask1": _linear_init(randn, c, c),
        "mask2": _linear_init(randn, c, c),
        "mask3": _linear_init(randn, c, cfg.out_channels),
    }
    return _to(params, device)


def _mha(p, q, k, v, num_heads, mm, attn_mask=None):
    """attn_mask: [B, Q, S] bool, True = do not attend."""
    b, nq, c = q.shape
    hd = c // num_heads
    qh = _lin(q, p["q"], mm).reshape(b, nq, num_heads, hd).transpose(1, 2)
    kh = _lin(k, p["k"], mm).reshape(b, -1, num_heads, hd).transpose(1, 2)
    vh = _lin(v, p["v"], mm).reshape(b, -1, num_heads, hd).transpose(1, 2)
    logits = enc.matmul_at(qh, kh.mT, mm) * hd**-0.5  # [B, H, Q, S]
    if attn_mask is not None:
        logits = logits.masked_fill(attn_mask[:, None], torch.finfo(torch.float32).min)
    probs = torch.softmax(logits.float(), -1).to(vh.dtype)
    o = enc.matmul_at(probs, vh, mm).transpose(1, 2).reshape(b, nq, c)
    return _lin(o, p["o"], mm)


def attention_mask(mask: torch.Tensor, target_hw: Tuple[int, int]) -> torch.Tensor:
    """Mask logits [B, Q, h, w] -> [B, Q, Ht*Wt] bool, True where a query
    may not attend: ``sigmoid < 0.5`` of the logits resized to the next
    level; a query masked everywhere attends everywhere instead (the
    reference's rescue, mask2former_head.py:502-503)."""
    b, q = mask.shape[:2]
    am = F.interpolate(mask.detach(), size=tuple(target_hw), mode="bilinear",
                       align_corners=False, antialias=True)
    am = (torch.sigmoid(am) < 0.5).reshape(b, q, -1)
    return am & ~am.all(-1, keepdim=True)


def _forward_head(params, query, mask_feature, target_hw, mm):
    """-> (cls [B, Q, C+1], mask [B, Q, h4, w4], attn_mask [B, Q, Ht*Wt])."""
    q = _layer_norm(query, params["post_norm_scale"], params["post_norm_bias"])
    cls = _lin(q, params["cls"], mm)
    e = torch.relu(_lin(q, params["mask1"], mm))
    e = torch.relu(_lin(e, params["mask2"], mm))
    e = _lin(e, params["mask3"], mm)
    b, h, w, c = mask_feature.shape
    mask = enc.matmul_at(e, mask_feature.reshape(b, h * w, c).mT, mm).reshape(b, -1, h, w)
    return cls, mask, attention_mask(mask, target_hw)


def apply(
    params: Params,
    feats: Sequence[torch.Tensor],  # NHWC c1 ... c4 (high-res -> low-res)
    cfg: Mask2FormerConfig,
    mm: str = "highest",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (all_cls [L+1, B, Q, C+1], all_masks [L+1, B, Q, H/4, W/4]): one
    prediction before the decoder and one after each of its layers."""
    b = feats[0].shape[0]
    dev = feats[0].device
    nl, c = cfg.pixel_decoder.num_encoder_levels, cfg.feat_channels
    mask_feature, ms_feats = pixel_decoder_apply(params["pixel_decoder"], feats,
                                                 cfg.pixel_decoder, mm)
    keys, poss, shapes = [], [], []
    for i, f in enumerate(ms_feats):  # low-res -> high-res
        h, w = f.shape[1], f.shape[2]
        keys.append(f.reshape(b, h * w, -1) + params["level_embed"][i])
        pe = sine_positional_encoding(h, w, c // 2, device=dev).reshape(1, h * w, -1)
        poss.append(pe.expand(b, -1, -1))
        shapes.append((h, w))

    query = params["query_feat"][None].expand(b, -1, -1)
    query_pos = params["query_embed"][None].expand(b, -1, -1)

    cls, mask, am = _forward_head(params, query, mask_feature, shapes[0], mm)
    all_cls, all_masks = [cls], [mask]
    for i, lp in enumerate(params["layers"]):
        li = i % nl
        # masked cross-attention (query + pos against key + key pos)
        x = _mha(lp["cross"], query + query_pos, keys[li] + poss[li], keys[li],
                 cfg.num_heads, mm, attn_mask=am)
        query = _layer_norm(query + x, lp["ln1_scale"], lp["ln1_bias"])
        # self-attention among the queries
        x = _mha(lp["self"], query + query_pos, query + query_pos, query, cfg.num_heads, mm)
        query = _layer_norm(query + x, lp["ln2_scale"], lp["ln2_bias"])
        f = _lin(torch.relu(_lin(query, lp["ffn1"], mm)), lp["ffn2"], mm)
        query = _layer_norm(query + f, lp["ln3_scale"], lp["ln3_bias"])
        cls, mask, am = _forward_head(params, query, mask_feature, shapes[(i + 1) % nl], mm)
        all_cls.append(cls)
        all_masks.append(mask)
    return torch.stack(all_cls), torch.stack(all_masks)


def semantic_inference(cls_logits: torch.Tensor, mask_logits: torch.Tensor) -> torch.Tensor:
    """[B, Q, C+1], [B, Q, h, w] -> [B, h, w, C] per-pixel semantic logits."""
    probs = torch.softmax(cls_logits, -1)[..., :-1]
    return torch.einsum("bqc,bqhw->bhwc", probs, torch.sigmoid(mask_logits))


# ---------------------------------------------------------------------------
# Point-sampled Hungarian-matched losses
# ---------------------------------------------------------------------------


def point_sample(masks: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """masks [N, H, W], coords [N, P, 2] in [0, 1] (x, y) -> [N, P]."""
    return bilinear_sample(masks[..., None], coords)[..., 0]


def _uniform(generator, shape, device) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=device)


def uncertain_point_coords(
    mask_logits: torch.Tensor,  # [N, H, W]
    num_points: int,
    oversample_ratio: float,
    importance_sample_ratio: float,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Tuple[torch.Tensor, Optional[torch.Tensor]]] = None,
) -> torch.Tensor:
    """get_uncertain_point_coords_with_randomness: oversample random points,
    keep the most uncertain (smallest |logit|) share, fill the rest
    uniformly -> [N, P, 2]. ``draws``: the (oversampled, fill) uniforms, or
    None to draw them from ``generator``."""
    n = mask_logits.shape[0]
    n_sampled = int(num_points * oversample_ratio)
    n_unc = int(importance_sample_ratio * num_points)
    n_rand = num_points - n_unc
    if draws is None:
        dev = mask_logits.device
        draws = (_uniform(generator, (n, n_sampled, 2), dev),
                 _uniform(generator, (n, n_rand, 2), dev) if n_rand else None)
    coords, fill = draws
    logits = point_sample(mask_logits, coords)
    idx = torch.argsort(logits.abs(), dim=1, stable=True)[:, :n_unc]  # most uncertain first
    picked = coords.gather(1, idx[..., None].expand(-1, -1, 2))
    if n_rand:
        picked = torch.cat([picked, fill], 1)
    return picked.detach()


def _bce_logits(logits, targets):
    return logits.clamp_min(0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def _host_lsa(cost: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """[B, Q, G] cost + [B, G] validity -> [B, G] query index (-1 invalid)."""
    from scipy.optimize import linear_sum_assignment

    b, _, g = cost.shape
    out = np.full((b, g), -1, np.int32)
    for i in range(b):
        vi = np.flatnonzero(valid[i])
        if vi.size == 0:
            continue
        rows, cols = linear_sum_assignment(cost[i][:, vi])
        out[i, vi[cols]] = rows.astype(np.int32)
    return out


def match(
    cls_logits: torch.Tensor,  # [B, Q, C+1]
    mask_logits: torch.Tensor,  # [B, Q, h, w]
    gt_labels: torch.Tensor,  # [B, G] int (padded)
    gt_masks: torch.Tensor,  # [B, G, h, w] {0, 1}
    gt_valid: torch.Tensor,  # [B, G] bool
    cfg: Mask2FormerConfig,
    generator: Optional[torch.Generator] = None,
    num_match_points: int = 0,
    coords: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Hungarian assignment per image -> query index per gt slot [B, G]
    (-1: no gt there). Costs (cls 2.0 + BCE-mask 5.0 + dice 5.0) on
    ``num_match_points`` random points shared by the batch's queries and
    gts (``coords`` [B, 1, P, 2], or None to draw them). The [B, Q, G] cost
    is built on the device (the mean BCE splits into a per-query term minus
    ``x @ y^T / P``); the assignment runs on the host."""
    b, q = cls_logits.shape[:2]
    g = gt_labels.shape[1]
    p = num_match_points or min(cfg.num_points, 2048)
    if coords is None:
        coords = _uniform(generator, (b, 1, p, 2), mask_logits.device)
    pred_pts = point_sample(
        mask_logits.reshape(b * q, *mask_logits.shape[2:]),
        coords.expand(b, q, p, 2).reshape(b * q, p, 2),
    ).reshape(b, q, p).float()
    gt_pts = point_sample(
        gt_masks.float().reshape(b * g, *gt_masks.shape[2:]),
        coords.expand(b, g, p, 2).reshape(b * g, p, 2),
    ).reshape(b, g, p)

    probs = torch.softmax(cls_logits.float(), -1)
    c_cls = -probs.gather(2, gt_labels.long()[:, None, :].expand(b, q, g))
    per_q = (pred_pts.clamp_min(0) + torch.log1p(torch.exp(-pred_pts.abs()))).mean(-1)
    c_mask = per_q[:, :, None] - torch.einsum("bqp,bgp->bqg", pred_pts, gt_pts) / p
    sp = torch.sigmoid(pred_pts)
    inter = 2.0 * torch.einsum("bqp,bgp->bqg", sp, gt_pts)
    denom = sp.sum(-1)[:, :, None] + gt_pts.sum(-1)[:, None, :]
    c_dice = 1.0 - (inter + 1.0) / (denom + 1.0)
    cost = cfg.cls_weight * c_cls + cfg.mask_weight * c_mask + cfg.dice_weight * c_dice
    assign = _host_lsa(cost.detach().cpu().numpy(), gt_valid.detach().cpu().numpy())
    return torch.from_numpy(assign).to(cls_logits.device)


def _scatter_rows(dest, idx, upd, valid):
    """dest [B, Q], idx / upd / valid [B, G]: dest[b, idx[b, g]] = upd where
    valid. An invalid slot writes to an extra column that is dropped."""
    q = dest.shape[1]
    ext = torch.cat([dest, dest.new_zeros(dest.shape[0], 1)], 1)
    ext = ext.scatter(1, torch.where(valid, idx, q).long(), torch.where(valid, upd, 0).to(dest.dtype))
    return ext[:, :q]


def loss_single(
    cls_logits: torch.Tensor,  # [B, Q, C+1]
    mask_logits: torch.Tensor,  # [B, Q, h, w]
    gt_labels: torch.Tensor,  # [B, G]
    gt_masks: torch.Tensor,  # [B, G, h, w]
    gt_valid: torch.Tensor,  # [B, G] bool
    assign: torch.Tensor,  # [B, G] query index per gt (-1 = unassigned)
    cfg: Mask2FormerConfig,
    generator: Optional[torch.Generator] = None,
    num_points: int = 0,
    draws: Optional[Tuple[torch.Tensor, Optional[torch.Tensor]]] = None,
) -> Dict[str, torch.Tensor]:
    """Losses of one decoder layer given an assignment."""
    b, q, _ = cls_logits.shape
    g = gt_labels.shape[1]
    p = num_points or cfg.num_points
    dev = cls_logits.device

    valid = gt_valid & (assign >= 0)
    a_safe = assign.clamp_min(0).long()

    # classification: assigned queries get their gt label, the rest no-object
    labels = torch.full((b, q), cfg.num_classes, dtype=torch.long, device=dev)
    upd = torch.where(valid, gt_labels.long(), cfg.num_classes)
    labels = _scatter_rows(labels, a_safe, upd, valid)
    class_weight = torch.cat([torch.ones(cfg.num_classes, device=dev),
                              torch.tensor([cfg.no_object_weight], device=dev)])
    logp = torch.log_softmax(cls_logits.float(), -1)
    w = class_weight[labels]
    ce = -logp.gather(-1, labels[..., None])[..., 0] * w
    loss_cls = cfg.cls_weight * ce.sum() / w.sum().clamp_min(1.0)

    # masks: point-sampled dice + BCE on the matched pairs
    num_pos = valid.float().sum().clamp_min(1.0)
    h, w_ = mask_logits.shape[2:]
    pred = mask_logits.gather(1, a_safe[:, :, None, None].expand(b, g, h, w_))
    pred2 = pred.reshape(b * g, h, w_)
    coords = uncertain_point_coords(pred2.detach(), p, cfg.oversample_ratio,
                                    cfg.importance_sample_ratio, generator, draws)
    pred_pts = point_sample(pred2, coords).reshape(b, g, p)
    gt_pts = point_sample(gt_masks.float().reshape(b * g, *gt_masks.shape[2:]),
                          coords).reshape(b, g, p)
    vf = valid.float()[..., None]

    sp = torch.sigmoid(pred_pts)
    inter = (sp * gt_pts * vf).sum(-1)
    denom = ((sp + gt_pts) * vf).sum(-1)
    dice = 1.0 - (2.0 * inter + 1.0) / (denom + 1.0)
    loss_dice = cfg.dice_weight * (dice * valid).sum() / num_pos

    bce = _bce_logits(pred_pts, gt_pts) * vf
    loss_mask = cfg.mask_weight * bce.sum() / (num_pos * p)
    return {"loss_cls": loss_cls, "loss_mask": loss_mask, "loss_dice": loss_dice}


def loss(
    all_cls: torch.Tensor,  # [L, B, Q, C+1]
    all_masks: torch.Tensor,  # [L, B, Q, h, w]
    gt_labels,
    gt_masks,
    gt_valid,
    cfg: Mask2FormerConfig,
    generator: Optional[torch.Generator] = None,
    num_points: int = 0,
    draws: Optional[Sequence[Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]]] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Deep supervision over every layer: each layer matched on its own
    detached predictions, then its losses. ``draws``: per layer the match
    points [B, 1, P, 2], the oversampled and the fill uniforms of
    :func:`uncertain_point_coords`; None draws them from ``generator``."""
    n_layers = all_cls.shape[0]
    dev = all_cls.device
    gt_labels, gt_masks, gt_valid = (torch.as_tensor(t, device=dev)
                                     for t in (gt_labels, gt_masks, gt_valid))
    total = 0.0
    logs: Dict[str, torch.Tensor] = {}
    for li in range(n_layers):
        mc, sampled = (draws[li][0], draws[li][1:]) if draws is not None else (None, None)
        assign = match(all_cls[li].detach(), all_masks[li].detach(), gt_labels, gt_masks,
                       gt_valid, cfg, generator, num_match_points=num_points, coords=mc)
        parts = loss_single(all_cls[li], all_masks[li], gt_labels, gt_masks, gt_valid,
                            assign, cfg, generator, num_points=num_points, draws=sampled)
        for k, v in parts.items():
            logs[k if li == n_layers - 1 else f"d{li}.{k}"] = v
            total = total + v
    return total, logs
