"""Video masked-autoencoder pretraining (VideoMAE V2 parity).

Port of ``metatransformer_tpu/models/video_pretrain.py``: tube masking (one
spatial mask shared by all frames), an encoder that sees only the visible
tokens, and a light decoder that reconstructs per-patch-normalised pixels
at the masked positions (MSE on masked patches only).

At the default geometry the encoder runs 152 visible tokens and the
decoder (dim 384, 6 heads of 64) all 1568, so the decoder's attention goes
through :mod:`metatransformer_tpu_torch.ops.flash_attention`; under the
default FP32 policy that is the kernels' fp32 route.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from metatransformer_tpu_torch.core import device as _device
from metatransformer_tpu_torch.core import encoder as enc
from metatransformer_tpu_torch.tokenizers import video as video_tok


@dataclasses.dataclass(frozen=True)
class VideoMAEConfig:
    tokenizer: video_tok.VideoTokenizerConfig = video_tok.VideoTokenizerConfig()
    encoder: enc.EncoderConfig = enc.BASE
    decoder: enc.EncoderConfig = enc.EncoderConfig(dim=384, depth=4, num_heads=6)
    mask_ratio: float = 0.9  # VideoMAE default tube-mask ratio

    @property
    def num_tokens(self) -> int:
        return self.tokenizer.num_patches

    @property
    def num_visible(self) -> int:
        return self.num_tokens - int(self.num_tokens * self.mask_ratio)


def tube_mask(
    generator: torch.Generator, cfg: VideoMAEConfig, batch: int, device=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tube masking: ONE spatial mask shared across all temporal slices.
    Returns (visible_idx [B, Nv], masked_idx [B, Nm]) as indices into the
    [T'*H'*W'] token sequence, on ``device`` (default: the generator's).
    The noise is drawn from ``generator`` on its own device."""
    t = cfg.tokenizer.t_patches
    spatial = cfg.tokenizer.grid * cfg.tokenizer.grid
    n_vis_spatial = cfg.num_visible // t
    noise = torch.rand(batch, spatial, generator=generator, device=generator.device)
    order = torch.argsort(noise, dim=-1)  # random spatial permutation
    if device is not None:
        order = order.to(device)
    vis_sp = order[:, :n_vis_spatial]  # [B, Vs]
    mask_sp = order[:, n_vis_spatial:]
    offs = (torch.arange(t, device=order.device) * spatial)[None, :, None]  # [1, T, 1]
    visible = (vis_sp[:, None, :] + offs).reshape(batch, -1)
    masked = (mask_sp[:, None, :] + offs).reshape(batch, -1)
    return visible, masked


def init(
    cfg: VideoMAEConfig,
    generator: torch.Generator,
    device: _device.Device = None,
) -> Dict[str, Any]:
    """Seeded random parameters (drawn on the CPU, then moved to ``device``;
    None: the card)."""
    device = _device.resolve(device)
    d, dd = cfg.encoder.dim, cfg.decoder.dim
    patch_dim = cfg.tokenizer.patch_dim
    randn = lambda *shape: torch.randn(*shape, generator=generator)
    ones = lambda n: torch.ones(n, dtype=torch.float32, device=device)
    zeros = lambda n: torch.zeros(n, dtype=torch.float32, device=device)
    return {
        "tokenizer": video_tok.init(cfg.tokenizer, generator, device),
        "encoder": enc.init(cfg.encoder, generator, device),
        "enc_norm_scale": ones(d), "enc_norm_bias": zeros(d),
        "enc_to_dec_w": (randn(d, dd) * d**-0.5).to(device),
        "enc_to_dec_b": zeros(dd),
        "mask_token": (randn(1, 1, dd) * 0.02).to(device),
        "decoder": enc.init(cfg.decoder, generator, device),
        "dec_norm_scale": ones(dd), "dec_norm_bias": zeros(dd),
        "head_w": (randn(dd, patch_dim) * dd**-0.5).to(device),
        "head_b": zeros(patch_dim),
    }


def _gather_tokens(tokens: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(tokens, 1, idx[..., None].expand(-1, -1, tokens.shape[-1]))


def forward_loss_at(
    params: Dict[str, Any],
    clips: torch.Tensor,  # [B, T, H, W, C]
    visible: torch.Tensor,  # [B, Nv] token indices the encoder sees
    masked: torch.Tensor,  # [B, Nm] token indices to reconstruct
    cfg: VideoMAEConfig,
    precision: enc.Precision = enc.FP32,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The pretrain forward for a given tube mask: returns (loss, aux)."""
    b = clips.shape[0]
    n = cfg.num_tokens
    if clips.dtype == torch.uint8:
        clips = clips.to(torch.float32) * (1.0 / 255.0)
    tokens = video_tok.apply(params["tokenizer"], clips, cfg.tokenizer)
    pos = video_tok.sincos_pos_embed_on(cfg.encoder.dim, n, tokens.device)
    tokens = tokens + pos.to(tokens.dtype)
    vis_tokens = _gather_tokens(tokens, visible)  # [B, Nv, D]

    x = enc.encode(params["encoder"], vis_tokens, cfg.encoder, precision=precision)
    x = enc.layer_norm(x, params["enc_norm_scale"], params["enc_norm_bias"], 1e-6)
    # x is in the compute dtype; the fp32 weights promote it, as in JAX
    x = x.to(params["enc_to_dec_w"].dtype) @ params["enc_to_dec_w"] + params["enc_to_dec_b"]

    # decoder sequence: visible (projected) + mask tokens, each + dec pos
    dec_pos = video_tok.sincos_pos_embed_on(cfg.decoder.dim, n, x.device).to(x.dtype)
    dec_pos = dec_pos.expand(b, n, cfg.decoder.dim)
    pos_vis = _gather_tokens(dec_pos, visible)
    pos_mask = _gather_tokens(dec_pos, masked)
    nm = masked.shape[1]
    mask_tok = params["mask_token"].to(x.dtype).expand(b, nm, cfg.decoder.dim)
    dec_in = torch.cat([x + pos_vis, mask_tok + pos_mask], dim=1)
    y = enc.encode(params["decoder"], dec_in, cfg.decoder, precision=precision)
    y = enc.layer_norm(y, params["dec_norm_scale"], params["dec_norm_bias"], 1e-6)
    pred = y[:, -nm:].to(params["head_w"].dtype) @ params["head_w"] + params["head_b"]

    # targets: per-patch-normalised raw pixels at masked positions
    patches = video_tok.tubelets(
        clips, cfg.tokenizer.tubelet_size, cfg.tokenizer.patch_size
    )  # [B, N, patch_dim]
    target = _gather_tokens(patches, masked)
    mean = target.mean(dim=-1, keepdim=True)
    std = target.std(dim=-1, keepdim=True, unbiased=False)  # the population form
    target = (target - mean) / std.clamp_min(1e-6)

    loss = (pred.float() - target).square().mean()
    return loss, {"pred": pred, "masked_idx": masked}


def forward_loss(
    params: Dict[str, Any],
    clips: torch.Tensor,  # [B, T, H, W, C]
    generator: torch.Generator,
    cfg: VideoMAEConfig,
    precision: enc.Precision = enc.FP32,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One pretrain forward with a tube mask drawn from ``generator``:
    returns (loss, aux)."""
    visible, masked = tube_mask(generator, cfg, clips.shape[0], device=clips.device)
    return forward_loss_at(params, clips, visible, masked, cfg, precision)
