"""Time-series Meta-Transformer: frozen encoder + trainable decoder.

Port of ``metatransformer_tpu/models/time_series.py``: DataEmbedding
encoder / decoder embeddings at the encoder's width, the frozen encoder, a
vanilla transformer decoder (causal self-attention, cross-attention, a
k=1-conv FFN; post-LN, Time-Series-Library ``DecoderLayer``) and the
reference's four tasks: long / short-term forecast, imputation, anomaly
detection, classification. The decoder's layer leaves are stacked
``[depth, ...]`` with linear weights ``[in, out]``, the JAX layout.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from metatransformer_tpu_torch.core import device as _device
from metatransformer_tpu_torch.core import encoder as enc
from metatransformer_tpu_torch.tokenizers import time_series as ts_tok

_FORECAST = ("long_term_forecast", "short_term_forecast")


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    dim: int = 768
    d_ff: int = 2048
    num_heads: int = 8
    depth: int = 1
    activation: str = "gelu"  # "gelu" | "relu"
    ln_eps: float = 1e-5  # torch nn.LayerNorm default


@dataclasses.dataclass(frozen=True)
class TimeSeriesModelConfig:
    task: str = "long_term_forecast"
    pred_len: int = 96
    seq_len: int = 96
    enc_in: int = 7
    dec_in: int = 7
    c_out: int = 7
    num_classes: int = 0
    embed_type: str = "fixed"
    freq: str = "h"
    encoder: enc.EncoderConfig = enc.BASE
    decoder: DecoderConfig = DecoderConfig()

    @property
    def enc_embedding(self) -> ts_tok.TimeSeriesConfig:
        return ts_tok.TimeSeriesConfig(
            c_in=self.enc_in, dim=self.encoder.dim, embed_type=self.embed_type, freq=self.freq)

    @property
    def dec_embedding(self) -> ts_tok.TimeSeriesConfig:
        return ts_tok.TimeSeriesConfig(
            c_in=self.dec_in, dim=self.encoder.dim, embed_type=self.embed_type, freq=self.freq)


def _lin(x, p, name):
    return enc._linear(x, p[f"{name}_w"], p[f"{name}_b"])


def _mha(x, kv, p, prefix, num_heads, causal):
    """AttentionLayer + FullAttention: scale 1/sqrt(head_dim), fp32 softmax."""
    b, tq, d = x.shape
    tk = kv.shape[1]
    hd = d // num_heads
    q = _lin(x, p, f"{prefix}_q").reshape(b, tq, num_heads, hd)
    k = _lin(kv, p, f"{prefix}_k").reshape(b, tk, num_heads, hd)
    v = _lin(kv, p, f"{prefix}_v").reshape(b, tk, num_heads, hd)
    logits = torch.einsum("bthd,bshd->bhts", q * hd**-0.5, k).float()
    if causal:
        tri = torch.ones(tq, tk, dtype=torch.bool, device=x.device).tril()
        logits = logits.masked_fill(~tri, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhts,bshd->bthd", probs, v).reshape(b, tq, d)
    return _lin(out, p, f"{prefix}_o")


def _decoder_layer(x, cross, p, cfg: DecoderConfig, causal: bool = True):
    ln = lambda h, n: enc.layer_norm(h, p[f"{n}_scale"], p[f"{n}_bias"], cfg.ln_eps)
    x = ln(x + _mha(x, x, p, "self", cfg.num_heads, causal), "norm1")
    y = x = ln(x + _mha(x, cross, p, "cross", cfg.num_heads, False), "norm2")
    # the reference's jax.nn.gelu, whose default is the tanh form
    act = (lambda h: F.gelu(h, approximate="tanh")) if cfg.activation == "gelu" else F.relu
    y = _lin(act(_lin(y, p, "ff1")), p, "ff2")
    return ln(x + y, "norm3")


def _decoder_layer_shapes(cfg: DecoderConfig) -> Dict[str, tuple]:
    d, f = cfg.dim, cfg.d_ff
    shapes = {}
    for pre in ("self", "cross"):
        for proj in ("q", "k", "v", "o"):
            shapes[f"{pre}_{proj}_w"] = (d, d)
            shapes[f"{pre}_{proj}_b"] = (d,)
    shapes.update(
        ff1_w=(d, f), ff1_b=(f,), ff2_w=(f, d), ff2_b=(d,),
        norm1_scale=(d,), norm1_bias=(d,), norm2_scale=(d,), norm2_bias=(d,),
        norm3_scale=(d,), norm3_bias=(d,),
    )
    return shapes


def init(
    cfg: TimeSeriesModelConfig,
    generator: torch.Generator,
    device: _device.Device = None,
) -> Dict[str, Any]:
    """Seeded random parameters (drawn on the CPU, then moved to ``device``;
    None: the card)."""
    device = _device.resolve(device)
    randn = lambda *shape: torch.randn(*shape, generator=generator)
    d = cfg.encoder.dim
    params: Dict[str, Any] = {
        "enc_embedding": ts_tok.init(cfg.enc_embedding, generator, device),
        "encoder": enc.init(cfg.encoder, generator, device),
    }
    if cfg.task in _FORECAST:
        params["dec_embedding"] = ts_tok.init(cfg.dec_embedding, generator, device)
        dec = {}
        for name, shape in _decoder_layer_shapes(cfg.decoder).items():
            full = (cfg.decoder.depth,) + shape
            if name.endswith("_w"):
                dec[name] = randn(*full) * (shape[0] ** -0.5)
            elif "scale" in name:
                dec[name] = torch.ones(full)
            else:
                dec[name] = torch.zeros(full)
        params["decoder"] = {k: v.to(device) for k, v in dec.items()}
        params["dec_norm_scale"] = torch.ones(d, device=device)
        params["dec_norm_bias"] = torch.zeros(d, device=device)
        in_dim, out_dim = d, cfg.c_out
    elif cfg.task in ("imputation", "anomaly_detection"):
        in_dim, out_dim = d, cfg.c_out
    elif cfg.task == "classification":
        in_dim, out_dim = d * cfg.seq_len, cfg.num_classes
    else:
        raise ValueError(f"unknown task {cfg.task!r}")
    params["proj_w"] = (randn(in_dim, out_dim) * in_dim**-0.5).to(device)
    params["proj_b"] = torch.zeros(out_dim, device=device)
    return params


def _encode(params, x_enc, x_mark_enc, cfg, precision):
    emb = ts_tok.apply(params["enc_embedding"], x_enc, cfg.enc_embedding, x_mark_enc)
    return enc.encode(params["encoder"], emb, cfg.encoder, precision=precision)


def _proj(params, h):
    w = params["proj_w"]
    return h.to(w.dtype) @ w + params["proj_b"]


def _decode(params, dec_emb, cross, cfg):
    layers = {k: v.unbind(0) for k, v in params["decoder"].items()}
    x = dec_emb
    for i in range(cfg.decoder.depth):
        x = _decoder_layer(x, cross, {k: v[i] for k, v in layers.items()}, cfg.decoder)
    x = enc.layer_norm(x, params["dec_norm_scale"], params["dec_norm_bias"], cfg.decoder.ln_eps)
    return _proj(params, x)


def forward(
    params: Dict[str, Any],
    x_enc: torch.Tensor,
    cfg: TimeSeriesModelConfig,
    x_mark_enc: Optional[torch.Tensor] = None,
    x_dec: Optional[torch.Tensor] = None,
    x_mark_dec: Optional[torch.Tensor] = None,
    precision: enc.Precision = enc.FP32,
) -> torch.Tensor:
    if cfg.task in _FORECAST:
        cross = _encode(params, x_enc, x_mark_enc, cfg, precision)
        dec_emb = ts_tok.apply(params["dec_embedding"], x_dec, cfg.dec_embedding, x_mark_dec)
        # The decoder runs in fp32 under both policies: its weights are fp32,
        # and the reference's products promote a bf16 encoder output to them.
        out = _decode(params, dec_emb, cross.float(), cfg)
        return out[:, -cfg.pred_len :, :]
    if cfg.task in ("imputation", "anomaly_detection"):
        mark = x_mark_enc if cfg.task == "imputation" else None
        return _proj(params, _encode(params, x_enc, mark, cfg, precision))
    if cfg.task == "classification":
        h = F.gelu(_encode(params, x_enc, None, cfg, precision))
        if x_mark_enc is not None:  # zero-out padding positions
            h = h * x_mark_enc[..., None].to(h.dtype)
        return _proj(params, h.reshape(h.shape[0], -1))
    raise ValueError(f"unknown task {cfg.task!r}")
