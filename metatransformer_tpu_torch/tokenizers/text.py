"""Text tokenizer: CLIP text encoder + zero-padding to encoder width.

Port of ``metatransformer_tpu/tokenizers/text.py``: openai CLIP's
``encode_text`` (causal 12 x 512 transformer, 8 heads, quick-GELU, final
LN, EOT pooling at ``argmax(ids)``, text projection) gives a 512-d
embedding, zero-padded to the encoder's 768: one token a text. The tower
is plain PyTorch in the parameters' dtype (fp32), with the reference's
stacked layout (every layer leaf ``[depth, ...]``, linear weights
``[in, out]``), so JAX parameters and :func:`convert_hf_clip_text`'s
output carry across unchanged. Token ids come from the host tokenizer
(:mod:`.bpe`); the device path starts at ids.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from metatransformer_tpu_torch.core import device as _device
from metatransformer_tpu_torch.core import encoder as enc


@dataclasses.dataclass(frozen=True)
class TextTokenizerConfig:
    vocab_size: int = 49408
    context_length: int = 77
    width: int = 512
    depth: int = 12
    num_heads: int = 8
    proj_dim: int = 512
    target_dim: int = 768  # zero-pad target (encoder width)
    ln_eps: float = 1e-5
    eot_token_id: int = 49407


def _layer_shapes(cfg: TextTokenizerConfig) -> Dict[str, tuple]:
    d, f = cfg.width, cfg.width * 4
    return {
        "ln1_scale": (d,), "ln1_bias": (d,),
        "qkv_w": (d, 3 * d), "qkv_b": (3 * d,),
        "proj_w": (d, d), "proj_b": (d,),
        "ln2_scale": (d,), "ln2_bias": (d,),
        "fc1_w": (d, f), "fc1_b": (f,),
        "fc2_w": (f, d), "fc2_b": (d,),
    }


def init(
    cfg: TextTokenizerConfig,
    generator: torch.Generator,
    device: _device.Device = None,
) -> Dict[str, torch.Tensor]:
    """Seeded random tower (drawn on the CPU, then moved to ``device``)."""
    device = _device.resolve(device)
    randn = lambda *shape: torch.randn(*shape, generator=generator)
    params: Dict[str, torch.Tensor] = {
        "token_embed": randn(cfg.vocab_size, cfg.width) * 0.02,
        "pos_embed": randn(cfg.context_length, cfg.width) * 0.01,
        "final_ln_scale": torch.ones(cfg.width),
        "final_ln_bias": torch.zeros(cfg.width),
        "text_proj": randn(cfg.width, cfg.proj_dim) * cfg.width**-0.5,
    }
    for name, shape in _layer_shapes(cfg).items():
        full = (cfg.depth,) + shape
        if name.endswith("_w"):
            params[name] = randn(*full) * (shape[0] ** -0.5)
        elif "scale" in name:
            params[name] = torch.ones(full)
        else:
            params[name] = torch.zeros(full)
    return {k: v.to(device) for k, v in params.items()}


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's activation: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


def _block(x, p, cfg: TextTokenizerConfig):
    h = enc.layer_norm(x, p["ln1_scale"], p["ln1_bias"], cfg.ln_eps)
    b, t, d = h.shape
    hd = d // cfg.num_heads
    qkv = enc._linear(h, p["qkv_w"], p["qkv_b"]).reshape(b, t, 3, cfg.num_heads, hd)
    q, k, v = qkv.unbind(2)
    logits = torch.einsum("bthd,bshd->bhts", q * hd**-0.5, k).float()
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    logits = logits.masked_fill(~causal, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    attn = torch.einsum("bhts,bshd->bthd", probs, v).reshape(b, t, d)
    x = x + enc._linear(attn, p["proj_w"], p["proj_b"])
    h = enc.layer_norm(x, p["ln2_scale"], p["ln2_bias"], cfg.ln_eps)
    h = quick_gelu(enc._linear(h, p["fc1_w"], p["fc1_b"]))
    return x + enc._linear(h, p["fc2_w"], p["fc2_b"])


def encode_text(
    params: Dict[str, torch.Tensor],
    token_ids: torch.Tensor,  # int [B, T<=context_length]
    cfg: TextTokenizerConfig,
) -> torch.Tensor:
    """CLIP encode_text: ids -> [B, proj_dim] embedding (EOT-pooled)."""
    ids = token_ids.long()
    t = ids.shape[1]
    x = params["token_embed"][ids] + params["pos_embed"][None, :t]
    layers = {k: params[k].unbind(0) for k in _layer_shapes(cfg)}
    for i in range(params["ln1_scale"].shape[0]):
        x = _block(x, {k: v[i] for k, v in layers.items()}, cfg)
    x = enc.layer_norm(x, params["final_ln_scale"], params["final_ln_bias"], cfg.ln_eps)
    # EOT pooling: openai CLIP takes the features at argmax(ids) (EOT has
    # the highest token id).
    pooled = x[torch.arange(x.shape[0], device=x.device), ids.argmax(dim=-1)]
    return pooled @ params["text_proj"]


def zero_padding(embedding: torch.Tensor, target_dim: int) -> torch.Tensor:
    """[B, d] -> [B, target_dim], zero-padded."""
    return F.pad(embedding, (0, target_dim - embedding.shape[-1]))


def apply(
    params: Dict[str, torch.Tensor],
    token_ids: torch.Tensor,
    cfg: TextTokenizerConfig,
) -> torch.Tensor:
    """ids -> [B, 1, target_dim]: one encoder-wide token per text."""
    return zero_padding(encode_text(params, token_ids, cfg), cfg.target_dim)[:, None, :]


def convert_hf_clip_text(
    state: Dict[str, np.ndarray], cfg: TextTokenizerConfig, device: _device.Device = None
) -> Dict[str, torch.Tensor]:
    """HF CLIPTextModelWithProjection state dict (numpy) -> our tree."""
    device = _device.resolve(device)
    p = {k: np.asarray(v, np.float32) for k, v in state.items()}
    pre = "text_model."
    out = {
        "token_embed": p[pre + "embeddings.token_embedding.weight"],
        "pos_embed": p[pre + "embeddings.position_embedding.weight"],
        "final_ln_scale": p[pre + "final_layer_norm.weight"],
        "final_ln_bias": p[pre + "final_layer_norm.bias"],
        "text_proj": p["text_projection.weight"].T,
    }
    layers = []
    for i in range(cfg.depth):
        lp = pre + f"encoder.layers.{i}."
        proj = lambda name, part: p[lp + f"self_attn.{name}_proj.{part}"]
        layers.append({
            "ln1_scale": p[lp + "layer_norm1.weight"],
            "ln1_bias": p[lp + "layer_norm1.bias"],
            "qkv_w": np.concatenate([proj(n, "weight") for n in "qkv"], axis=0).T,
            "qkv_b": np.concatenate([proj(n, "bias") for n in "qkv"]),
            "proj_w": p[lp + "self_attn.out_proj.weight"].T,
            "proj_b": p[lp + "self_attn.out_proj.bias"],
            "ln2_scale": p[lp + "layer_norm2.weight"],
            "ln2_bias": p[lp + "layer_norm2.bias"],
            "fc1_w": p[lp + "mlp.fc1.weight"].T,
            "fc1_b": p[lp + "mlp.fc1.bias"],
            "fc2_w": p[lp + "mlp.fc2.weight"].T,
            "fc2_b": p[lp + "mlp.fc2.bias"],
        })
    for name in _layer_shapes(cfg):
        out[name] = np.stack([layer[name] for layer in layers])
    return {k: torch.tensor(np.ascontiguousarray(v), device=device) for k, v in out.items()}
