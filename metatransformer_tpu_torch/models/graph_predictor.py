"""Graph prediction model (TokenGT-on-Meta-Transformer).

Port of ``metatransformer_tpu/models/graph_predictor.py``. Reference:
``Graph/metatransformer/models/tokengt.py`` +
``modules/tokengt_graph_encoder.py:42-299`` — tokenizer -> (optional
embedding LayerNorm) -> 12 frozen 768-wide blocks run with **num_heads=32**
(:191-206) -> final LN -> graph token ``x[:, 0, :]`` -> LM-style head
(Linear + erf GELU + LN, then output projection). PCQM4Mv2 recipe:
lap-node-id k=16 with sign flip, L1 loss on 1 regression target.

At ``enc.GRAPH_BASE`` (32 heads of 24) neither kernel gate admits the head
dim, so every block runs the plain "xla" attention in both packages;
``attn_impl="performer"`` runs FAVOR+ (``ops/performer.py``). Batches are
the padded dicts of ``data/graph_collate.collate``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from metatransformer_tpu_torch.core import device as _device
from metatransformer_tpu_torch.core import encoder as enc
from metatransformer_tpu_torch.tokenizers import graph as graph_tok


@dataclasses.dataclass(frozen=True)
class GraphPredictorConfig:
    tokenizer: graph_tok.GraphTokenizerConfig = graph_tok.GraphTokenizerConfig()
    encoder: enc.EncoderConfig = enc.GRAPH_BASE  # 12x768, heads=32
    num_targets: int = 1  # PCQM4Mv2 regression
    layernorm_embedding: bool = True
    ln_eps: float = 1e-5


def init(
    cfg: GraphPredictorConfig,
    generator: torch.Generator,
    device: _device.Device = None,
) -> Dict[str, Any]:
    """Seeded random parameters (drawn on the CPU, then moved to ``device``;
    None: the card). The layout is the reference's, so a JAX tree carries
    over through ``convert.from_numpy``."""
    device = _device.resolve(device)
    d = cfg.encoder.dim
    ones = lambda n: torch.ones(n, device=device)
    zeros = lambda n: torch.zeros(n, device=device)
    params: Dict[str, Any] = {
        "tokenizer": graph_tok.init(cfg.tokenizer, generator, device),
        "encoder": enc.init(cfg.encoder, generator, device),
        "final_norm_scale": ones(d),
        "final_norm_bias": zeros(d),
        # LM-style head
        "head_transform_w": (torch.randn(d, d, generator=generator) * d**-0.5).to(device),
        "head_transform_b": zeros(d),
        "head_norm_scale": ones(d),
        "head_norm_bias": zeros(d),
        "head_out_w": (torch.randn(d, cfg.num_targets, generator=generator)
                       * d**-0.5).to(device),
        "head_out_b": zeros(cfg.num_targets),
    }
    if cfg.layernorm_embedding:
        params["embed_norm_scale"] = ones(d)
        params["embed_norm_bias"] = zeros(d)
    return params


def _on(batch: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    """The batch dict's arrays as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def forward(
    params: Dict[str, Any],
    batch: Dict[str, Any],
    cfg: GraphPredictorConfig,
    generator: Optional[torch.Generator] = None,
    train: bool = False,
    precision: enc.Precision = enc.FP32,
    **draws: torch.Tensor,
) -> torch.Tensor:
    """Padded graph batch -> predictions [B, num_targets] (fp32).

    ``generator`` draws the tokenizer's training-time randomness (the
    Laplacian sign flip); ``draws`` (``rand_ids``, ``orf_ids``,
    ``lap_signs``) pass drawn values in instead, as
    ``tokenizers.graph.apply`` takes them.
    """
    batch = _on(batch, params["final_norm_scale"].device)
    tokens, keep_mask = graph_tok.apply(
        params["tokenizer"], batch, cfg.tokenizer, generator=generator, train=train, **draws)
    if cfg.layernorm_embedding:
        tokens = enc.layer_norm(
            tokens, params["embed_norm_scale"], params["embed_norm_bias"], cfg.ln_eps)
    x = enc.encode(params["encoder"], tokens, cfg.encoder, mask=keep_mask, precision=precision)
    x = enc.layer_norm(x, params["final_norm_scale"], params["final_norm_bias"], cfg.ln_eps)
    # the graph token; bf16 features promote to the fp32 head, as in JAX
    g = x[:, 0, :].float()
    h = F.gelu(g @ params["head_transform_w"] + params["head_transform_b"])
    h = enc.layer_norm(h, params["head_norm_scale"], params["head_norm_bias"], cfg.ln_eps)
    return h @ params["head_out_w"] + params["head_out_b"]


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """GraphPredictionL1Loss (``criterions/l1_loss.py:13-14``)."""
    return (pred.squeeze(-1) - target).abs().mean()


def evaluate(
    params: Dict[str, Any],
    cfg: GraphPredictorConfig,
    batches,
    precision: enc.Precision = enc.FP32,
) -> Dict[str, float]:
    """MAE over an iterable of (collated graph batch, targets [B]) —
    the reference's eval entry (``Graph/metatransformer/evaluate/
    evaluate.py:1-137``: load checkpoint, run the valid split, report
    MAE). Padding rows (node_num == 0) are excluded from the mean."""
    errs = []
    with torch.no_grad():
        for batch, targets in batches:
            pred = forward(params, batch, cfg, precision=precision)[:, 0].cpu().numpy()
            t = np.asarray(targets)
            valid = np.asarray(batch["node_num"]) > 0
            errs.append(np.abs(pred - t)[valid])
    all_err = np.concatenate(errs) if errs else np.zeros((0,))
    return {
        "mae": float(all_err.mean()) if len(all_err) else float("nan"),
        "n": int(len(all_err)),
    }


def evaluate_checkpoint(
    ckpt_dir: str,
    cfg: GraphPredictorConfig,
    batches,
    params_template: Optional[Dict[str, Any]] = None,
    device: _device.Device = None,
) -> Dict[str, float]:
    """Load the newest trainable state of a Trainer checkpoint dir onto
    ``device`` (None: the card) and evaluate (evaluate.py's --ckpt-path
    flow over ``utils.checkpoint.auto_resume``)."""
    from metatransformer_tpu_torch.utils import checkpoint as ckpt_lib

    resumed = ckpt_lib.auto_resume(ckpt_dir, device)
    if resumed is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    state, _epoch = resumed
    params = dict(params_template or {})
    params.update(state["trainable"])
    return evaluate(params, cfg, batches)
