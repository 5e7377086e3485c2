"""Graph tokenizer: TokenGT node + edge tokens and their keep-mask.

Port of ``metatransformer_tpu/tokenizers/graph.py``: atom / edge
embeddings (padding index 0, summed over feature columns), node
identifiers (uniform random, Gaussian-orthogonal random or Laplacian
eigenvectors with a random sign flip in training) injected as
concat(id[u], id[v]) through bias-free linears, a node-vs-edge type
embedding, and the [graph] / [null] special tokens.

Batches arrive padded dense, as the reference's host collator makes them:

  node_data  int [B, max_n, F_n]   edge_data  int [B, max_e, F_e]
  edge_index int [B, max_e, 2]     node_num / edge_num int [B]
  lap_eigvec     [B, max_n, k]

The token layout is fixed: [graph][null] + max_n node slots + max_e edge
slots, each slot kept by its count. The random node ids and signs are drawn
from a ``torch.Generator``; a caller may pass them in instead (``rand_ids``,
``orf_ids``, ``lap_signs``), which is how two implementations are held to
one draw.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from metatransformer_tpu_torch.core import device as _device


@dataclasses.dataclass(frozen=True)
class GraphTokenizerConfig:
    num_atoms: int = 512 * 9  # PCQM4Mv2 offsets
    num_edge_types: int = 512 * 3
    dim: int = 768
    rand_node_id: bool = False
    rand_node_id_dim: int = 64
    orf_node_id: bool = False
    orf_node_id_dim: int = 64
    lap_node_id: bool = True
    lap_node_id_k: int = 16
    lap_node_id_sign_flip: bool = True
    type_id: bool = True


def init(
    cfg: GraphTokenizerConfig,
    generator: torch.Generator,
    device: _device.Device = None,
) -> Dict[str, torch.Tensor]:
    """N(0, 0.02) tables and id encoders drawn on the CPU."""
    device = _device.resolve(device)
    randn = lambda *shape: torch.randn(*shape, generator=generator) * 0.02
    params: Dict[str, torch.Tensor] = {
        "atom_embed": randn(cfg.num_atoms, cfg.dim),
        "edge_embed": randn(cfg.num_edge_types, cfg.dim),
        "graph_token": randn(1, cfg.dim),
        "null_token": randn(1, cfg.dim),
    }
    if cfg.rand_node_id:
        params["rand_encoder_w"] = randn(2 * cfg.rand_node_id_dim, cfg.dim)
    if cfg.orf_node_id:
        params["orf_encoder_w"] = randn(2 * cfg.orf_node_id_dim, cfg.dim)
    if cfg.lap_node_id:
        params["lap_encoder_w"] = randn(2 * cfg.lap_node_id_k, cfg.dim)
    if cfg.type_id:
        params["order_embed"] = randn(2, cfg.dim)
    return {k: v.to(device) for k, v in params.items()}


def _embed_sum(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Embedding with padding index 0, summed over the feature columns:
    ids int [B, M, F] -> [B, M, D]; index 0 contributes zero."""
    ids = ids.long()
    return (table[ids] * (ids != 0)[..., None].to(table.dtype)).sum(dim=-2)


def _index_embed(node_id: torch.Tensor, padded_index: torch.Tensor) -> torch.Tensor:
    """node_id [B, max_n, D], padded_index [B, T, 2] -> [B, T, 2D], the
    concat of the two endpoints' identifiers."""
    b, t, _ = padded_index.shape
    d = node_id.shape[-1]
    idx = padded_index.long().reshape(b, 2 * t, 1).expand(b, 2 * t, d)
    return torch.gather(node_id, 1, idx).reshape(b, t, 2 * d)


def _l2norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=dim, keepdim=True), 1e-12)


def orf_node_ids(generator: torch.Generator, b: int, max_n: int, dim: int) -> torch.Tensor:
    """Batched Gaussian-orthogonal random node identifiers [B, max_n, dim],
    row-normalized, on the generator's device."""
    block = torch.randn(b, max_n, max_n, generator=generator, device=generator.device)
    q, _ = torch.linalg.qr(block)
    orf = q.transpose(1, 2)  # [B, max_n, max_n]
    orf = F.pad(orf, (0, dim - max_n)) if dim > max_n else orf[..., :dim]
    return _l2norm(orf)


def _need(generator, what):
    if generator is None:
        raise ValueError(f"{what} needs a torch.Generator (or the drawn values passed in)")
    return generator


def apply(
    params: Dict[str, torch.Tensor],
    batch: Dict[str, torch.Tensor],
    cfg: GraphTokenizerConfig,
    generator: Optional[torch.Generator] = None,
    train: bool = False,
    rand_ids: Optional[torch.Tensor] = None,
    orf_ids: Optional[torch.Tensor] = None,
    lap_signs: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (tokens [B, 2+max_n+max_e, D], keep_mask [B, 2+max_n+max_e]).

    keep_mask is True on valid positions, ready for the encoder's masked
    attention. ``rand_ids`` [B, max_n, rand_node_id_dim] and ``orf_ids``
    [B, max_n, orf_node_id_dim] are the node identifiers, ``lap_signs``
    [B, 1, lap_node_id_k] the +-1 eigenvector signs of a training call;
    each one not given is drawn from ``generator`` where the config needs it.
    """
    node_data = batch["node_data"]  # [B, max_n, Fn]
    edge_data = batch["edge_data"]  # [B, max_e, Fe]
    edge_index = batch["edge_index"]  # [B, max_e, 2]
    dev = node_data.device
    b, max_n = node_data.shape[:2]
    max_e = edge_data.shape[1]

    node_feature = _embed_sum(params["atom_embed"], node_data)
    edge_feature = _embed_sum(params["edge_embed"], edge_data)
    node_valid = torch.arange(max_n, device=dev)[None, :] < batch["node_num"].to(dev)[:, None]
    edge_valid = torch.arange(max_e, device=dev)[None, :] < batch["edge_num"].to(dev)[:, None]

    # Fixed slot layout: node slot i -> endpoints (i, i); edge slots carry (u, v).
    node_slots = torch.arange(max_n, device=dev)[None, :, None].expand(b, max_n, 2)
    padded_index = torch.cat([node_slots, edge_index.long()], dim=1)
    feature = torch.cat([node_feature, edge_feature], dim=1)  # [B, T, D]

    def add_id_embed(feature, node_id, w):
        return feature + _index_embed(node_id.to(dev, w.dtype), padded_index) @ w

    if cfg.rand_node_id:
        if rand_ids is None:
            g = _need(generator, "rand_node_id")
            rand_ids = _l2norm(torch.rand(b, max_n, cfg.rand_node_id_dim, generator=g,
                                          device=g.device))
        feature = add_id_embed(feature, rand_ids, params["rand_encoder_w"])

    if cfg.orf_node_id:
        if orf_ids is None:
            orf_ids = orf_node_ids(_need(generator, "orf_node_id"), b, max_n,
                                   cfg.orf_node_id_dim)
        feature = add_id_embed(feature, orf_ids, params["orf_encoder_w"])

    if cfg.lap_node_id:
        eigvec = batch["lap_eigvec"].float()  # [B, max_n, k_avail]
        k_avail = eigvec.shape[-1]
        if cfg.lap_node_id_k > k_avail:
            eigvec = F.pad(eigvec, (0, cfg.lap_node_id_k - k_avail))
        else:
            eigvec = eigvec[..., : cfg.lap_node_id_k]
        if cfg.lap_node_id_sign_flip and train:
            if lap_signs is None:
                g = _need(generator, "the sign flip")
                draw = torch.rand(b, 1, cfg.lap_node_id_k, generator=g, device=g.device)
                lap_signs = torch.where(draw >= 0.5, 1.0, -1.0)
            eigvec = eigvec * lap_signs.to(eigvec)
        feature = add_id_embed(feature, eigvec, params["lap_encoder_w"])

    if cfg.type_id:
        order = (padded_index[..., 0] == padded_index[..., 1]).long()
        feature = feature + params["order_embed"][order]

    valid = torch.cat([node_valid, edge_valid], dim=1)  # [B, T]
    feature = torch.where(valid[..., None], feature, 0.0)
    special = torch.cat([params["graph_token"], params["null_token"]], dim=0)
    tokens = torch.cat([special.to(feature.dtype).expand(b, 2, cfg.dim), feature], dim=1)
    keep_mask = torch.cat([torch.ones(b, 2, dtype=torch.bool, device=dev), valid], dim=1)
    return tokens, keep_mask
