"""Host-side graph batching: padding collator + Laplacian eigenvectors.

Port of ``metatransformer_tpu/data/graph_collate.py`` (the same numpy
code, so both packages give equal batches). The reference precomputes
Laplacian eigendecompositions in data workers
(``Graph/metatransformer/data/algos.py`` / ``wrapper.py``) and pads ragged
graphs in the collator (``data/collator.py``). Same split here: numpy on
the host produces the padded-dense batch dict that
``tokenizers.graph.apply`` and ``Data2Seq("graph")`` consume (eigh on
small data-dependent shapes belongs on the host).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def laplacian_eig(edge_index: np.ndarray, n_nodes: int):
    """Symmetric-normalized Laplacian eigendecomposition.

    edge_index: int [E, 2] (undirected edges can appear once or twice).
    Returns (eigvec [n, n], eigval [n]) sorted ascending.
    """
    adj = np.zeros((n_nodes, n_nodes), np.float64)
    for u, v in np.asarray(edge_index).reshape(-1, 2):
        adj[u, v] = 1.0
        adj[v, u] = 1.0
    deg = adj.sum(1)
    with np.errstate(divide="ignore"):
        dinv = np.where(deg > 0, deg**-0.5, 0.0)
    lap = np.eye(n_nodes) - dinv[:, None] * adj * dinv[None, :]
    eigval, eigvec = np.linalg.eigh(lap)
    return eigvec.astype(np.float32), eigval.astype(np.float32)


def collate(
    graphs: Sequence[Dict[str, np.ndarray]],
    max_nodes: int,
    max_edges: int,
    lap_k: int = 16,
) -> Dict[str, np.ndarray]:
    """Pad a list of graphs to a dense batch.

    Each graph dict: node_data int [n, Fn], edge_index int [e, 2],
    edge_data int [e, Fe]. Bucketing: callers pick (max_nodes, max_edges)
    per bucket so the set of served shapes stays small.
    """
    b = len(graphs)
    fn = graphs[0]["node_data"].shape[-1]
    fe = graphs[0]["edge_data"].shape[-1] if graphs[0]["edge_data"].size else 1
    out = {
        "node_data": np.zeros((b, max_nodes, fn), np.int32),
        "edge_data": np.zeros((b, max_edges, fe), np.int32),
        "edge_index": np.zeros((b, max_edges, 2), np.int32),
        "node_num": np.zeros((b,), np.int32),
        "edge_num": np.zeros((b,), np.int32),
        "lap_eigvec": np.zeros((b, max_nodes, lap_k), np.float32),
        "lap_eigval": np.zeros((b, max_nodes, lap_k), np.float32),
    }
    for i, g in enumerate(graphs):
        n = g["node_data"].shape[0]
        e = g["edge_index"].shape[0]
        if n > max_nodes or e > max_edges:
            raise ValueError(f"graph {i} ({n} nodes, {e} edges) exceeds bucket")
        out["node_data"][i, :n] = g["node_data"]
        out["edge_index"][i, :e] = g["edge_index"]
        out["edge_data"][i, :e] = g["edge_data"]
        out["node_num"][i] = n
        out["edge_num"][i] = e
        eigvec, eigval = laplacian_eig(g["edge_index"], n)
        k = min(lap_k, n)
        out["lap_eigvec"][i, :n, :k] = eigvec[:, :k]
        out["lap_eigval"][i, :n, :k] = np.broadcast_to(eigval[None, :k], (n, k))
    return out
