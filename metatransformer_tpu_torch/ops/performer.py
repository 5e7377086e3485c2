"""Performer / FAVOR+ linear attention (softmax kernel estimator).

Port of ``metatransformer_tpu/ops/performer.py``. Reference: the optional
Performer path in Graph/TokenGT —
``Graph/metatransformer/modules/performer_pytorch.py:61-151``
(``softmax_kernel`` positive random features, ``FastAttention``) with
orthogonal random features (``:103-141`` gaussian_orthogonal_random_matrix).
Unused by the released recipe; provided as
``EncoderConfig(attn_impl="performer")``.

The random-feature matrix is drawn with numpy from the static
``(seed, num_features, head_dim)`` of the config, exactly as the JAX
package draws it, so both packages use the same matrix; a redraw is a seed
bump. The estimator is plain torch: three products (q-features,
k-features·V, output), linear in T with nothing [T, T], the exponentials
and stabilisers in fp32.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch


@functools.lru_cache(maxsize=32)
def orthogonal_random_features(
    seed: int, num_features: int, head_dim: int
) -> np.ndarray:
    """[num_features, head_dim] with orthogonal rows per head_dim-block,
    each row scaled to the deterministic chi norm sqrt(head_dim)
    (``performer_pytorch.py:103-141``, scaling=1 variant)."""
    rng = np.random.default_rng(seed)
    blocks = []
    remaining = num_features
    while remaining > 0:
        g = rng.standard_normal((head_dim, head_dim))
        q, _ = np.linalg.qr(g)
        blocks.append(q.T[: min(remaining, head_dim)])
        remaining -= head_dim
    w = np.concatenate(blocks, axis=0)
    return (w * np.sqrt(head_dim)).astype(np.float32)


def favor_attention(
    q: torch.Tensor,  # [B, H, T, d]
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,  # [M, d] random features
    mask: Optional[torch.Tensor] = None,  # [B, T] bool keep-mask
    eps: float = 1e-6,
) -> torch.Tensor:
    """Softmax-kernel FAVOR+ estimate of attention(q, k, v).

    phi(u) = m^-1/2 exp(W u - ||u||^2 / 2), with q, k pre-scaled by
    d^-1/4 so phi(q)·phi(k) estimates exp(q·k / sqrt(d)). Per-tensor max
    stabilizers keep the exp in range; the per-query stabilizer cancels
    between numerator and denominator.
    """
    d = q.shape[-1]
    m = w.shape[0]
    qf = q.float() * (d**-0.25)
    kf = k.float() * (d**-0.25)
    vf = v.float()
    wf = w.to(device=q.device, dtype=torch.float32)

    q_dot = torch.einsum("bhtd,md->bhtm", qf, wf)
    k_dot = torch.einsum("bhtd,md->bhtm", kf, wf)
    q_sq = 0.5 * (qf * qf).sum(dim=-1, keepdim=True)
    k_sq = 0.5 * (kf * kf).sum(dim=-1, keepdim=True)

    # stabilizers: per-query max (cancels in the ratio) and a global
    # per-(batch, head) max over keys (scales num and den identically)
    q_stab = (q_dot - q_sq).amax(dim=-1, keepdim=True)
    k_stab = (k_dot - k_sq).amax(dim=(-2, -1), keepdim=True)
    phi_q = torch.exp(q_dot - q_sq - q_stab) * (m**-0.5)
    phi_k = torch.exp(k_dot - k_sq - k_stab) * (m**-0.5)
    if mask is not None:
        phi_k = phi_k * mask[:, None, :, None].to(phi_k.dtype)

    kv = torch.einsum("bhtm,bhtd->bhmd", phi_k, vf)
    z = phi_k.sum(dim=2)  # [B, H, M]
    num = torch.einsum("bhtm,bhmd->bhtd", phi_q, kv)
    den = torch.einsum("bhtm,bhm->bht", phi_q, z)
    out = num / (den[..., None] + eps)
    return out.to(q.dtype)
