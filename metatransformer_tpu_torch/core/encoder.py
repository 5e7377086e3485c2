"""The shared Meta-Transformer ViT encoder, in PyTorch.

Port of ``metatransformer_tpu/core/encoder.py``. The parameter tree keeps
the reference's layout and leaf names: every leaf is stacked along a
leading depth axis (``[depth, ...]``) and linear weights are stored
``[in, out]``, so weights carry across from the JAX package as a plain
mapping (:func:`metatransformer_tpu_torch.core.convert.from_numpy`).

Numerics follow timm's ``Block`` (pre-LN, LayerNorm eps 1e-5, fused qkv,
scale ``head_dim**-0.5``, exact erf GELU). LayerNorm and softmax statistics
stay fp32 under both precision policies.

The depth "scan" is a Python loop over the stacked leaves. Under BF16 the
block resolves to the fused sublayers of :mod:`..ops.fused_block`, which
launch hand-written CUDA kernels on CUDA tensors and run their plain
PyTorch versions on CPU tensors. Long sequences (T >= 512) resolve to
"flash": the q, k, v and output projections are library matmuls and the
attention itself is :mod:`..ops.flash_attention`, under both policies.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from metatransformer_tpu_torch.core import device as _device
from metatransformer_tpu_torch.ops import flash_attention as _fa
from metatransformer_tpu_torch.ops import fused_block as _fb
from metatransformer_tpu_torch.ops import performer as _perf

Params = Dict[str, torch.Tensor]

# Leaves consumed by matmuls; pre-cast to bf16 once under the BF16 policy.
# LayerNorm parameters stay fp32 (LayerNorm accumulates in fp32).
_MATMUL_LEAVES = (
    "qkv_w", "qkv_b", "proj_w", "proj_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b",
)

# Attention paths whose kernels or modules are not ported yet, and where
# ROADMAP.md queues them.
_NOT_PORTED = {
    "ring": "ROADMAP.md queue 1, item 8 (parallel/ring_attention.py)",
}


@dataclasses.dataclass(frozen=True)
class Precision:
    """Compute precision policy. Params are stored fp32.

    ``compute_dtype`` is the matmul / activation dtype. fp32 matmuls must
    run in full fp32: on a CUDA card keep
    ``torch.backends.cuda.matmul.allow_tf32`` False (PyTorch's default).
    """

    compute_dtype: torch.dtype = torch.float32

    @property
    def is_bf16(self) -> bool:
        return self.compute_dtype == torch.bfloat16

    @property
    def mm(self) -> str:
        """Matmul precision for stacks outside the encoder that run on fp32
        activations (the point tokenizer's conv stack, multi-scale
        deformable attention, the Mask2Former head): "highest" is full
        fp32, "default" rounds both operands to bf16 and accumulates in
        fp32, the counterpart of the reference's ``Precision.DEFAULT``
        (:func:`linear_at`, :func:`matmul_at`)."""
        return "default" if self.is_bf16 else "highest"


FP32 = Precision(torch.float32)
BF16 = Precision(torch.bfloat16)


def _mm_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 [M, K] @ bf16 [K, N] -> fp32 [M, N], or [G, M, K] @ [G, K, N]
    -> [G, M, N], accumulated in fp32. On the card one tensor-core product
    with an fp32 result; the CPU has no such call, and an fp32 product of
    the widened operands is the same sum."""
    if a.is_cuda:
        return (torch.mm if a.dim() == 2 else torch.bmm)(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _MatmulBF16(torch.autograd.Function):
    """``x @ w`` (2-D, or 3-D with one batch axis on both) with both
    operands rounded to bf16 and an fp32 result; the two products of the
    backward round the cotangent to bf16 likewise."""

    @staticmethod
    def forward(ctx, x, w):
        xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
        ctx.save_for_backward(xb, wb)
        ctx.dtypes = (x.dtype, w.dtype)
        return _mm_bf16(xb, wb)

    @staticmethod
    def backward(ctx, g):
        xb, wb = ctx.saved_tensors
        gb = g.to(torch.bfloat16)
        dx = _mm_bf16(gb, wb.mT).to(ctx.dtypes[0]) if ctx.needs_input_grad[0] else None
        dw = _mm_bf16(xb.mT, gb).to(ctx.dtypes[1]) if ctx.needs_input_grad[1] else None
        return dx, dw


def _check_mm(mm: str) -> None:
    if mm not in ("highest", "default"):
        raise ValueError(f"matmul precision {mm!r}: expected 'highest' or 'default'")


def linear_at(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, mm: str) -> torch.Tensor:
    """``x @ w + b`` over the last axis (w [in, out]) at matmul precision
    ``mm``; the result is fp32 either way."""
    _check_mm(mm)
    if mm == "highest":
        return F.linear(x, w.t(), b)
    out = _MatmulBF16.apply(x.reshape(-1, x.shape[-1]), w)
    return out.add_(b.float()).reshape(*x.shape[:-1], w.shape[1])


def matmul_at(a: torch.Tensor, b: torch.Tensor, mm: str) -> torch.Tensor:
    """``a @ b`` for [..., M, K] @ [..., K, N] with the same leading axes
    at matmul precision ``mm``; the result is fp32 either way."""
    _check_mm(mm)
    if mm == "highest":
        return a @ b
    lead = a.shape[:-2]
    out = _MatmulBF16.apply(a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:]))
    return out.reshape(*lead, a.shape[-2], b.shape[-1])


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    ln_eps: float = 1e-5  # torch nn.LayerNorm default
    attn_impl: str = "auto"  # "xla" | "fused" | "flash" | "performer" | "auto" ("ring" not ported)
    # Gradient checkpointing over the depth loop. False: off. True:
    # recompute each block in the backward pass (activation memory O(1)
    # blocks). "save": keep the block's intermediates for the backward; the
    # fused sublayers recompute theirs, so "save" resolves "fused" to "xla".
    remat: Any = False
    # FAVOR+ features (0 -> 2 * head_dim) and their seed for
    # attn_impl="performer"; the mesh axis the tokens are sharded over for
    # attn_impl="ring", kept so that a config carried over with it
    # constructs (that path is not ported and raises).
    performer_features: int = 0
    performer_seed: int = 0
    ring_axis: str = "seq"

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads

    @property
    def mlp_dim(self) -> int:
        return int(self.dim * self.mlp_ratio)


# The two released checkpoints.
BASE = EncoderConfig(dim=768, depth=12, num_heads=12)
LARGE = EncoderConfig(dim=1024, depth=24, num_heads=16)
# Graph/TokenGT: the same 768-wide blocks with 32 heads.
GRAPH_BASE = EncoderConfig(dim=768, depth=12, num_heads=32)


def layer_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float
) -> torch.Tensor:
    """LayerNorm over the last axis, fp32 accumulation."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(x.dtype)


def _linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` with w stored [in, out], as one library call: the bias
    is added in the matmul's epilogue, not in a second pass over the output."""
    return F.linear(x, w.t(), b)


def attention(
    x: torch.Tensor,
    p: Params,
    cfg: EncoderConfig,
    mask: Optional[torch.Tensor],
    precision: Precision,
) -> torch.Tensor:
    """timm-Attention-equivalent multi-head self-attention.

    "xla": q/k/v are produced head-major ``[B, H, T, d]`` against the
    reshaped fused-qkv weight and the [T, T] logits are materialised. Masked
    keys are filled with -1e4 under bf16 and with ``finfo(float32).min``
    under fp32, as the reference does. "performer": the same q/k/v go to
    :func:`..ops.performer.favor_attention` (FAVOR+, linear in T) with
    ``cfg.performer_features`` random features drawn from
    ``cfg.performer_seed``. "flash": one fused-qkv matmul gives
    ``[B, T, 3, H, d]``, whose three strided views go to
    :func:`..ops.flash_attention.flash_attention` uncopied.
    """
    b, t, d = x.shape
    h, hd = cfg.num_heads, cfg.head_dim
    cd = precision.compute_dtype
    impl = cfg.attn_impl
    if impl == "auto":
        impl = "flash" if _fa.supported(t, hd) else "xla"
    if impl in _NOT_PORTED:
        raise NotImplementedError(
            f"attn_impl={impl!r} is not ported yet: {_NOT_PORTED[impl]}"
        )
    xc = x.to(cd)
    scale = float(hd) ** -0.5
    if impl == "flash":
        qkv = _linear(xc, p["qkv_w"].to(cd), p["qkv_b"].to(cd)).reshape(b, t, 3, h, hd)
        q, k, v = qkv.unbind(2)  # [B, T, H, d] views
        o = _fa.flash_attention(q, k, v, mask=mask, scale=scale).reshape(b, t, d)
        return _linear(o, p["proj_w"].to(cd), p["proj_b"].to(cd)).to(x.dtype)
    w = p["qkv_w"].to(cd).reshape(d, 3, h, hd)
    b3 = p["qkv_b"].to(cd).reshape(3, h, hd)

    q = torch.einsum("btd,dhk->bhtk", xc, w[:, 0]) + b3[0][:, None]
    k = torch.einsum("btd,dhk->bhtk", xc, w[:, 1]) + b3[1][:, None]
    v = torch.einsum("btd,dhk->bhtk", xc, w[:, 2]) + b3[2][:, None]
    if impl == "performer":
        nf = cfg.performer_features or 2 * hd
        feats = torch.from_numpy(_perf.orthogonal_random_features(cfg.performer_seed, nf, hd))
        o = _perf.favor_attention(q, k, v, feats, mask=mask)
        proj = p["proj_w"].to(cd).reshape(h, hd, d)
        out = torch.einsum("bhtk,hkd->btd", o, proj) + p["proj_b"].to(cd)
        return out.to(x.dtype)
    if precision.is_bf16:
        logits = torch.einsum("bhtk,bhsk->bhts", q * scale, k)
        if mask is not None:
            logits = logits.masked_fill(~mask[:, None, None, :], -1e4)
        m = logits.amax(dim=-1, keepdim=True)
        e = torch.exp((logits - m).float()).to(v.dtype)
        probs = e / e.sum(dim=-1, keepdim=True).clamp_min(1e-6)
    else:
        logits = torch.einsum("bhtk,bhsk->bhts", q * scale, k).float()
        if mask is not None:
            logits = logits.masked_fill(
                ~mask[:, None, None, :], torch.finfo(torch.float32).min
            )
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
    o = torch.einsum("bhts,bhsk->bhtk", probs, v)
    proj = p["proj_w"].to(cd).reshape(h, hd, d)
    out = torch.einsum("bhtk,hkd->btd", o, proj) + p["proj_b"].to(cd)
    return out.to(x.dtype)


def _resolve_impl(cfg: EncoderConfig, seq_len: int, precision: Precision) -> str:
    """Pick the attention implementation for this (shape, policy).

    'fused' = the fused attention + MLP sublayers (ops/fused_block.py):
    short sequences under the bf16 serving policy. The choice is the
    reference's for every (cfg, T, precision).
    """
    impl = cfg.attn_impl
    if impl != "auto":
        return impl
    if precision.is_bf16 and _fb.supported(seq_len, cfg.dim, cfg.num_heads):
        return "fused"
    if _fa.supported(seq_len, cfg.head_dim):
        return "flash"
    return "xla"


def mlp(x: torch.Tensor, p: Params, precision: Precision) -> torch.Tensor:
    """timm Mlp: Linear -> exact GELU -> Linear."""
    cd = precision.compute_dtype
    h = _linear(x.to(cd), p["fc1_w"].to(cd), p["fc1_b"].to(cd))
    # GELU in fp32 for the parity policy; in the compute dtype for bf16.
    if precision.is_bf16:
        h = F.gelu(h)
    else:
        h = F.gelu(h.float()).to(cd)
    return _linear(h, p["fc2_w"].to(cd), p["fc2_b"].to(cd)).to(x.dtype)


def block(
    x: torch.Tensor,
    p: Params,
    cfg: EncoderConfig,
    mask: Optional[torch.Tensor] = None,
    precision: Precision = FP32,
) -> torch.Tensor:
    """One pre-LN transformer block (timm ``Block`` semantics)."""
    if _resolve_impl(cfg, x.shape[1], precision) == "fused":
        x = _fb.attn_sublayer(
            x,
            p["norm1_scale"],
            p["norm1_bias"],
            p["qkv_w"],
            p["qkv_b"],
            p["proj_w"],
            p["proj_b"],
            mask=mask,
            num_heads=cfg.num_heads,
            ln_eps=cfg.ln_eps,
        )
        return _fb.mlp_sublayer(
            x,
            p["norm2_scale"],
            p["norm2_bias"],
            p["fc1_w"],
            p["fc1_b"],
            p["fc2_w"],
            p["fc2_b"],
            ln_eps=cfg.ln_eps,
        )
    h = layer_norm(x, p["norm1_scale"], p["norm1_bias"], cfg.ln_eps)
    x = x + attention(h, p, cfg, mask, precision)
    h = layer_norm(x, p["norm2_scale"], p["norm2_bias"], cfg.ln_eps)
    x = x + mlp(h, p, precision)
    return x


def param_shapes(cfg: EncoderConfig) -> Dict[str, tuple]:
    """Leaf names and per-layer shapes of the stacked encoder tree."""
    d, m = cfg.dim, cfg.mlp_dim
    return {
        "norm1_scale": (d,),
        "norm1_bias": (d,),
        "qkv_w": (d, 3 * d),
        "qkv_b": (3 * d,),
        "proj_w": (d, d),
        "proj_b": (d,),
        "norm2_scale": (d,),
        "norm2_bias": (d,),
        "fc1_w": (d, m),
        "fc1_b": (m,),
        "fc2_w": (m, d),
        "fc2_b": (d,),
    }


def init(
    cfg: EncoderConfig,
    generator: torch.Generator,
    device: _device.Device = None,
    dtype: torch.dtype = torch.float32,
) -> Params:
    """Random init (trunc-normal .02 weights, zeros bias, ones LN scale).

    The weights are drawn on the CPU from ``generator`` (a CPU generator)
    and then moved to ``device`` (None: the card), so one seed gives the
    same weights on every device. Real use loads the released checkpoint via
    :mod:`metatransformer_tpu_torch.core.convert`.
    """
    device = _device.resolve(device)
    params = {}
    for name, shape in param_shapes(cfg).items():
        full = (cfg.depth,) + shape
        if name.endswith("_w"):
            w = torch.empty(full, dtype=torch.float32)
            torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
            params[name] = (w * 0.02).to(device=device, dtype=dtype)
        elif "scale" in name:
            params[name] = torch.ones(full, dtype=dtype, device=device)
        else:
            params[name] = torch.zeros(full, dtype=dtype, device=device)
    return params


def cast_params(params: Params, precision: Precision) -> Params:
    """The tree as the policy consumes it: under BF16 the matmul leaves are
    bf16 and the LayerNorm leaves fp32. Casting an already-cast tree is a
    no-op, so a loaded model casts once and :func:`encode` costs nothing."""
    if not precision.is_bf16:
        return params
    return {
        k: (v.to(torch.bfloat16) if k in _MATMUL_LEAVES else v)
        for k, v in params.items()
    }


def encode(
    params: Params,
    x: torch.Tensor,
    cfg: EncoderConfig,
    mask: Optional[torch.Tensor] = None,
    pos: Optional[torch.Tensor] = None,
    pos_each_block: bool = False,
    precision: Precision = FP32,
    remat: Any = None,
) -> torch.Tensor:
    """Run the full encoder as a loop over the stacked layer params.

    Args:
      params: stacked tree from :func:`init` / the checkpoint converter.
      x: [B, T, D] token sequence (any dtype; computed per ``precision``).
      mask: optional [B, T] bool keep-mask for padded/ragged batches.
      pos: optional [B, T, D] (or [1, T, D]) positional embedding.
      pos_each_block: if True, adds ``pos`` at the input of every block
        (point-cloud backbone semantics); if False and ``pos`` is given,
        adds it once before the stack.
      remat: overrides ``cfg.remat`` when not None (see EncoderConfig).
    """
    if remat is None:
        remat = cfg.remat
    if remat == "save":
        # Autograd keeps every intermediate of the plain block, which is
        # what the reference's save policy asks of XLA. The fused sublayers
        # keep none, so the policy only applies on the "xla" path.
        impl = _resolve_impl(cfg, x.shape[1], precision)
        if impl == "fused":
            impl = "xla"
        cfg = dataclasses.replace(cfg, attn_impl=impl)
    # The residual stream stays in the compute dtype; LN accumulates fp32.
    x = x.to(precision.compute_dtype)
    params = cast_params(params, precision)
    if pos is not None and not pos_each_block:
        x = x + pos.to(x.dtype)
    # unbind, not v[i]: its backward is one stack per leaf, not a zero-filled
    # [depth, ...] tensor per layer.
    layers = {k: v.unbind(0) for k, v in params.items()}
    depth = params["norm1_scale"].shape[0]
    for i in range(depth):
        if pos_each_block and pos is not None:
            x = x + pos.to(x.dtype)
        p = {k: v[i] for k, v in layers.items()}
        if remat is True and torch.is_grad_enabled():
            x = torch.utils.checkpoint.checkpoint(
                block, x, p, cfg, mask, precision, use_reentrant=False
            )
        else:
            x = block(x, p, cfg, mask, precision)
    return x
