"""Flash attention for long sequences: hand-written CUDA kernels for
Hopper, each beside its plain PyTorch version.

Port of ``metatransformer_tpu/ops/flash_attention.py``. It computes
``softmax(q k^T * scale + bias) v`` with an online softmax, so the [T, T]
logits never reach device memory, forward or backward:

* :func:`flash_fwd_cuda` replaces the Pallas kernel ``_fwd_kernel``
  (``ops/flash_attention.py:70``) and also emits the per-row
  ``lse = m + log l``;
* :func:`flash_bwd_dq_cuda` replaces ``_bwd_dq_kernel`` (``:137``);
* :func:`flash_bwd_dkv_cuda` replaces ``_bwd_dkv_kernel`` (``:176``).

Layout: q, k, v are ``[B, T, H, d]`` (the encoder's layout) and may be
strided views of one ``[B, T, 3, H, d]`` projection; the kernels index them
by strides, so nothing is padded, transposed or copied. A ragged batch
passes a ``[B, T]`` keep-mask, which becomes one additive fp32 bias row per
sample (0 / ``NEG_INF``) shared by its heads. ``lse`` and ``delta`` are
``[B, H, T]`` fp32.

Dispatch depends only on where ``q`` lies. A CPU tensor runs the plain
versions (:func:`flash_attention_plain`, :func:`flash_attention_bwd_plain`);
a CUDA tensor launches the kernels of ``csrc/flash_attention.cu`` or raises.
There is no fallback between the two. bf16 inputs run on the tensor cores,
fp32 inputs on plain fp32 FMAs. Each CUDA wrapper counts its launches in a
plain int attribute (``flash_fwd_cuda.launches``).

The plain versions round at the kernels' cast points: logits are ``q . k``
accumulated in fp32, times ``scale``, plus the bias (the scale is not
folded into q); ``p`` is rounded to v's dtype before ``p v``; the output is
divided by ``max(l, 1e-30)`` at the end. The backward forms
``p = exp(s - lse)`` from the forward's fp32 lse, rounds ``ds`` to k's dtype
and ``p`` to dO's dtype before the products, scales dq and dk after the
sum and leaves dv unscaled. They take the row maximum over all keys at
once where the kernels update it tile by tile, which differs only in
rounding.

A fully masked sample (every key at ``NEG_INF``) gives a uniform ``p`` over
its T keys: finite, no NaN. The reference pads T and spreads that ``p`` over
the padded keys too, so the two agree only on samples with a kept key.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from metatransformer_tpu_torch.ops import fused_block as _fb

NEG_INF = -1e30
_HEAD_DIMS = (32, 64, 128)


def supported(seq_len: int, head_dim: int) -> bool:
    """Where the encoder's ``attn_impl="auto"`` picks flash attention (the
    reference's gate)."""
    return head_dim in _HEAD_DIMS and seq_len >= 512


# --------------------------------------------------------------------------
# Plain PyTorch versions
# --------------------------------------------------------------------------


def _logits(q, k, bias, scale):
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias[:, None, None, :]
    return s  # [B, H, T, S] fp32


def flash_attention_plain(q, k, v, bias, scale) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: ``(o [B, T, H, d] in q's dtype,
    lse [B, H, T] fp32)``. ``bias`` is the [B, T] fp32 additive key bias or
    None."""
    dt = q.dtype
    s = _logits(q, k, bias, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)  # [B, H, T, 1]
    acc = torch.einsum("bhts,bshd->bthd", p.to(dt).float(), v.float())
    o = (acc / l.transpose(1, 2)).to(dt)
    return o, (m + torch.log(l)).squeeze(-1)


def flash_bwd_dq_plain(q, k, v, bias, do, lse, delta, scale, out=None):
    """Plain version of the dq kernel. ``lse``, ``delta``: [B, H, T] fp32.
    ``out`` is the kernel wrapper's and is ignored here."""
    dt = q.dtype
    p = torch.exp(_logits(q, k, bias, scale) - lse[..., None])
    dp = torch.einsum("bthd,bshd->bhts", do.to(dt).float(), v.float())
    ds = (p * (dp - delta[..., None])).to(dt).float()
    return (torch.einsum("bhts,bshd->bthd", ds, k.float()) * scale).to(dt)


def flash_bwd_dkv_plain(q, k, v, bias, do, lse, delta, scale, out=None):
    """Plain version of the dk/dv kernel: ``(dk, dv)`` in q's dtype.
    ``out`` is the kernel wrapper's and is ignored here."""
    dt = q.dtype
    p = torch.exp(_logits(q, k, bias, scale) - lse[..., None])
    dp = torch.einsum("bthd,bshd->bhts", do.to(dt).float(), v.float())
    ds = (p * (dp - delta[..., None])).to(dt).float()
    dk = (torch.einsum("bhts,bthd->bshd", ds, q.float()) * scale).to(dt)
    dv = torch.einsum("bhts,bthd->bshd", p.to(dt).float(), do.to(dt).float()).to(dt)
    return dk, dv


def _delta(o, do):
    """``rowsum(dO * O)`` in fp32 as [B, H, T]."""
    return (do.float() * o.float()).sum(dim=-1).transpose(1, 2).contiguous()


def flash_attention_bwd_plain(q, k, v, bias, o, lse, do, scale):
    """Plain version of the whole backward: ``(dq, dk, dv)`` from the
    forward's inputs, output and lse and the output cotangent ``do``."""
    delta = _delta(o, do)
    dq = flash_bwd_dq_plain(q, k, v, bias, do, lse, delta, scale)
    dk, dv = flash_bwd_dkv_plain(q, k, v, bias, do, lse, delta, scale)
    return dq, dk, dv


# --------------------------------------------------------------------------
# CUDA wrappers
# --------------------------------------------------------------------------


def _chunk(dtype) -> int:
    return 8 if dtype == torch.bfloat16 else 4  # elements in 16 bytes


def _indexable(t) -> bool:
    """Whether the kernels can index ``t`` by strides: last axis contiguous,
    every other stride and the base address a multiple of 16 bytes."""
    c = _chunk(t.dtype)
    rows_aligned = not any(s % c for s in t.stride()[:-1])
    return t.stride(-1) == 1 and rows_aligned and t.data_ptr() % 16 == 0


def _check_strided(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not _indexable(t):
        raise ValueError(
            f"{name}: strides {t.stride()} need a contiguous last axis and 16-byte "
            f"aligned rows"
        )


def _check_qkv(q, k, v, bias):
    if q.dim() != 4:
        raise ValueError(f"q must be [B, T, H, d], got {tuple(q.shape)}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the kernels take bf16 or fp32, got {q.dtype}")
    b, t, h, d = q.shape
    if d not in _HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {_HEAD_DIMS}")
    if min(b, t, h) < 1:
        raise ValueError(f"empty input {tuple(q.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_strided(name, x, q.shape, q.dtype, q.device)
        if x.stride() != q.stride():
            raise ValueError(f"{name} strides {x.stride()} differ from q's {q.stride()}")
    if bias is not None:
        _fb._check("bias", bias, torch.float32, (b, t), q.device)


def _check_stats(q, **stats):
    b, t, h, _ = q.shape
    for name, x in stats.items():
        _fb._check(name, x, torch.float32, (b, h, t), q.device)


def _ptr(t):
    return None if t is None else t.data_ptr()


def flash_fwd_cuda(q, k, v, bias, scale) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel. q, k, v: [B, T, H, d] bf16 or fp32 with
    equal strides; bias: [B, T] fp32 or None. Returns ``(o, lse)``."""
    from metatransformer_tpu_torch.ops import _build

    _check_qkv(q, k, v, bias)
    b, t, h, d = q.shape
    lib = _build.library()
    o = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):  # the launch goes to this device's current stream
        rc = lib.mt_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias), o.data_ptr(),
            lse.data_ptr(), b, t, h, d, *q.stride()[:3], ctypes.c_float(scale),
            int(q.dtype == torch.float32), torch.cuda.current_stream().cuda_stream,
        )
    _fb._raise_on(rc, "flash_fwd")
    flash_fwd_cuda.launches += 1
    return o, lse


flash_fwd_cuda.launches = 0


def _check_bwd(q, k, v, bias, do, lse, delta, outs):
    _check_qkv(q, k, v, bias)
    _fb._check("do", do, q.dtype, q.shape, q.device)
    _check_stats(q, lse=lse, delta=delta)
    for name, x in outs:
        _check_strided(name, x, q.shape, q.dtype, q.device)
        if x.stride() != outs[0][1].stride():
            raise ValueError(f"{name} strides differ from {outs[0][0]}'s")


def flash_bwd_dq_cuda(q, k, v, bias, do, lse, delta, scale, out=None):
    """Launch the dq kernel. ``do`` contiguous [B, T, H, d] in q's dtype;
    ``lse``, ``delta`` [B, H, T] fp32. ``out``: an optional [B, T, H, d]
    (strided) tensor to write into."""
    from metatransformer_tpu_torch.ops import _build

    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device) if out is None else out
    _check_bwd(q, k, v, bias, do, lse, delta, [("dq", dq)])
    b, t, h, d = q.shape
    lib = _build.library()
    with torch.cuda.device(q.device):
        rc = lib.mt_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, t, h, d,
            *q.stride()[:3], *dq.stride()[:3], ctypes.c_float(scale),
            int(q.dtype == torch.float32), torch.cuda.current_stream().cuda_stream,
        )
    _fb._raise_on(rc, "flash_bwd_dq")
    flash_bwd_dq_cuda.launches += 1
    return dq


flash_bwd_dq_cuda.launches = 0


def flash_bwd_dkv_cuda(q, k, v, bias, do, lse, delta, scale, out=None):
    """Launch the dk/dv kernel; arguments as :func:`flash_bwd_dq_cuda`.
    ``out``: an optional ``(dk, dv)`` pair with equal strides."""
    from metatransformer_tpu_torch.ops import _build

    if out is None:
        out = tuple(torch.empty(q.shape, dtype=q.dtype, device=q.device) for _ in range(2))
    dk, dv = out
    _check_bwd(q, k, v, bias, do, lse, delta, [("dk", dk), ("dv", dv)])
    b, t, h, d = q.shape
    lib = _build.library()
    with torch.cuda.device(q.device):
        rc = lib.mt_flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, t, h, d,
            *q.stride()[:3], *dk.stride()[:3], ctypes.c_float(scale),
            int(q.dtype == torch.float32), torch.cuda.current_stream().cuda_stream,
        )
    _fb._raise_on(rc, "flash_bwd_dkv")
    flash_bwd_dkv_cuda.launches += 1
    return dk, dv


flash_bwd_dkv_cuda.launches = 0


def launch_counts() -> dict:
    return {
        "flash_fwd": flash_fwd_cuda.launches,
        "flash_bwd_dq": flash_bwd_dq_cuda.launches,
        "flash_bwd_dkv": flash_bwd_dkv_cuda.launches,
    }


def reset_launch_counts() -> None:
    flash_fwd_cuda.launches = 0
    flash_bwd_dq_cuda.launches = 0
    flash_bwd_dkv_cuda.launches = 0


# --------------------------------------------------------------------------
# Dispatch on the tensor's device, and the gradient hookup
# --------------------------------------------------------------------------


def _backward(q, k, v, bias, o, lse, do, scale):
    """(dq, dk, dv): delta as a torch reduction in fp32, then the two
    backward kernels (or their plain versions on the CPU). On the card the
    three gradients are views of one [B, T, 3, H, d] buffer."""
    dq_fn = _fb._route(q, flash_bwd_dq_plain, flash_bwd_dq_cuda)
    dkv_fn = _fb._route(q, flash_bwd_dkv_plain, flash_bwd_dkv_cuda)
    do = do.to(q.dtype).contiguous()
    delta = _delta(o, do)
    dq_out = dkv_out = None
    if q.device.type == "cuda":
        b, t, h, d = q.shape
        dq_out, dk_out, dv_out = torch.empty(
            (b, t, 3, h, d), dtype=q.dtype, device=q.device
        ).unbind(2)
        dkv_out = (dk_out, dv_out)
    dq = dq_fn(q, k, v, bias, do, lse, delta, scale, out=dq_out)
    dk, dv = dkv_fn(q, k, v, bias, do, lse, delta, scale, out=dkv_out)
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """Flash attention with the kernel backward. Saves q, k, v, the bias,
    the output and the per-row lse: nothing of size [T, T]."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        fn = _fb._route(q, flash_attention_plain, flash_fwd_cuda)
        o, lse = fn(q, k, v, bias, scale)
        ctx.save_for_backward(q, k, v, bias, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, o, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, bias, o, lse, g, ctx.scale)
        # the bias is mask-derived (0 / NEG_INF), never a differentiation target
        return dq, dk, dv, None, None


def _kernel_layout(q, k, v):
    """q, k, v as the kernels index them: equal strides, last axis
    contiguous, 16-byte aligned rows. Views of one fused projection pass
    through untouched; anything else is copied."""
    if all(x.stride() == q.stride() and _indexable(x) for x in (q, k, v)):
        return q, k, v
    return tuple(x.contiguous() for x in (q, k, v))


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Masked flash attention. q, k, v: [B, T, H, d]; mask: [B, T] keep-bool.
    Returns [B, T, H, d] in q's dtype."""
    if not (q.shape == k.shape == v.shape and q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k, v must share shape and dtype")
    d = q.shape[-1]
    scale = float(d) ** -0.5 if scale is None else float(scale)
    bias = None
    if mask is not None:
        bias = torch.where(mask, 0.0, NEG_INF).to(device=q.device, dtype=torch.float32)
    if q.device.type == "cuda":
        q, k, v = _kernel_layout(q, k, v)
    if not _fb._wants_grad(q, k, v):  # serving: straight to the kernel
        fn = _fb._route(q, flash_attention_plain, flash_fwd_cuda)
        return fn(q, k, v, bias, scale)[0]
    return _Flash.apply(q, k, v, bias, scale)
