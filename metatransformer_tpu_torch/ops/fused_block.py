"""Fused transformer sublayers for short sequences: hand-written CUDA
kernels for Hopper, each beside its plain PyTorch version.

Port of ``metatransformer_tpu/ops/fused_block.py``, forward only:

* :func:`attn_sublayer` computes ``x + proj(MHSA(LN(x)))`` and replaces
  the Pallas kernel ``_kernel`` (``ops/fused_block.py:82``);
* :func:`mlp_sublayer` computes ``x + fc2(GELU(fc1(LN(x))))`` and
  replaces ``_mlp_kernel`` (``ops/fused_block.py:562``).

Dispatch depends only on where ``x`` lies. A CPU tensor runs the plain
version (:func:`attn_sublayer_plain`, :func:`mlp_sublayer_plain`); a CUDA
tensor launches the kernels of ``csrc/fused_block.cu`` or raises. There is
no fallback between the two. Each CUDA wrapper counts its launches in a
plain int attribute (``attn_sublayer_cuda.launches``), so a run can show
that it went through the kernels.

The plain versions round at the kernels' cast points: LayerNorm statistics
in fp32; every matmul accumulates in fp32 over inputs in ``x.dtype`` and
adds its bias in fp32; the scale is folded into q in fp32 before the cast;
softmax is normalised after P.V. Under fp32 they are the reference's
kernels at fp32.

One deliberate difference from the reference: the MLP uses exact erf GELU,
as ``core.encoder.mlp`` and timm do. The Pallas kernel used the tanh form
only because erf has no Pallas TPU lowering; Hopper has ``erff``.

The backward kernel (reference ``_bwd_kernel``) belongs to the training
slice; the CUDA wrappers refuse inputs that require grad.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

NEG_INF = -1e30
# Above this length the reference switches to flash attention.
MAX_SEQ = 512
# The reference's VMEM bound on heads x T^2 (ops/fused_block.py:52). The
# CUDA kernels stream K/V and take any T; the bound is kept so that
# supported(), and with it the encoder's dispatch, is the reference's.
_VMEM_LOGIT_ELEMS = 2_500_000


def supported(seq_len: int, dim: int, num_heads: int) -> bool:
    """Shapes where the fused sublayers apply (the reference's gate)."""
    head_dim = dim // num_heads
    return (
        seq_len <= MAX_SEQ
        and dim % num_heads == 0
        and head_dim in (32, 64, 128)
        and dim % 128 == 0
        and num_heads * seq_len * seq_len <= _VMEM_LOGIT_ELEMS
    )


# --------------------------------------------------------------------------
# Plain PyTorch versions
# --------------------------------------------------------------------------


def _layer_norm(x, scale, bias, eps):
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    xn = (xf - mean) * torch.rsqrt(var + eps)
    return (xn * scale.float() + bias.float()).to(x.dtype)


def _linear_f32(a, w, b):
    """``a @ w + b`` accumulated in fp32 over inputs in ``a.dtype``."""
    return a.float() @ w.to(a.dtype).float() + b.float()


def attn_sublayer_plain(
    x, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, proj_b, bias, *, num_heads, ln_eps
):
    """Plain version of the attention sublayer kernel.

    ``bias`` is the [B, T] fp32 additive key mask (0 / NEG_INF) or None.
    """
    b, t, d = x.shape
    hd = d // num_heads
    dt = x.dtype
    xn = _layer_norm(x, ln_scale, ln_bias, ln_eps)
    qkv = _linear_f32(xn, qkv_w, qkv_b).to(dt).reshape(b, t, 3, num_heads, hd)
    q, k, v = qkv.unbind(2)  # [B, T, H, hd]
    q = (q.float() * (float(hd) ** -0.5)).to(dt)
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
    if bias is not None:
        s = s + bias[:, None, None, :]
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhts,bshd->bhtd", p.to(dt).float(), v.float())
    o = (o / l).to(dt).transpose(1, 2).reshape(b, t, d)
    return x + _linear_f32(o, proj_w, proj_b).to(dt)


def mlp_sublayer_plain(x, ln_scale, ln_bias, fc1_w, fc1_b, fc2_w, fc2_b, *, ln_eps):
    """Plain version of the MLP sublayer kernel (exact erf GELU in fp32)."""
    dt = x.dtype
    xn = _layer_norm(x, ln_scale, ln_bias, ln_eps)
    h = torch.nn.functional.gelu(_linear_f32(xn, fc1_w, fc1_b)).to(dt)
    return x + _linear_f32(h, fc2_w, fc2_b).to(dt)


# --------------------------------------------------------------------------
# CUDA wrappers
# --------------------------------------------------------------------------


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _check_no_grad(*tensors):
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "the CUDA fused sublayers are forward-only: their backward kernel "
            "belongs to the training slice (ROADMAP.md queue 2, kernel 3)"
        )


def _check_gemm_dims(k: int, n: int):
    # The GEMM loads 32-deep K slabs and 8-wide (16-byte) column chunks.
    if k % 32 or n % 8:
        raise ValueError(f"GEMM dims K={k}, N={n}: need K % 32 == 0, N % 8 == 0")


def _raise_on(rc: int, what: str):
    if rc != 0:
        from metatransformer_tpu_torch.ops import _build

        msg = _build.library().mt_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({rc})")


def attn_sublayer_cuda(
    x, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, proj_b, bias, *, num_heads, ln_eps
):
    """Launch the attention sublayer kernels (LayerNorm, QKV GEMM, attention
    core, proj GEMM + residual). x, weights and matmul biases bf16; LN
    params and the key bias fp32."""
    from metatransformer_tpu_torch.ops import _build

    _check_no_grad(x, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, proj_b)
    if x.dim() != 3:
        raise ValueError(f"x must be [B, T, D], got {tuple(x.shape)}")
    b, t, d = x.shape
    if d % num_heads or d // num_heads not in (32, 64, 128):
        raise ValueError(f"head_dim {d}/{num_heads} not in (32, 64, 128)")
    _check_gemm_dims(d, 3 * d)
    dev, bf, f32 = x.device, torch.bfloat16, torch.float32
    _check("x", x, bf, (b, t, d), dev)
    _check("ln_scale", ln_scale, f32, (d,), dev)
    _check("ln_bias", ln_bias, f32, (d,), dev)
    _check("qkv_w", qkv_w, bf, (d, 3 * d), dev)
    _check("qkv_b", qkv_b, bf, (3 * d,), dev)
    _check("proj_w", proj_w, bf, (d, d), dev)
    _check("proj_b", proj_b, bf, (d,), dev)
    if bias is not None:
        _check("bias", bias, f32, (b, t), dev)
    lib = _build.library()
    xn = torch.empty_like(x)
    qkv = torch.empty((b, t, 3 * d), dtype=bf, device=dev)
    o = torch.empty_like(x)
    out = torch.empty_like(x)
    bias_ptr = None if bias is None else bias.data_ptr()
    with torch.cuda.device(dev):  # the launches go to dev's current stream
        rc = lib.mt_attn_sublayer(
            x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
            qkv_w.data_ptr(), qkv_b.data_ptr(), proj_w.data_ptr(), proj_b.data_ptr(),
            bias_ptr, xn.data_ptr(), qkv.data_ptr(), o.data_ptr(), out.data_ptr(),
            b, t, d, num_heads, ctypes.c_float(ln_eps),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(rc, "attn_sublayer")
    attn_sublayer_cuda.launches += 1
    return out


attn_sublayer_cuda.launches = 0


def mlp_sublayer_cuda(x, ln_scale, ln_bias, fc1_w, fc1_b, fc2_w, fc2_b, *, ln_eps):
    """Launch the MLP sublayer kernels (LayerNorm, fc1 GEMM + GELU, fc2 GEMM
    + residual) on [..., D] rows. x, weights and biases bf16; LN params
    fp32."""
    from metatransformer_tpu_torch.ops import _build

    _check_no_grad(x, ln_scale, ln_bias, fc1_w, fc1_b, fc2_w, fc2_b)
    d = x.shape[-1]
    rows = math.prod(x.shape[:-1])
    f = fc1_w.shape[-1]
    _check_gemm_dims(d, f)
    _check_gemm_dims(f, d)
    dev, bf, f32 = x.device, torch.bfloat16, torch.float32
    _check("x", x, bf, x.shape, dev)
    _check("ln_scale", ln_scale, f32, (d,), dev)
    _check("ln_bias", ln_bias, f32, (d,), dev)
    _check("fc1_w", fc1_w, bf, (d, f), dev)
    _check("fc1_b", fc1_b, bf, (f,), dev)
    _check("fc2_w", fc2_w, bf, (f, d), dev)
    _check("fc2_b", fc2_b, bf, (d,), dev)
    lib = _build.library()
    xn = torch.empty_like(x)
    h = torch.empty((rows, f), dtype=bf, device=dev)
    out = torch.empty_like(x)
    with torch.cuda.device(dev):  # the launches go to dev's current stream
        rc = lib.mt_mlp_sublayer(
            x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
            fc1_w.data_ptr(), fc1_b.data_ptr(), fc2_w.data_ptr(), fc2_b.data_ptr(),
            xn.data_ptr(), h.data_ptr(), out.data_ptr(),
            rows, d, f, ctypes.c_float(ln_eps),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(rc, "mlp_sublayer")
    mlp_sublayer_cuda.launches += 1
    return out


mlp_sublayer_cuda.launches = 0


def launch_counts() -> dict:
    return {
        "attn_sublayer": attn_sublayer_cuda.launches,
        "mlp_sublayer": mlp_sublayer_cuda.launches,
    }


def reset_launch_counts() -> None:
    attn_sublayer_cuda.launches = 0
    mlp_sublayer_cuda.launches = 0


# --------------------------------------------------------------------------
# Public ops: dispatch on the tensor's device
# --------------------------------------------------------------------------


def _route(x: torch.Tensor, plain, cuda):
    if x.device.type == "cpu":
        return plain
    if x.device.type == "cuda":
        return cuda
    raise NotImplementedError(f"fused sublayers run on cpu or cuda, not {x.device}")


def mlp_sublayer(
    x: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    fc1_w: torch.Tensor,
    fc1_b: torch.Tensor,
    fc2_w: torch.Tensor,
    fc2_b: torch.Tensor,
    *,
    ln_eps: float = 1e-5,
) -> torch.Tensor:
    """Fused ``x + fc2(GELU(fc1(LN(x))))``: the second half of a timm Block.

    Row-independent: [B, T, D] is processed as [B*T, D] rows.
    """
    fn = _route(x, mlp_sublayer_plain, mlp_sublayer_cuda)
    return fn(x, ln_scale, ln_bias, fc1_w, fc1_b, fc2_w, fc2_b, ln_eps=float(ln_eps))


def attn_sublayer(
    x: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    qkv_w: torch.Tensor,
    qkv_b: torch.Tensor,
    proj_w: torch.Tensor,
    proj_b: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    *,
    num_heads: int,
    ln_eps: float = 1e-5,
) -> torch.Tensor:
    """Fused ``x + proj(MHSA(LN(x)))``.

    Args:
      x: [B, T, D] residual stream (bf16 for the serving policy).
      qkv_w: [D, 3D] fused projection, columns ordered (q|k|v) x heads,
        the layout of :func:`core.encoder.param_shapes`.
      mask: optional [B, T] bool keep-mask for padded/ragged batches.
    """
    fn = _route(x, attn_sublayer_plain, attn_sublayer_cuda)
    bias = None
    if mask is not None:
        bias = torch.where(mask, 0.0, NEG_INF).to(device=x.device, dtype=torch.float32)
    return fn(
        x, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, proj_b, bias,
        num_heads=num_heads, ln_eps=float(ln_eps),
    )
