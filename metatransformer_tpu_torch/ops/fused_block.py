"""Fused transformer sublayers for short sequences: hand-written CUDA
kernels for Hopper, each beside its plain PyTorch version.

Port of ``metatransformer_tpu/ops/fused_block.py``:

* :func:`attn_sublayer` computes ``x + proj(MHSA(LN(x)))`` and replaces
  the Pallas kernel ``_kernel`` (``ops/fused_block.py:82``);
* :func:`mlp_sublayer` computes ``x + fc2(GELU(fc1(LN(x))))`` and
  replaces ``_mlp_kernel`` (``ops/fused_block.py:562``);
* the backward of :func:`attn_sublayer` replaces ``_bwd_kernel``
  (``ops/fused_block.py:310``) at the call boundary of ``_bwd_via_kernel``:
  the kernel recomputes LayerNorm, QKV and softmax and emits dx, dqkv, xn,
  o, dgamma, dbeta; the four weight-gradient reductions are library
  matmuls and sums outside it, skipped where no gradient is needed.

Dispatch depends only on where ``x`` lies. A CPU tensor runs the plain
version (:func:`attn_sublayer_plain`, :func:`mlp_sublayer_plain`,
:func:`attn_sublayer_bwd_plain`); a CUDA tensor launches the kernels of
``csrc/`` or raises. There is no fallback between the two. Each CUDA
wrapper counts its launches in a plain int attribute
(``attn_sublayer_cuda.launches``), so a run can show that it went through
the kernels.

Both public ops are :class:`torch.autograd.Function` s. Neither keeps
activations beyond its inputs: the attention backward is the kernel above,
and the MLP backward recomputes LayerNorm, fc1 and GELU with library
matmuls in the compute dtype (the reference leaves that step to XLA too).

The plain versions round at the kernels' cast points: LayerNorm statistics
in fp32; every matmul accumulates in fp32 over inputs in ``x.dtype`` and
adds its bias in fp32; the scale is folded into q in fp32 before the cast;
softmax is normalised after P.V. Under fp32 they are the reference's
kernels at fp32.

One deliberate difference from the reference: the MLP uses exact erf GELU,
as ``core.encoder.mlp`` and timm do, in the forward and in the backward.
The Pallas kernel used the tanh form only because erf has no Pallas TPU
lowering; Hopper has ``erff``.
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
    dt = x.dtype
    xn = _layer_norm(x, ln_scale, ln_bias, ln_eps)
    qkv = _linear_f32(xn, qkv_w, qkv_b).to(dt)
    o = attention_core_plain(qkv, bias, num_heads=num_heads)
    return x + _linear_f32(o, proj_w, proj_b).to(dt)


def attention_core_plain(qkv, bias, *, num_heads):
    """Plain version of the sublayer's attention core: [B, T, 3D] QKV
    (columns (q|k|v) x heads) -> [B, T, D] in ``qkv.dtype``. q is scaled in
    fp32 and rounded, the row max is global, P is rounded before P.V and
    the output is normalised after it."""
    b, t, d3 = qkv.shape
    d = d3 // 3
    hd = d // num_heads
    dt = qkv.dtype
    q, k, v = qkv.reshape(b, t, 3, num_heads, hd).unbind(2)  # [B, T, H, hd]
    q = (q.float() * (float(hd) ** -0.5)).to(dt)
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
    if bias is not None:
        s = s + bias[:, None, None, :]
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhts,bshd->bhtd", p.to(dt).float(), v.float())
    return (o / l).to(dt).transpose(1, 2).reshape(b, t, d)


def mlp_sublayer_plain(x, ln_scale, ln_bias, fc1_w, fc1_b, fc2_w, fc2_b, *, ln_eps):
    """Plain version of the MLP sublayer kernel (exact erf GELU in fp32)."""
    dt = x.dtype
    xn = _layer_norm(x, ln_scale, ln_bias, ln_eps)
    h = torch.nn.functional.gelu(_linear_f32(xn, fc1_w, fc1_b)).to(dt)
    return x + _linear_f32(h, fc2_w, fc2_b).to(dt)


def _matmul_f32(a, b, dt):
    """``a @ b`` accumulated in fp32 over operands rounded to ``dt``."""
    return a.to(dt).float() @ b.to(dt).float()


def attn_sublayer_bwd_plain(
    x, g, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, bias, *, num_heads, ln_eps
):
    """Plain version of the attention-sublayer backward kernel.

    The body of the reference's ``_bwd_kernel`` step by step, with its cast
    points. Returns ``(dx, dqkv, xn, o, dlns, dlnb)``: dx, xn, o [B, T, D]
    and dqkv [B, T, 3D] in ``x.dtype``; dlns, dlnb [D] fp32.
    """
    b, t, d = x.shape
    hd = d // num_heads
    dt = x.dtype
    scale = float(hd) ** -0.5
    # 1. LayerNorm in fp32, QKV recompute
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + ln_eps)
    xhat = (xf - mean) * rstd
    gamma = ln_scale.float()
    xn = (xhat * gamma + ln_bias.float()).to(dt)
    qkv = _linear_f32(xn, qkv_w, qkv_b).to(dt).reshape(b, t, 3, num_heads, hd)
    q, k, v = (a.transpose(1, 2).float() for a in qkv.unbind(2))  # [B, H, T, hd]
    # 2. do = g Wproj^T
    do = _matmul_f32(g, proj_w.t(), dt).to(dt)
    do = do.reshape(b, t, num_heads, hd).transpose(1, 2).float()
    # 3. attention backward per sample and head
    s = (q * scale).to(dt).float() @ k.transpose(-1, -2)
    if bias is not None:
        s = s + bias[:, None, None, :]
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    pb = p.to(dt).float()
    o = (pb @ v).to(dt)
    dv = (pb.transpose(-1, -2) @ do).to(dt)
    dp = do @ v.transpose(-1, -2)
    ds = (p * (dp - (dp * p).sum(dim=-1, keepdim=True))).to(dt).float()
    dq = ((ds @ k) * scale).to(dt)
    dk = ((ds.transpose(-1, -2) @ q) * scale).to(dt)  # the unscaled q
    merge = lambda a: a.transpose(1, 2).reshape(b, t, d)
    dqkv = torch.cat([merge(dq), merge(dk), merge(dv)], dim=-1)
    o = merge(o)
    # 4. dxn = dqkv Wqkv^T in fp32, LayerNorm backward
    dxn = _matmul_f32(dqkv, qkv_w.t(), dt)
    dxhat = dxn * gamma
    mr1 = dxhat.mean(dim=-1, keepdim=True)
    mr2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    dx = (g.float() + rstd * (dxhat - mr1 - xhat * mr2)).to(dt)
    # 5. LayerNorm parameter gradients over all rows
    dlns = (dxn * xhat).sum(dim=(0, 1))
    dlnb = dxn.sum(dim=(0, 1))
    return dx, dqkv, xn, o, dlns, dlnb


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


def _check_gemm_dims(k: int, n: int):
    # The wgmma GEMM (csrc/gemm_sm90.cuh) runs 64-deep K slabs and 128-wide
    # output tiles. No config loses the fused path by this: supported()
    # already asks for D % 128 == 0, and every EncoderConfig the port builds
    # leaves mlp_ratio at its default 4, so F = 4 D.
    if k % 64 or n % 128:
        raise ValueError(
            f"GEMM dims K={k}, N={n}: the wgmma GEMM takes K % 64 == 0 and N % 128 == 0"
        )


def _raise_on(rc: int, what: str):
    if rc != 0:
        from metatransformer_tpu_torch.ops import _build

        msg = _build.library().mt_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({rc})")


def _check_attn_inputs(x, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, bias, num_heads):
    if x.dim() != 3:
        raise ValueError(f"x must be [B, T, D], got {tuple(x.shape)}")
    b, t, d = x.shape
    if d % num_heads or d // num_heads not in (32, 64, 128):
        raise ValueError(f"head_dim {d}/{num_heads} not in (32, 64, 128)")
    _check_gemm_dims(d, 3 * d)  # QKV (and its recompute in the backward)
    _check_gemm_dims(d, d)  # proj (g Wproj^T in the backward)
    dev, bf, f32 = x.device, torch.bfloat16, torch.float32
    _check("x", x, bf, (b, t, d), dev)
    _check("ln_scale", ln_scale, f32, (d,), dev)
    _check("ln_bias", ln_bias, f32, (d,), dev)
    _check("qkv_w", qkv_w, bf, (d, 3 * d), dev)
    _check("qkv_b", qkv_b, bf, (3 * d,), dev)
    _check("proj_w", proj_w, bf, (d, d), dev)
    if bias is not None:
        _check("bias", bias, f32, (b, t), dev)


def attn_sublayer_cuda(
    x, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, proj_b, bias, *, num_heads, ln_eps
):
    """Launch the attention sublayer kernels (LayerNorm, QKV GEMM, attention
    core, proj GEMM + residual; every product on wgmma). x, weights and
    matmul biases bf16; LN params and the key bias fp32. D must be a
    multiple of 128 (the GEMM's tiles); anything else raises before a
    launch."""
    from metatransformer_tpu_torch.ops import _build

    _check_attn_inputs(x, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, bias, num_heads)
    b, t, d = x.shape
    dev, bf = x.device, torch.bfloat16
    _check("proj_b", proj_b, bf, (d,), dev)
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


def attn_sublayer_bwd_cuda(
    x, g, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, bias, *, num_heads, ln_eps
):
    """Launch the attention-sublayer backward kernels. Same argument types
    as :func:`attn_sublayer_cuda`, plus the output cotangent ``g`` (bf16,
    like x). Returns ``(dx, dqkv, xn, o, dlns, dlnb)``."""
    from metatransformer_tpu_torch.ops import _build

    _check_attn_inputs(x, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, bias, num_heads)
    b, t, d = x.shape
    dev, bf, f32 = x.device, torch.bfloat16, torch.float32
    _check("g", g, bf, (b, t, d), dev)
    lib = _build.library()
    rows = b * t
    empty = lambda shape, dtype: torch.empty(shape, dtype=dtype, device=dev)
    dx, xn, o = torch.empty_like(x), torch.empty_like(x), torch.empty_like(x)
    dqkv = empty((b, t, 3 * d), bf)
    dlns, dlnb = empty((d,), f32), empty((d,), f32)
    # scratch that never leaves this call
    qkv, d_o = empty((b, t, 3 * d), bf), empty((b, t, d), bf)
    dxn = empty((b, t, d), f32)
    stats = empty((3, b, num_heads, t), f32)
    row_stats = empty((2, rows), f32)
    partial = empty((lib.mt_ln_grad_chunks(rows), 2, d), f32)
    bias_ptr = None if bias is None else bias.data_ptr()
    with torch.cuda.device(dev):  # the launches go to dev's current stream
        rc = lib.mt_attn_sublayer_bwd(
            x.data_ptr(), g.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
            qkv_w.data_ptr(), qkv_b.data_ptr(), proj_w.data_ptr(), bias_ptr,
            dx.data_ptr(), dqkv.data_ptr(), xn.data_ptr(), o.data_ptr(),
            dlns.data_ptr(), dlnb.data_ptr(), qkv.data_ptr(), d_o.data_ptr(),
            dxn.data_ptr(), stats.data_ptr(), row_stats.data_ptr(), partial.data_ptr(),
            b, t, d, num_heads, ctypes.c_float(ln_eps),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(rc, "attn_sublayer_bwd")
    attn_sublayer_bwd_cuda.launches += 1
    return dx, dqkv, xn, o, dlns, dlnb


attn_sublayer_bwd_cuda.launches = 0


def mlp_sublayer_cuda(x, ln_scale, ln_bias, fc1_w, fc1_b, fc2_w, fc2_b, *, ln_eps):
    """Launch the MLP sublayer kernels (LayerNorm, fc1 GEMM + GELU, fc2 GEMM
    + residual, both on wgmma) on [..., D] rows. x, weights and biases bf16;
    LN params fp32. D and F must be multiples of 128 (the GEMM's tiles);
    anything else raises before a launch."""
    from metatransformer_tpu_torch.ops import _build

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


# Library weight-gradient products run by the two backward passes (four per
# attention sublayer, four per MLP sublayer when every weight trains; none
# under a frozen encoder). Counted so a run can show that they were skipped.
_weight_grad_products = {"attn_sublayer": 0, "mlp_sublayer": 0}


def weight_grad_counts() -> dict:
    return dict(_weight_grad_products)


def launch_counts() -> dict:
    return {
        "attn_sublayer": attn_sublayer_cuda.launches,
        "mlp_sublayer": mlp_sublayer_cuda.launches,
        "attn_sublayer_bwd": attn_sublayer_bwd_cuda.launches,
    }


def reset_launch_counts() -> None:
    attn_sublayer_cuda.launches = 0
    mlp_sublayer_cuda.launches = 0
    attn_sublayer_bwd_cuda.launches = 0
    for k in _weight_grad_products:
        _weight_grad_products[k] = 0


# --------------------------------------------------------------------------
# Dispatch on the tensor's device, and the gradient hookup
# --------------------------------------------------------------------------


def _route(x: torch.Tensor, plain, cuda):
    if x.device.type == "cpu":
        return plain
    if x.device.type == "cuda":
        return cuda
    raise NotImplementedError(f"the kernels' wrappers run on cpu or cuda, not {x.device}")


class _AttnSublayer(torch.autograd.Function):
    """``attn_sublayer`` with the kernel backward. Saves only its inputs
    (the residuals of the reference's ``_fused_fwd``)."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, proj_b, bias,
                num_heads, ln_eps):
        fn = _route(x, attn_sublayer_plain, attn_sublayer_cuda)
        ctx.save_for_backward(x, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, proj_b, bias)
        ctx.num_heads, ctx.ln_eps = num_heads, ln_eps
        return fn(x, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, proj_b, bias,
                  num_heads=num_heads, ln_eps=ln_eps)

    @staticmethod
    def backward(ctx, g):
        x, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, proj_b, bias = ctx.saved_tensors
        fn = _route(x, attn_sublayer_bwd_plain, attn_sublayer_bwd_cuda)
        dx, dqkv, xn, o, dlns, dlnb = fn(
            x, g.contiguous(), ln_scale, ln_bias, qkv_w, qkv_b, proj_w, bias,
            num_heads=ctx.num_heads, ln_eps=ctx.ln_eps,
        )
        # Weight gradients: row-contracted library matmuls and sums outside
        # the kernel, each only where its primal needs a gradient (a frozen
        # encoder skips all four).
        need = ctx.needs_input_grad
        d = x.shape[-1]
        g2, dqkv2 = g.reshape(-1, d), dqkv.reshape(-1, 3 * d)
        dwqkv = dbqkv = dwproj = dbproj = None
        if need[3]:
            dwqkv = (xn.reshape(-1, d).t() @ dqkv2).to(qkv_w.dtype)
        if need[4]:
            dbqkv = dqkv2.sum(dim=0, dtype=torch.float32).to(qkv_b.dtype)
        if need[5]:
            dwproj = (o.reshape(-1, d).t() @ g2).to(proj_w.dtype)
        if need[6]:
            dbproj = g2.sum(dim=0, dtype=torch.float32).to(proj_b.dtype)
        _weight_grad_products["attn_sublayer"] += sum(need[3:7])
        return (
            dx if need[0] else None,
            dlns.to(ln_scale.dtype) if need[1] else None,
            dlnb.to(ln_bias.dtype) if need[2] else None,
            dwqkv, dbqkv, dwproj, dbproj, None, None, None,
        )


class _MlpSublayer(torch.autograd.Function):
    """``mlp_sublayer`` with a recompute backward: LayerNorm, fc1 and GELU
    are formed again from x with library matmuls in ``x.dtype`` (fp32
    accumulation); the GELU derivative is the library's one-pass erf-GELU
    backward, and the LayerNorm backward runs in fp32. Saves only its
    inputs."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, fc1_w, fc1_b, fc2_w, fc2_b, ln_eps):
        fn = _route(x, mlp_sublayer_plain, mlp_sublayer_cuda)
        ctx.save_for_backward(x, ln_scale, ln_bias, fc1_w, fc1_b, fc2_w, fc2_b)
        ctx.ln_eps = ln_eps
        return fn(x, ln_scale, ln_bias, fc1_w, fc1_b, fc2_w, fc2_b, ln_eps=ln_eps)

    @staticmethod
    def backward(ctx, g):
        x, ln_scale, ln_bias, fc1_w, fc1_b, fc2_w, fc2_b = ctx.saved_tensors
        need = ctx.needs_input_grad
        dt, d = x.dtype, x.shape[-1]
        x2, g2 = x.reshape(-1, d), g.reshape(-1, d).to(dt)
        xf = x2.float()
        mean = xf.mean(dim=-1, keepdim=True)
        rstd = torch.rsqrt((xf - mean).square().mean(dim=-1, keepdim=True) + ctx.ln_eps)
        xhat = (xf - mean) * rstd
        gamma = ln_scale.float()
        xn = (xhat * gamma + ln_bias.float()).to(dt)
        w1, w2 = fc1_w.to(dt), fc2_w.to(dt)
        u = torch.addmm(fc1_b.to(dt), xn, w1)  # pre-activation [rows, F]
        da = g2 @ w2.t()
        dw2 = db2 = dw1 = db1 = None
        if need[5]:
            dw2 = (torch.nn.functional.gelu(u).t() @ g2).to(fc2_w.dtype)
        if need[6]:
            db2 = g2.sum(dim=0, dtype=torch.float32).to(fc2_b.dtype)
        du = torch.ops.aten.gelu_backward(da, u)  # exact erf form, one pass
        del da, u
        if need[3]:
            dw1 = (xn.t() @ du).to(fc1_w.dtype)
        if need[4]:
            db1 = du.sum(dim=0, dtype=torch.float32).to(fc1_b.dtype)
        _weight_grad_products["mlp_sublayer"] += sum(need[3:7])
        dxn = (du @ w1.t()).float()
        dxhat = dxn * gamma
        mr1 = dxhat.mean(dim=-1, keepdim=True)
        mr2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
        dx = (g2.float() + rstd * (dxhat - mr1 - xhat * mr2)).to(dt).reshape(x.shape)
        dlns = (dxn * xhat).sum(dim=0).to(ln_scale.dtype) if need[1] else None
        dlnb = dxn.sum(dim=0).to(ln_bias.dtype) if need[2] else None
        return dx if need[0] else None, dlns, dlnb, dw1, db1, dw2, db2, None


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


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
    args = (x, ln_scale, ln_bias, fc1_w, fc1_b, fc2_w, fc2_b)
    if not _wants_grad(*args):  # serving: straight to the kernel
        fn = _route(x, mlp_sublayer_plain, mlp_sublayer_cuda)
        return fn(*args, ln_eps=float(ln_eps))
    return _MlpSublayer.apply(*args, float(ln_eps))


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
    args = (x, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, proj_b)
    if not _wants_grad(*args):  # serving: straight to the kernel
        return fn(*args, bias, num_heads=int(num_heads), ln_eps=float(ln_eps))
    return _AttnSublayer.apply(*args, bias, int(num_heads), float(ln_eps))
