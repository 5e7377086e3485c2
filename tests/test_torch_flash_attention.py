"""Flash attention of the PyTorch port vs the JAX reference.

The same numpy-seeded q, k, v and mask go through
``metatransformer_tpu.ops.flash_attention`` (Pallas in interpret mode on the
CPU) and the port's ``ops.flash_attention`` (its plain versions, which is
what a CPU tensor runs), forward and gradients of ``sum(out ** 2)``.
Tolerances are the JAX suite's own (tests/test_flash_attention.py): fp32 at
rtol = atol = 2e-3 forward and for masked multi-block gradients, 1e-3 for
single-block gradients, bf16 at max abs 0.05. Masked samples are compared
on kept positions only: the reference pads T, so fully masked rows and
masked positions differ by design.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils.checkpoint

from metatransformer_tpu.ops import flash_attention as jfa
from metatransformer_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)


def _qkv(seed, b, t, h, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(3)]


def _ragged(b, t, cut):
    mask = np.ones((b, t), bool)
    mask[0, t - cut:] = False
    return mask


def _port_out_and_grads(qkv, mask, dtype=torch.float32):
    leaves = [torch.tensor(a).to(dtype).requires_grad_(True) for a in qkv]
    m = None if mask is None else torch.tensor(mask)
    out = fa.flash_attention(*leaves, mask=m)
    out.float().square().sum().backward()
    return out.detach().float().numpy(), [a.grad.float().numpy() for a in leaves]


def _jax_out_and_grads(qkv, mask, dtype=jnp.float32):
    args = [jnp.asarray(a).astype(dtype) for a in qkv]
    m = None if mask is None else jnp.asarray(mask)

    def loss(q, k, v):
        out = jfa.flash_attention(q, k, v, mask=m)
        return jnp.sum(out.astype(jnp.float32) ** 2), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(*args)
    return np.asarray(out, np.float32), [np.asarray(g, np.float32) for g in grads]


def test_constants_and_gate_match_jax():
    assert fa.NEG_INF == jfa.NEG_INF
    for t in (1, 197, 511, 512, 1568):
        for d in (16, 32, 64, 96, 128):
            assert fa.supported(t, d) == jfa.supported(t, d)


@pytest.mark.parametrize("t", [8, 197, 256, 520])
@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked"])
def test_flash_fp32_forward_and_grads_match_jax(t, masked):
    qkv = _qkv(t, 2, t, 2, 64)
    mask = _ragged(2, t, max(t // 5, 3)) if masked else None
    got, got_g = _port_out_and_grads(qkv, mask)
    want, want_g = _jax_out_and_grads(qkv, mask)
    keep = np.ones((2, t), bool) if mask is None else mask
    np.testing.assert_allclose(got[keep], want[keep], rtol=2e-3, atol=2e-3)
    # one key/query block in the reference up to 256 tokens: its tighter bound
    tol = 1e-3 if t <= 256 and not masked else 2e-3
    for name, a, b in zip("qkv", got_g, want_g):
        np.testing.assert_allclose(a[keep], b[keep], rtol=tol, atol=tol, err_msg=f"d{name}")


@pytest.mark.parametrize("d", [32, 128])
def test_flash_fp32_other_head_dims_match_jax(d):
    qkv = _qkv(d, 1, 70, 2, d)
    mask = _ragged(1, 70, 9)
    got, got_g = _port_out_and_grads(qkv, mask)
    want, want_g = _jax_out_and_grads(qkv, mask)
    np.testing.assert_allclose(got[mask], want[mask], rtol=2e-3, atol=2e-3)
    for a, b in zip(got_g, want_g):
        np.testing.assert_allclose(a[mask], b[mask], rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("t", [128, 300])
def test_flash_bf16_matches_jax_and_fp32_reference(t):
    qkv = _qkv(3, 1, t, 4, 64)
    got, got_g = _port_out_and_grads(qkv, None, torch.bfloat16)
    want, want_g = _jax_out_and_grads(qkv, None, jnp.bfloat16)
    ref = np.asarray(jfa._reference_attention(
        *map(jnp.asarray, qkv), jnp.zeros((1, t), jnp.float32), 64**-0.5))
    assert np.max(np.abs(got - ref)) < 0.05
    assert np.max(np.abs(got - want)) < 0.05
    for a, b in zip(got_g, want_g):  # bf16 gradients of O(1) values
        assert np.max(np.abs(a - b)) < 0.05 * max(1.0, np.max(np.abs(b)))


@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked"])
def test_lse_is_logsumexp_of_reference_logits(masked):
    t = 90
    q, k, v = _qkv(11, 2, t, 2, 32)
    bias = None
    logits = np.einsum("bthd,bshd->bhts", q, k) * 32**-0.5
    if masked:
        mask = _ragged(2, t, 20)
        bias = torch.where(torch.tensor(mask), 0.0, fa.NEG_INF).float()
        logits = logits + np.where(mask, 0.0, fa.NEG_INF)[:, None, None, :]
    _, lse = fa.flash_attention_plain(*map(torch.tensor, (q, k, v)), bias, 32**-0.5)
    want = torch.logsumexp(torch.tensor(logits), dim=-1)
    assert lse.shape == (2, 2, t) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, want.float(), rtol=1e-5, atol=1e-5)


def test_backward_plain_matches_autograd_of_forward():
    """dq, dk, dv of the plain backward (the kernels' arithmetic: p from the
    saved lse, delta = rowsum(dO * O)) vs autograd through softmax."""
    q, k, v = (torch.tensor(a, requires_grad=True) for a in _qkv(5, 2, 40, 2, 32))
    g = torch.tensor(_qkv(6, 2, 40, 2, 32)[0])
    scale = 32**-0.5
    s = torch.einsum("bthd,bshd->bhts", q, k) * scale
    ref = torch.einsum("bhts,bshd->bthd", torch.softmax(s, -1), v)
    want = torch.autograd.grad(ref, (q, k, v), g)
    with torch.no_grad():
        o, lse = fa.flash_attention_plain(q, k, v, None, scale)
        got = fa.flash_attention_bwd_plain(q, k, v, None, o, lse, g, scale)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_fully_masked_sample_is_finite_and_uniform():
    """Every key at NEG_INF: a uniform p over the T keys, so the output is
    the mean of v; gradients are finite. (The reference spreads p over its
    padded keys too, so this row is the port's own.)"""
    t = 50
    qkv = _qkv(8, 2, t, 2, 32)
    mask = np.ones((2, t), bool)
    mask[1] = False
    got, grads = _port_out_and_grads(qkv, mask)
    assert np.isfinite(got).all() and all(np.isfinite(g).all() for g in grads)
    want = np.broadcast_to(qkv[2][1].mean(axis=0, keepdims=True), got[1].shape)
    np.testing.assert_allclose(got[1], want, rtol=1e-5, atol=1e-6)
    # the kept sample is untouched by its neighbour
    alone, _ = _port_out_and_grads([a[:1] for a in qkv], None)
    np.testing.assert_allclose(got[0], alone[0], rtol=1e-6, atol=1e-6)


def test_function_under_checkpoint_matches_plain_call():
    qkv = _qkv(9, 1, 33, 2, 32)
    mask = torch.tensor(_ragged(1, 33, 5))

    def run(checkpointed):
        leaves = [torch.tensor(a, requires_grad=True) for a in qkv]
        f = lambda q, k, v: fa.flash_attention(q * 1.0, k * 1.0, v * 1.0, mask=mask)
        if checkpointed:
            out = torch.utils.checkpoint.checkpoint(f, *leaves, use_reentrant=False)
        else:
            out = f(*leaves)
        out.square().sum().backward()
        return out.detach(), [a.grad for a in leaves]

    out_a, grads_a = run(False)
    out_b, grads_b = run(True)
    torch.testing.assert_close(out_a, out_b, rtol=0, atol=0)
    for a, b in zip(grads_a, grads_b):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_nothing_quadratic_is_saved_for_backward():
    """The Function keeps q, k, v, the bias, o and lse: no tensor with two
    axes of length T."""
    t = 600
    q, k, v = (torch.tensor(a, requires_grad=True) for a in _qkv(10, 1, t, 1, 32))
    out = fa.flash_attention(q, k, v, mask=torch.ones(1, t, dtype=torch.bool))
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 6
    for s in saved:
        assert sum(1 for n in s.shape if n >= t) <= 1, tuple(s.shape)
    assert sum(s.numel() for s in saved) <= 5 * q.numel()


def test_no_grad_call_skips_the_function_and_views_pass_uncopied():
    """Serving goes straight to the forward; q, k, v as strided views of one
    [B, T, 3, H, d] projection give the same result as contiguous copies."""
    qkv = torch.tensor(np.random.default_rng(12).standard_normal((2, 21, 3, 2, 32), np.float32))
    q, k, v = qkv.unbind(2)
    out = fa.flash_attention(q, k, v)
    assert out.grad_fn is None and out.shape == (2, 21, 2, 32)
    want = fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    assert fa._kernel_layout(q, k, v)[0] is q
    assert fa._kernel_layout(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)[0] is not q


def test_wrappers_reject_what_the_kernels_do_not_take():
    q = torch.zeros(1, 8, 2, 48)
    with pytest.raises(ValueError, match="head_dim"):
        fa._check_qkv(q, q, q, None)
    q = torch.zeros(1, 8, 2, 64, dtype=torch.float16)
    with pytest.raises(TypeError, match="bf16 or fp32"):
        fa._check_qkv(q, q, q, None)
    q = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="strides"):
        fa._check_qkv(q, q.transpose(1, 2).contiguous().transpose(1, 2), q, None)
    with pytest.raises(ValueError, match="share shape and dtype"):
        fa.flash_attention(q, q[:, :4], q)
    assert fa.launch_counts() == {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
