"""The port's flash-attention kernels against their plain PyTorch versions,
on a card.

Without a CUDA card every test here skips. The card's machine has no JAX,
and tests/conftest.py imports it, so there this file runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_flash_attention_cuda.py
"""

import numpy as np
import pytest
import torch

from metatransformer_tpu_torch.core import encoder as enc
from metatransformer_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

# Max abs error over max |value| of the fp32 plain version computed from the
# same inputs. bf16: the kernel's own roundings (p, the output; ds, p and
# the result in the backward) at 2**-9 each, summed over a few hundred keys
# in another order. fp32: summation order and expf only.
REL_TOL = {torch.bfloat16: 1.6e-2, torch.float32: 2e-5}
LSE_TOL = 1e-4  # fp32 in both; |lse| is a few units


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, t, h, d, dtype, dev, seed, masked, packed=True):
    rng = np.random.default_rng(seed)
    qkv = torch.tensor(rng.standard_normal((b, t, 3, h, d)).astype(np.float32)).to(dev, dtype)
    q, k, v = qkv.unbind(2) if packed else (a.contiguous() for a in qkv.unbind(2))
    do = torch.tensor(rng.standard_normal((b, t, h, d)).astype(np.float32)).to(dev, dtype)
    bias = None
    if masked:
        keep = torch.ones(b, t, dtype=torch.bool, device=dev)
        keep[0, t - t // 3:] = False
        if b > 1:
            keep[1, :] = False  # a fully masked sample must stay finite
        bias = torch.where(keep, 0.0, fa.NEG_INF).float()
    return q, k, v, bias, do


def _rel_err(got, want):
    got = got.float()
    assert torch.isfinite(got).all()
    return (got - want).abs().max().item() / want.abs().max().item()


CASES = [
    # b, t, h, d, dtype, masked
    (1, 1568, 12, 64, torch.bfloat16, False),
    (2, 1568, 2, 64, torch.bfloat16, True),
    (2, 512, 3, 32, torch.bfloat16, True),
    (2, 577, 2, 128, torch.bfloat16, True),
    (2, 513, 12, 64, torch.bfloat16, False),  # 8 * 64 + 1: the last tile holds one row
    (2, 513, 12, 64, torch.bfloat16, True),
    (1, 40, 2, 64, torch.bfloat16, False),
    # the bf16 backward's 128-row blocks and 64-row streamed tiles: one row
    # short of, exactly at and one past a block, and two blocks and a row
    (2, 127, 2, 64, torch.bfloat16, False),
    (2, 127, 2, 64, torch.bfloat16, True),
    (2, 128, 2, 64, torch.bfloat16, False),
    (2, 128, 2, 64, torch.bfloat16, True),
    (2, 129, 2, 64, torch.bfloat16, False),
    (2, 129, 2, 64, torch.bfloat16, True),
    (2, 257, 2, 64, torch.bfloat16, False),
    (2, 257, 2, 64, torch.bfloat16, True),
    (2, 513, 2, 32, torch.bfloat16, True),  # the segmenter's T at the other head dims
    (2, 513, 2, 128, torch.bfloat16, True),
    (3, 1568, 2, 64, torch.bfloat16, True),  # sample 1 fully masked, sample 2 dense
    (2, 1568, 2, 64, torch.float32, True),
    (2, 300, 2, 32, torch.float32, False),
    (2, 130, 2, 128, torch.float32, True),
    # Data2Seq's long sequences: audio's 1212 tokens, the fused trio's 2876
    # (the last key tile holds 60 rows) in bf16 and fp32, a ragged 3072 bucket
    (2, 1212, 2, 64, torch.bfloat16, False),
    (1, 2876, 2, 64, torch.bfloat16, False),
    (1, 2876, 2, 64, torch.float32, False),
    (3, 3072, 2, 64, torch.bfloat16, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b, t, h, d, dtype, masked", CASES)
def test_flash_kernels_match_plain(cuda_device, b, t, h, d, dtype, masked):
    """Forward (o, lse), dq and dk/dv kernels vs the plain versions in fp32
    from the same inputs; the backward kernels repeat bit for bit."""
    q, k, v, bias, do = _inputs(b, t, h, d, dtype, cuda_device, seed=t + d, masked=masked)
    scale = d**-0.5
    before = fa.launch_counts()
    o, lse = fa.flash_fwd_cuda(q, k, v, bias, scale)
    delta = fa._delta(o, do)
    dq = fa.flash_bwd_dq_cuda(q, k, v, bias, do, lse, delta, scale)
    dk, dv = fa.flash_bwd_dkv_cuda(q, k, v, bias, do, lse, delta, scale)
    dq2 = fa.flash_bwd_dq_cuda(q, k, v, bias, do, lse, delta, scale)
    dk2, dv2 = fa.flash_bwd_dkv_cuda(q, k, v, bias, do, lse, delta, scale)
    torch.cuda.synchronize()
    after = fa.launch_counts()
    assert {n: after[n] - before[n] for n in after} == {
        "flash_fwd": 1, "flash_bwd_dq": 2, "flash_bwd_dkv": 2}
    assert torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2)

    f = lambda x: x.float()
    want_o, want_lse = fa.flash_attention_plain(f(q), f(k), f(v), bias, scale)
    tol = REL_TOL[dtype]
    assert o.dtype == dtype and lse.dtype == torch.float32
    assert _rel_err(o, want_o) <= tol
    # samples with a kept key: sample 1 of a masked batch is fully masked
    # (its lse is -1e30 and the reference spreads p over padded keys)
    live = [i for i in range(b) if not (masked and i == 1)]
    torch.testing.assert_close(lse[live], want_lse[live], rtol=LSE_TOL, atol=LSE_TOL)
    # the backward from the kernel's own o and lse, as the Function runs it
    want_dq = fa.flash_bwd_dq_plain(f(q), f(k), f(v), bias, f(do), lse, delta, scale)
    want_dk, want_dv = fa.flash_bwd_dkv_plain(f(q), f(k), f(v), bias, f(do), lse, delta, scale)
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert got.dtype == dtype
        assert _rel_err(got[live], want[live]) <= tol
        assert torch.isfinite(got.float()).all()


# The bf16 cases of chip_smoke.py's FLASH_CASES (b, t, h, d, masked): the
# video path's T = 1568, the segmenter's 513, the edges of the 128-query
# blocks and 64-key tiles (127, 128, 129, 257), head_dim 32 and 128; masked
# means a ragged sample 0 and a fully masked sample 1.
FORWARD_CASES = [
    (1, 1568, 12, 64, False), (1, 1568, 12, 64, True), (8, 1568, 12, 64, False),
    (8, 1568, 12, 64, True), (3, 1568, 12, 64, True),
    (2, 512, 4, 32, True), (2, 577, 4, 32, False), (2, 512, 2, 128, False),
    (2, 577, 2, 128, True), (1, 513, 12, 64, False), (8, 513, 12, 64, False),
    (8, 513, 12, 64, True), (2, 513, 4, 32, True), (2, 513, 4, 128, True),
    (2, 127, 4, 64, False), (2, 127, 4, 64, True), (2, 128, 4, 64, False),
    (2, 128, 4, 64, True), (2, 129, 4, 64, False), (2, 129, 4, 64, True),
    (2, 257, 4, 64, False), (2, 257, 4, 64, True),
    # Data2Seq: audio, the fused trio, the ragged 3072 bucket
    (8, 1212, 12, 64, False), (8, 2876, 12, 64, False), (4, 3072, 12, 64, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b, t, h, d, masked", FORWARD_CASES)
def test_bf16_forward_matches_plain_and_repeats(cuda_device, b, t, h, d, masked):
    """The bf16 forward kernel vs the plain version in fp32 from the same
    inputs: o within the relative bound, lse within LSE_TOL on samples with a
    kept key, every value finite, and a second launch bit-equal."""
    q, k, v, bias, _ = _inputs(b, t, h, d, torch.bfloat16, cuda_device, seed=b + t + d,
                               masked=masked)
    scale = d**-0.5
    o, lse = fa.flash_fwd_cuda(q, k, v, bias, scale)
    o2, lse2 = fa.flash_fwd_cuda(q, k, v, bias, scale)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert torch.isfinite(o.float()).all() and torch.isfinite(lse).all()
    want_o, want_lse = fa.flash_attention_plain(q.float(), k.float(), v.float(), bias, scale)
    live = [i for i in range(b) if not (masked and i == 1)]
    assert _rel_err(o[live], want_o[live]) <= REL_TOL[torch.bfloat16]
    torch.testing.assert_close(lse[live], want_lse[live], rtol=LSE_TOL, atol=LSE_TOL)


@pytest.mark.cuda
def test_outputs_land_in_strided_buffers(cuda_device):
    """dq, dk, dv written into views of one [B, T, 3, H, d] buffer equal the
    contiguous outputs; q, k, v contiguous or packed give the same."""
    q, k, v, bias, do = _inputs(2, 200, 2, 64, torch.bfloat16, cuda_device, 1, True)
    scale = 0.125
    o, lse = fa.flash_fwd_cuda(q, k, v, bias, scale)
    o2, lse2 = fa.flash_fwd_cuda(q.contiguous(), k.contiguous(), v.contiguous(), bias, scale)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    delta = fa._delta(o, do)
    buf = torch.zeros(2, 200, 3, 2, 64, dtype=torch.bfloat16, device=cuda_device)
    dq_o, dk_o, dv_o = buf.unbind(2)
    fa.flash_bwd_dq_cuda(q, k, v, bias, do, lse, delta, scale, out=dq_o)
    fa.flash_bwd_dkv_cuda(q, k, v, bias, do, lse, delta, scale, out=(dk_o, dv_o))
    dq = fa.flash_bwd_dq_cuda(q, k, v, bias, do, lse, delta, scale)
    dk, dv = fa.flash_bwd_dkv_cuda(q, k, v, bias, do, lse, delta, scale)
    torch.cuda.synchronize()
    assert torch.equal(buf[:, :, 0], dq) and torch.equal(buf[:, :, 1], dk)
    assert torch.equal(buf[:, :, 2], dv)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_function_backward_on_card(cuda_device, dtype):
    """The autograd Function on the card vs fp32 autograd through the plain
    forward, also under checkpoint(use_reentrant=False)."""
    import torch.utils.checkpoint

    q, k, v, _, do = _inputs(2, 600, 2, 64, dtype, cuda_device, 2, False)
    mask = torch.ones(2, 600, dtype=torch.bool, device=cuda_device)
    mask[0, 500:] = False
    bias = torch.where(mask, 0.0, fa.NEG_INF).float()
    ref = [x.float().clone().requires_grad_(True) for x in (q, k, v)]
    want_o, _ = fa.flash_attention_plain(*ref, bias, 0.125)
    want_o.backward(do.float())
    for checkpointed in (False, True):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        f = lambda a, b, c: fa.flash_attention(a, b, c, mask=mask)
        before = fa.launch_counts()
        if checkpointed:
            out = torch.utils.checkpoint.checkpoint(f, *leaves, use_reentrant=False)
        else:
            out = f(*leaves)
        out.backward(do)
        torch.cuda.synchronize()
        grew = {n: c - before[n] for n, c in fa.launch_counts().items()}
        assert grew == {"flash_fwd": 2 if checkpointed else 1, "flash_bwd_dq": 1,
                        "flash_bwd_dkv": 1}
        assert _rel_err(out, want_o) <= REL_TOL[dtype]
        for got, want in zip(leaves, ref):
            assert got.grad.dtype == dtype
            assert _rel_err(got.grad[mask], want.grad[mask]) <= 2 * REL_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("precision", [enc.BF16, enc.FP32], ids=["bf16", "fp32"])
def test_encoder_flash_on_card_matches_cpu(cuda_device, precision):
    """A small encoder with attn_impl="flash": the kernels on the card vs
    the plain versions on the CPU."""
    cfg = enc.EncoderConfig(dim=128, depth=2, num_heads=2, attn_impl="flash")
    params = enc.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    x = torch.randn(2, 530, 128, generator=torch.Generator().manual_seed(1))
    mask = torch.ones(2, 530, dtype=torch.bool)
    mask[1, 400:] = False
    with torch.no_grad():
        want = enc.encode(params, x, cfg, mask=mask, precision=precision).float()
        fa.reset_launch_counts()
        on_card = {k: v.to(cuda_device) for k, v in params.items()}
        got = enc.encode(on_card, x.to(cuda_device), cfg, mask=mask.to(cuda_device),
                         precision=precision).float().cpu()
    assert fa.launch_counts()["flash_fwd"] == 2
    if precision.is_bf16:  # the reference's bf16 drift bound
        torch.testing.assert_close(got[mask], want[mask], atol=0.15, rtol=0.1)
    else:
        torch.testing.assert_close(got[mask], want[mask], atol=2e-4, rtol=2e-4)
