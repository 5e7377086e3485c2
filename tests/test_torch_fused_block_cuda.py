"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Without a CUDA card every test here skips. The card's machine has no JAX,
and tests/conftest.py imports it, so there this file runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_fused_block_cuda.py
"""

import numpy as np
import pytest
import torch

from metatransformer_tpu_torch.core import encoder as enc
from metatransformer_tpu_torch.models import image_classifier as ic
from metatransformer_tpu_torch.ops import fused_block as fb
from metatransformer_tpu_torch.tokenizers import image as tok

torch.set_num_threads(1)

# Max abs error of a kernel against its plain version computed in fp32 from
# the same bf16 inputs: about 4 bf16 ulps at |x| ~ 1 (chip_smoke.py's bound).
TOL = 3e-2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, t, d, hidden, out_in, seed, dev):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: torch.tensor(rng.standard_normal(s).astype(np.float32) * scale)
    bf = torch.bfloat16
    return [
        f(b, t, d).to(dev, bf),
        (1.0 + f(d, scale=0.1)).to(dev),
        f(d, scale=0.1).to(dev),
        f(d, hidden, scale=d**-0.5).to(dev, bf),
        f(hidden, scale=0.1).to(dev, bf),
        f(out_in, d, scale=out_in**-0.5).to(dev, bf),
        f(d, scale=0.1).to(dev, bf),
    ]


def _max_err(got, want):
    got = got.float()
    assert torch.isfinite(got).all()
    return (got - want).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b, t, d, h, masked",
    [(3, 197, 768, 12, False), (3, 197, 768, 12, True), (2, 17, 256, 8, False),
     (2, 100, 1024, 8, True), (4, 257, 768, 12, False), (4, 257, 768, 12, True),
     # Data2Seq's token counts below one 64-row tile and past three: text
     # (one token), tabular (14), hyper-spectral (201)
     (4, 1, 768, 12, False), (3, 14, 768, 12, False), (3, 14, 768, 12, True),
     (2, 201, 768, 12, False), (2, 201, 768, 12, True)],
)
def test_attn_kernel_matches_plain(cuda_device, b, t, d, h, masked):
    args = _inputs(b, t, d, 3 * d, d, seed=t, dev=cuda_device)
    bias = None
    if masked:
        keep = torch.ones(b, t, dtype=torch.bool, device=cuda_device)
        keep[1, t // 4:] = False
        bias = torch.where(keep, 0.0, fb.NEG_INF).float()
    before = fb.attn_sublayer_cuda.launches
    got = fb.attn_sublayer_cuda(*args, bias, num_heads=h, ln_eps=1e-5)
    torch.cuda.synchronize()
    assert fb.attn_sublayer_cuda.launches == before + 1
    want = fb.attn_sublayer_plain(*(a.float() for a in args), bias, num_heads=h, ln_eps=1e-5)
    assert _max_err(got, want) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("b, t", [(3, 197), (2, 17), (4, 257), (4, 1), (3, 14), (2, 201)])
def test_mlp_kernel_matches_plain(cuda_device, b, t):
    args = _inputs(b, t, 768, 3072, 3072, seed=t, dev=cuda_device)
    before = fb.mlp_sublayer_cuda.launches
    got = fb.mlp_sublayer_cuda(*args, ln_eps=1e-5)
    torch.cuda.synchronize()
    assert fb.mlp_sublayer_cuda.launches == before + 1
    want = fb.mlp_sublayer_plain(*(a.float() for a in args), ln_eps=1e-5)
    assert _max_err(got, want) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b, t, d, h, masked",
    [(3, 197, 768, 12, False), (3, 197, 768, 12, True), (2, 100, 256, 8, False),
     (2, 300, 256, 2, True), (4, 257, 768, 12, False), (4, 257, 768, 12, True),
     # ViT-L14's shapes: D = 1024, 16 heads of 64, T = 257
     (2, 257, 1024, 16, False), (2, 257, 1024, 16, True)],
)
def test_attn_bwd_kernel_matches_plain(cuda_device, b, t, d, h, masked):
    """All six outputs of the backward kernel vs its plain version in fp32
    from the same bf16 inputs; max abs error relative to each output's max
    |value| (chip_smoke.py's bound), and a second launch is bit-equal."""
    args = _inputs(b, t, d, 3 * d, d, seed=t, dev=cuda_device)
    x, lns, lnb, wqkv, bqkv, wproj, _ = args
    g = torch.tensor(
        np.random.default_rng(t + 1).standard_normal((b, t, d)).astype(np.float32)
    ).to(cuda_device, torch.bfloat16)
    bias = None
    if masked:
        keep = torch.ones(b, t, dtype=torch.bool, device=cuda_device)
        keep[0, t // 4:] = False
        keep[1, :] = False  # a fully masked sample must stay finite
        bias = torch.where(keep, 0.0, fb.NEG_INF).float()
    before = fb.attn_sublayer_bwd_cuda.launches
    kw = dict(num_heads=h, ln_eps=1e-5)
    got = fb.attn_sublayer_bwd_cuda(x, g, lns, lnb, wqkv, bqkv, wproj, bias, **kw)
    again = fb.attn_sublayer_bwd_cuda(x, g, lns, lnb, wqkv, bqkv, wproj, bias, **kw)
    torch.cuda.synchronize()
    assert fb.attn_sublayer_bwd_cuda.launches == before + 2
    want = fb.attn_sublayer_bwd_plain(
        x.float(), g.float(), lns, lnb, wqkv.float(), bqkv.float(), wproj.float(), bias, **kw
    )
    for a, a2, w in zip(got, again, want):
        assert torch.equal(a, a2)
        assert _max_err(a, w) <= 0.02 * w.abs().max().item()


# (M, N, K, trans_b, epilogue) of the sublayers' products at ragged M (3 x 197
# and 2 x 257 rows), at ViT-B16's widths and ViT-L14's: the forwards' QKV
# (EPI_BIAS, also the backward's recompute), proj + residual and fc2 +
# residual (EPI_BIAS_RESIDUAL) and fc1 + GELU (EPI_BIAS_GELU), every weight
# [K, N] read MN-major; the backward's g Wproj^T (EPI_NONE) and dqkv Wqkv^T
# (EPI_NONE_F32), both [N, K] read K-major.
EPI_BIAS, EPI_BIAS_GELU, EPI_BIAS_RESIDUAL, EPI_NONE, EPI_NONE_F32 = 0, 1, 2, 3, 4
GEMM_CASES = [
    (591, 2304, 768, False, EPI_BIAS), (591, 768, 768, True, EPI_NONE),
    (591, 768, 2304, True, EPI_NONE_F32), (514, 3072, 1024, False, EPI_BIAS),
    (514, 1024, 1024, True, EPI_NONE), (514, 1024, 3072, True, EPI_NONE_F32),
    (70, 128, 64, False, EPI_BIAS), (70, 128, 64, True, EPI_NONE_F32),
    (591, 768, 768, False, EPI_BIAS_RESIDUAL), (591, 3072, 768, False, EPI_BIAS_GELU),
    (591, 768, 3072, False, EPI_BIAS_RESIDUAL), (514, 1024, 1024, False, EPI_BIAS_RESIDUAL),
    (514, 4096, 1024, False, EPI_BIAS_GELU), (514, 1024, 4096, False, EPI_BIAS_RESIDUAL),
]


@pytest.mark.cuda
@pytest.mark.parametrize("m, n, k, trans_b, epi", GEMM_CASES)
def test_wgmma_gemm_matches_matmul(cuda_device, m, n, k, trans_b, epi):
    """The sublayers' GEMM alone vs torch.matmul in fp32 over the same bf16
    operands, with the bias added in fp32 and GELU and the residual applied
    at the kernel's cast points: bf16(gelu(acc + bias)), bf16(res +
    bf16(acc + bias)). fp32 out: only the order of summation differs
    (relative 1e-4 of the largest value); bf16 out: one rounding, 2**-8
    relative, plus that; with the residual, the inner rounding may also fall
    the other way, one bf16 ulp (2**-7 relative) of the inner value."""
    from metatransformer_tpu_torch.ops import _build

    rng = np.random.default_rng(m + n + k + epi)
    bf = torch.bfloat16
    a = torch.tensor(rng.standard_normal((m, k)).astype(np.float32)).to(cuda_device, bf)
    w = torch.tensor((rng.standard_normal((n, k) if trans_b else (k, n)) * k**-0.5)
                     .astype(np.float32)).to(cuda_device, bf)
    bias = torch.tensor(rng.standard_normal(n).astype(np.float32)).to(cuda_device, bf)
    res = torch.tensor(rng.standard_normal((m, n)).astype(np.float32)).to(cuda_device, bf)
    out = torch.full((m, n), float("nan"), device=cuda_device,
                     dtype=torch.float32 if epi == EPI_NONE_F32 else bf)
    rc = _build.library().mt_gemm_sm90(
        a.data_ptr(), w.data_ptr(), bias.data_ptr(), res.data_ptr(), out.data_ptr(), m, n, k,
        int(trans_b), epi, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    want = a.float() @ (w.float().t() if trans_b else w.float())
    if epi in (EPI_BIAS, EPI_BIAS_GELU, EPI_BIAS_RESIDUAL):
        want = want + bias.float()
    tol = 1e-4 if epi == EPI_NONE_F32 else 2.0**-8 + 1e-4
    bound = tol * want.abs().max().item()
    if epi == EPI_BIAS_GELU:
        want = torch.nn.functional.gelu(want)
        bound = tol * want.abs().max().item()
    if epi == EPI_BIAS_RESIDUAL:
        inner = want.to(bf).float()
        want = res.float() + inner
        bound = tol * want.abs().max().item() + 2.0**-7 * inner.abs().max().item()
    assert _max_err(out, want) <= bound


# (B, T, D, H, mask) of the attention core alone: the lengths at the edges
# of its 64-key tiles and 128-query blocks, the image and point paths' T,
# T = 512 at 6 heads of 128, and head_dim 32 and 128. mask: None (dense) or
# "ragged" (sample 0 keeps its first T // 4 keys, sample 1 none, sample 2
# all).
ATTN_CORE_CASES = (
    [(3, t, 768, 12, mask) for t in (1, 17, 64, 65, 128, 129, 197, 257)
     for mask in (None, "ragged")]
    + [(3, 512, 768, 6, "ragged"), (2, 512, 768, 6, None),
       (3, 197, 256, 8, "ragged"), (3, 129, 256, 8, None),
       (3, 197, 1024, 8, "ragged"), (3, 65, 1024, 8, None)]
)


@pytest.mark.cuda
@pytest.mark.parametrize("b, t, d, h, mask", ATTN_CORE_CASES)
def test_attn_core_matches_plain(cuda_device, b, t, d, h, mask):
    """The attention sublayer's wgmma core alone (mt_attn_core) vs the plain
    version's core in fp32 from the same bf16 QKV slab; a fully masked
    sample spreads p evenly over its T keys in both; a second launch is
    bit-equal."""
    from metatransformer_tpu_torch.ops import _build

    rng = np.random.default_rng(t * d + h)
    qkv = torch.tensor(rng.standard_normal((b, t, 3 * d)).astype(np.float32)).to(
        cuda_device, torch.bfloat16)
    bias = None
    if mask == "ragged":
        keep = torch.ones(b, t, dtype=torch.bool, device=cuda_device)
        keep[0, t // 4:] = False
        keep[1, :] = False
        bias = torch.where(keep, 0.0, fb.NEG_INF).float()
    outs = []
    for _ in range(2):
        o = torch.full((b, t, d), float("nan"), device=cuda_device, dtype=torch.bfloat16)
        rc = _build.library().mt_attn_core(
            qkv.data_ptr(), None if bias is None else bias.data_ptr(), o.data_ptr(), b, t, d,
            h, torch.cuda.current_stream().cuda_stream)
        assert rc == 0
        outs.append(o)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    want = fb.attention_core_plain(qkv.float(), bias, num_heads=h)
    assert _max_err(outs[0], want) <= TOL


@pytest.mark.cuda
def test_sublayer_functions_backward_on_card(cuda_device):
    """Both autograd Functions on the card: every gradient vs autograd
    through the plain versions in fp32."""
    args = _inputs(2, 197, 768, 3 * 768, 768, seed=3, dev=cuda_device)
    margs = _inputs(2, 197, 768, 3072, 3072, seed=4, dev=cuda_device)
    for op, plain, a, kw in (
        (fb.attn_sublayer, fb.attn_sublayer_plain, args, dict(num_heads=12)),
        (fb.mlp_sublayer, fb.mlp_sublayer_plain, margs, {}),
    ):
        leaves = [t.clone().requires_grad_(True) for t in a]
        op(*leaves, **kw).float().square().sum().backward()
        ref = [t.float().clone().requires_grad_(True) for t in a]
        if plain is fb.attn_sublayer_plain:
            plain(*ref, None, num_heads=12, ln_eps=1e-5).square().sum().backward()
        else:
            plain(*ref, ln_eps=1e-5).square().sum().backward()
        for got, want in zip(leaves, ref):
            assert got.grad.dtype == got.dtype
            assert _max_err(got.grad, want.grad) <= 0.03 * want.grad.abs().max().item()


@pytest.mark.cuda
def test_small_classifier_on_card_matches_cpu(cuda_device):
    """The whole slice at a small size: the BF16 kernels on the card vs the
    plain versions on the CPU, at the reference's bf16 drift bound."""
    cfg = ic.ImageClassifierConfig(
        tokenizer=tok.ImageTokenizerConfig(32, 8, 3, 128),
        encoder=enc.EncoderConfig(dim=128, depth=2, num_heads=2),
        num_classes=10,
    )
    params = ic.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    images = torch.randint(0, 256, (3, 32, 32, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(1))
    want = ic.ImageClassifier(cfg, params, precision=enc.BF16, device="cpu")(images)
    fb.reset_launch_counts()
    model = ic.ImageClassifier(cfg, params, precision=enc.BF16, device=cuda_device)
    got = model(images.to(cuda_device))
    assert fb.launch_counts() == {"attn_sublayer": 2, "mlp_sublayer": 2, "attn_sublayer_bwd": 0}
    torch.testing.assert_close(got.cpu(), want, atol=0.15, rtol=0.1)
