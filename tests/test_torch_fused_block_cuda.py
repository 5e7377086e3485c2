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
     (2, 100, 1024, 8, True), (4, 257, 768, 12, False), (4, 257, 768, 12, True)],
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
@pytest.mark.parametrize("b, t", [(3, 197), (2, 17), (4, 257)])
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
     (2, 300, 256, 2, True), (4, 257, 768, 12, False), (4, 257, 768, 12, True)],
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
