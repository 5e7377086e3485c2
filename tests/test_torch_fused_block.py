"""Fused sublayers of the PyTorch port vs the JAX reference.

On the CPU the port runs each kernel's plain version; the JAX side runs
its Pallas kernels in interpret mode, as tests/test_fused_block.py does.
Inputs come from seeded numpy and go through both packages. The CUDA
kernels themselves are held against the plain versions on the card by
tests/test_torch_fused_block_cuda.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metatransformer_tpu.core import encoder as jenc
from metatransformer_tpu.ops import fused_block as jfb
from metatransformer_tpu_torch.ops import _build
from metatransformer_tpu_torch.ops import fused_block as fb

torch.set_num_threads(1)


def _attn_inputs(b, t, d, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return (
        f(b, t, d),
        1.0 + 0.1 * f(d),
        0.1 * f(d),
        0.05 * f(d, 3 * d),
        0.05 * f(3 * d),
        0.05 * f(d, d),
        0.05 * f(d),
    )


def _mlp_inputs(b, t, d, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return (
        f(b, t, d),
        1.0 + 0.1 * f(d),
        0.1 * f(d),
        0.05 * f(d, 4 * d),
        0.05 * f(4 * d),
        0.05 * f(4 * d, d),
        0.05 * f(d),
    )


def _torch(arrays, device="cpu"):
    return [torch.tensor(a, device=device) for a in arrays]


@pytest.mark.parametrize("t", [17, 197])
def test_attn_plain_matches_jax(t):
    b, d, h = 2, 128, 2
    a = _attn_inputs(b, t, d, seed=t)
    want = jfb.attn_sublayer(*map(jnp.asarray, a), num_heads=h)
    got = fb.attn_sublayer(*_torch(a), num_heads=h)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_attn_plain_masked_matches_jax_on_kept_rows():
    b, t, d, h = 2, 50, 128, 2
    a = _attn_inputs(b, t, d, seed=1)
    mask = np.ones((b, t), bool)
    mask[0, 37:] = False
    mask[1, 11:] = False
    want = jfb.attn_sublayer(*map(jnp.asarray, a), mask=jnp.asarray(mask), num_heads=h)
    got = fb.attn_sublayer(*_torch(a), mask=torch.tensor(mask), num_heads=h)
    # padded query rows are don't-care, as in the reference's own test
    np.testing.assert_allclose(got.numpy()[mask], np.asarray(want)[mask], atol=2e-5)


@pytest.mark.parametrize("bt", [(2, 17), (3, 100)])
def test_mlp_plain_matches_jax_encoder_mlp(bt):
    """Exact erf GELU: the port's MLP sublayer is the reference encoder's
    LayerNorm + mlp + residual at FP32."""
    b, t = bt
    x, lns, lnb, w1, b1, w2, b2 = _mlp_inputs(b, t, 128, seed=b * t)
    p = {"fc1_w": w1, "fc1_b": b1, "fc2_w": w2, "fc2_b": b2}
    xj = jnp.asarray(x)
    h = jenc.layer_norm(xj, jnp.asarray(lns), jnp.asarray(lnb), 1e-5)
    want = xj + jenc.mlp(h, {k: jnp.asarray(v) for k, v in p.items()}, jenc.FP32)
    got = fb.mlp_sublayer(*_torch((x, lns, lnb, w1, b1, w2, b2)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_mlp_plain_matches_jax_fused_mlp_within_gelu_gap():
    b, t, d = 2, 33, 128
    a = _mlp_inputs(b, t, d, seed=5)
    want = jfb.mlp_sublayer(*map(jnp.asarray, a))
    got = fb.mlp_sublayer(*_torch(a))
    # The reference's Pallas MLP uses tanh GELU (no erf on the TPU); the port
    # uses exact erf. The two GELUs differ by up to ~3e-4 before fc2.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)


def test_plain_bf16_keeps_dtype_and_tracks_fp32():
    b, t, d, h = 2, 17, 128, 2
    a = _torch(_attn_inputs(b, t, d, seed=3))
    bf = [a[0].bfloat16(), a[1], a[2]] + [w.bfloat16() for w in a[3:]]
    got = fb.attn_sublayer(*bf, num_heads=h)
    assert got.dtype == torch.bfloat16
    want = fb.attn_sublayer(*a, num_heads=h)
    torch.testing.assert_close(got.float(), want, atol=0.05, rtol=0.02)


def test_cpu_tensors_launch_no_kernel():
    fb.reset_launch_counts()
    a = _torch(_attn_inputs(1, 9, 128, seed=4))
    fb.attn_sublayer(*a, num_heads=2)
    m = _torch(_mlp_inputs(1, 9, 128, seed=4))
    fb.mlp_sublayer(*m)
    assert fb.launch_counts() == {"attn_sublayer": 0, "mlp_sublayer": 0}


def test_other_devices_are_refused():
    x = torch.empty(1, 4, 128, device="meta")
    with pytest.raises(NotImplementedError):
        fb.mlp_sublayer(x, *(torch.empty(1, device="meta") for _ in range(6)))


def _bf16_attn_args(b=1, t=9, d=128):
    a = _torch(_attn_inputs(b, t, d, seed=6))
    return [a[0].bfloat16(), a[1], a[2]] + [w.bfloat16() for w in a[3:]]


@pytest.mark.parametrize(
    "index, bad, error",
    [
        (0, lambda x: x.float(), TypeError),  # x must be bf16
        (1, lambda s: s.bfloat16(), TypeError),  # LN params fp32
        (3, lambda w: w[:, :-8].contiguous(), ValueError),  # qkv_w shape
        (5, lambda w: w.t(), ValueError),  # proj_w contiguity
    ],
)
def test_cuda_wrapper_checks_inputs_before_launch(index, bad, error):
    args = _bf16_attn_args()
    args[index] = bad(args[index])
    before = fb.attn_sublayer_cuda.launches
    with pytest.raises(error):
        fb.attn_sublayer_cuda(*args, None, num_heads=2, ln_eps=1e-5)
    assert fb.attn_sublayer_cuda.launches == before


def test_cuda_wrapper_refuses_grad():
    args = _bf16_attn_args()
    args[3].requires_grad_(True)
    with pytest.raises(NotImplementedError, match="training slice"):
        fb.attn_sublayer_cuda(*args, None, num_heads=2, ln_eps=1e-5)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "library_path", lambda: tmp_path / "missing.so")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


@pytest.mark.parametrize(
    "t, d, h", [(t, d, h) for t in (1, 17, 197, 456, 457, 512, 513, 1568)
                for d, h in ((128, 2), (768, 12), (768, 32), (1024, 16), (96, 3))]
)
def test_supported_matches_jax(t, d, h):
    assert fb.supported(t, d, h) == jfb.supported(t, d, h)
