"""Encoder and converter of the PyTorch port vs the JAX reference and the
torch oracle (tests/torch_ref.py).

Weights travel JAX -> numpy -> ``convert.from_numpy``; inputs come from
seeded numpy. The JAX fused sublayers run in Pallas interpret mode."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metatransformer_tpu.core import convert as jconvert
from metatransformer_tpu.core import encoder as jenc
from metatransformer_tpu_torch.core import convert, encoder as enc

from . import torch_ref

torch.set_num_threads(1)


def _pair(dim, depth, heads, seed=0):
    """torch oracle blocks + the same weights as a numpy tree."""
    blocks = torch_ref.make_encoder(dim, depth, heads, seed)
    state = {k: v.detach().numpy() for k, v in blocks.state_dict().items()}
    return blocks, jconvert.convert_state_dict(state)


def _jax_encode(np_params, x, cfg, **kw):
    params = {k: jnp.asarray(v) for k, v in np_params.items()}
    return np.asarray(jenc.encode(params, jnp.asarray(x), cfg, **kw), np.float32)


def _port_encode(np_params, x, cfg, **kw):
    params = convert.from_numpy(np_params, "cpu")
    kw = {k: (torch.tensor(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    return enc.encode(params, torch.tensor(x), cfg, **kw).float().numpy()


def _cfgs(dim, depth, heads):
    return (
        jenc.EncoderConfig(dim=dim, depth=depth, num_heads=heads),
        enc.EncoderConfig(dim=dim, depth=depth, num_heads=heads),
    )


def test_encode_fp32_matches_jax_and_torch():
    jcfg, cfg = _cfgs(64, 3, 4)
    blocks, np_params = _pair(64, 3, 4)
    x = np.random.default_rng(1).standard_normal((2, 17, 64), dtype=np.float32)
    got = _port_encode(np_params, x, cfg)
    np.testing.assert_allclose(got, _jax_encode(np_params, x, jcfg), atol=1e-4)
    with torch.no_grad():
        want = blocks(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_encode_fp32_masked_matches_jax_and_torch_on_kept_rows():
    jcfg, cfg = _cfgs(64, 3, 4)
    blocks, np_params = _pair(64, 3, 4, seed=1)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 12, 64), dtype=np.float32)
    mask = np.ones((2, 12), bool)
    mask[0, 8:] = False
    mask[1, 5:] = False
    got = _port_encode(np_params, x, cfg, mask=mask)
    want_j = _jax_encode(np_params, x, jcfg, mask=jnp.asarray(mask))
    with torch.no_grad():
        h = torch.tensor(x)
        for blk in blocks:
            h = blk(h, torch.tensor(mask))
    np.testing.assert_allclose(got[mask], want_j[mask], atol=1e-4)
    np.testing.assert_allclose(got[mask], h.numpy()[mask], atol=1e-4)


def test_encode_fp32_pos_each_block_matches_jax_and_torch():
    jcfg, cfg = _cfgs(64, 3, 4)
    blocks, np_params = _pair(64, 3, 4, seed=2)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 64), dtype=np.float32)
    pos = rng.standard_normal((1, 9, 64), dtype=np.float32)
    got = _port_encode(np_params, x, cfg, pos=pos, pos_each_block=True)
    want_j = _jax_encode(np_params, x, jcfg, pos=jnp.asarray(pos), pos_each_block=True)
    with torch.no_grad():
        h = torch.tensor(x)
        for blk in blocks:
            h = blk(h + torch.tensor(pos))
    np.testing.assert_allclose(got, want_j, atol=1e-4)
    np.testing.assert_allclose(got, h.numpy(), atol=1e-4)


def test_encode_fp32_base_geometry_matches_jax_and_torch():
    """Full ViT-B16 geometry (12 x 768, 12 heads), B=1, T=197."""
    blocks, np_params = _pair(768, 12, 12)
    x = np.random.default_rng(2).standard_normal((1, 197, 768), dtype=np.float32)
    got = _port_encode(np_params, x, enc.BASE)
    assert np.max(np.abs(got - _jax_encode(np_params, x, jenc.BASE))) <= 1e-3
    with torch.no_grad():
        want = blocks(torch.tensor(x)).numpy()
    assert np.max(np.abs(got - want)) <= 1e-3


def test_encode_bf16_fused_plain_matches_jax_fused():
    """BF16 policy: the port's plain sublayers vs the JAX Pallas sublayers
    (interpret mode), at the reference's bf16 drift bound."""
    jcfg, cfg = _cfgs(128, 2, 2)
    np_params = jax.tree.map(np.asarray, jenc.init(jcfg, jax.random.PRNGKey(0)))
    x = np.random.default_rng(5).standard_normal((2, 197, 128), dtype=np.float32)
    assert enc._resolve_impl(cfg, 197, enc.BF16) == "fused"
    got = _port_encode(np_params, x, cfg, precision=enc.BF16)
    want = _jax_encode(np_params, x, jcfg, precision=jenc.BF16)
    np.testing.assert_allclose(got, want, atol=0.15, rtol=0.1)


def test_encode_bf16_xla_path_matches_jax_xla():
    jcfg = jenc.EncoderConfig(dim=64, depth=2, num_heads=4, attn_impl="xla")
    cfg = enc.EncoderConfig(dim=64, depth=2, num_heads=4, attn_impl="xla")
    _, np_params = _pair(64, 2, 4, seed=3)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 12, 64), dtype=np.float32)
    mask = np.ones((2, 12), bool)
    mask[1, 7:] = False
    got = _port_encode(np_params, x, cfg, mask=mask, precision=enc.BF16)
    want = _jax_encode(np_params, x, jcfg, mask=jnp.asarray(mask), precision=jenc.BF16)
    np.testing.assert_allclose(got[mask], want[mask], atol=0.15, rtol=0.1)


@pytest.mark.parametrize("t", [1, 17, 197, 257, 456, 457, 512, 1568])
def test_resolve_impl_matches_jax(t):
    for d, h in ((128, 2), (768, 12), (768, 32), (1024, 16), (96, 3), (1024, 8)):
        for impl in ("auto", "xla", "fused", "flash"):
            jcfg = jenc.EncoderConfig(dim=d, depth=1, num_heads=h, attn_impl=impl)
            cfg = enc.EncoderConfig(dim=d, depth=1, num_heads=h, attn_impl=impl)
            for jp, p in ((jenc.FP32, enc.FP32), (jenc.BF16, enc.BF16)):
                assert enc._resolve_impl(cfg, t, p) == jenc._resolve_impl(jcfg, t, jp)


@pytest.mark.parametrize("impl", ["flash", "ring", "performer"])
def test_unported_attention_paths_raise(impl):
    """"ring" raises and names its queue item; "flash" and "performer" are
    ported and run at any length when asked for by name ("performer" held
    to the JAX encoder at FP32)."""
    cfg = enc.EncoderConfig(dim=64, depth=1, num_heads=2, attn_impl=impl)
    params = enc.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    x = torch.randn(1, 5, 64, generator=torch.Generator().manual_seed(1))
    if impl == "flash":
        want = enc.encode(params, x, dataclasses.replace(cfg, attn_impl="xla"))
        torch.testing.assert_close(enc.encode(params, x, cfg), want, atol=1e-5, rtol=1e-5)
        return
    if impl == "performer":
        jcfg = jenc.EncoderConfig(dim=64, depth=1, num_heads=2, attn_impl=impl)
        want = jenc.encode({k: jnp.asarray(v.numpy()) for k, v in params.items()},
                           jnp.asarray(x.numpy()), jcfg)
        np.testing.assert_allclose(enc.encode(params, x, cfg).numpy(), np.asarray(want),
                                   atol=1e-4, rtol=1e-4)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1, item 8"):
        enc.encode(params, x, cfg)


def test_config_has_every_reference_field_with_its_default():
    """Every field of the JAX EncoderConfig exists in the port's with an
    equal default, so a config carried over from the reference constructs."""
    want = {f.name: f.default for f in dataclasses.fields(jenc.EncoderConfig)}
    got = {f.name: f.default for f in dataclasses.fields(enc.EncoderConfig)}
    assert set(want) <= set(got)
    assert {name: got[name] for name in want} == want
    cfg = enc.EncoderConfig(dim=64, depth=1, num_heads=2, attn_impl="performer",
                            performer_features=16, performer_seed=3, ring_axis="tokens")
    assert (cfg.performer_features, cfg.performer_seed, cfg.ring_axis) == (16, 3, "tokens")


def test_auto_long_sequence_raises_instead_of_falling_back(monkeypatch):
    """T >= 512 under "auto" goes through ops.flash_attention (once a layer)
    and nowhere else: with that op failing, encode raises, it does not fall
    back to the materialised path."""
    from metatransformer_tpu_torch.ops import flash_attention as fa

    cfg = enc.EncoderConfig(dim=64, depth=2, num_heads=2)
    params = enc.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    x = torch.randn(1, 512, 64, generator=torch.Generator().manual_seed(1))
    calls = []
    real = fa.flash_attention
    monkeypatch.setattr(
        fa, "flash_attention", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    out = enc.encode(params, x, cfg)
    assert len(calls) == 2 and torch.isfinite(out).all()

    def broken(*a, **kw):
        raise RuntimeError("flash kernel failed")

    monkeypatch.setattr(fa, "flash_attention", broken)
    with pytest.raises(RuntimeError, match="flash kernel failed"):
        enc.encode(params, x, cfg)


def _encode_grads(np_params, x, cfg, precision, remat):
    params = convert.from_numpy(np_params, "cpu", requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    out = enc.encode(params, xt, cfg, precision=precision, remat=remat)
    out.float().square().sum().backward()
    return {"x": xt.grad.numpy(), **{k: v.grad.numpy() for k, v in params.items()}}


@pytest.mark.parametrize("remat", [False, True, "save"])
def test_remat_grads_match_jax(remat):
    """Gradients of the FP32 encoder (XLA path) in every leaf and in x vs
    ``jax.grad`` of the reference, for each remat mode: checkpointing must
    not change a gradient."""
    jcfg, cfg = _cfgs(128, 3, 4)
    np_params = jax.tree.map(np.asarray, jenc.init(jcfg, jax.random.PRNGKey(0)))
    x = np.random.default_rng(7).standard_normal((2, 9, 128), dtype=np.float32)
    got = _encode_grads(np_params, x, cfg, enc.FP32, remat)

    def loss(p, xj):
        return jnp.sum(jenc.encode(p, xj, jcfg, remat=remat) ** 2)

    gp, gx = jax.grad(loss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in np_params.items()}, jnp.asarray(x)
    )
    np.testing.assert_allclose(got["x"], np.asarray(gx), atol=1e-4)
    for k in np_params:
        np.testing.assert_allclose(got[k], np.asarray(gp[k]), atol=1e-4, err_msg=k)


@pytest.mark.parametrize("remat", [True, "save"])
def test_remat_bf16_grads_match_no_remat(remat):
    """BF16: remat=True recomputes the same fused sublayers, so gradients
    are bit-equal to remat=False; "save" takes the XLA block and agrees at
    the bf16 drift bound."""
    jcfg, cfg = _cfgs(128, 2, 2)
    np_params = jax.tree.map(np.asarray, jenc.init(jcfg, jax.random.PRNGKey(1)))
    x = np.random.default_rng(8).standard_normal((2, 37, 128), dtype=np.float32)
    want = _encode_grads(np_params, x, cfg, enc.BF16, False)
    got = _encode_grads(np_params, x, cfg, enc.BF16, remat)
    for k in want:
        if remat is True:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            scale = np.abs(want[k]).max()
            np.testing.assert_allclose(got[k], want[k], atol=0.1 * scale, rtol=0.1, err_msg=k)


def test_encode_bf16_fused_grads_match_jax_fused():
    """BF16 fused path: the port's plain backward vs the JAX Pallas backward
    (interpret mode) through the whole encoder, at the bf16 bound of
    tests/test_fused_block.py (rtol = atol = 0.1, atol scaled by the
    gradient's magnitude)."""
    jcfg, cfg = _cfgs(128, 2, 2)
    np_params = jax.tree.map(np.asarray, jenc.init(jcfg, jax.random.PRNGKey(2)))
    x = np.random.default_rng(9).standard_normal((2, 37, 128), dtype=np.float32)
    assert enc._resolve_impl(cfg, 37, enc.BF16) == "fused"
    got = _encode_grads(np_params, x, cfg, enc.BF16, False)

    def loss(p, xj):
        out = jenc.encode(p, xj, jcfg, precision=jenc.BF16)
        return jnp.sum(out.astype(jnp.float32) ** 2)

    gp, gx = jax.grad(loss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in np_params.items()}, jnp.asarray(x)
    )
    want = {"x": np.asarray(gx), **{k: np.asarray(v) for k, v in gp.items()}}
    for k in want:
        scale = max(np.abs(want[k]).max(), 1e-6)
        np.testing.assert_allclose(
            got[k] / scale, want[k] / scale, atol=0.1, rtol=0.1, err_msg=k
        )


def test_default_device_raises_without_a_card(monkeypatch):
    """Entry points run on the card unless the caller asks for the CPU:
    with no card, ``init`` without ``device`` raises and never falls back."""
    from metatransformer_tpu_torch.core import device as port_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = enc.EncoderConfig(dim=64, depth=1, num_heads=4)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="CUDA card"):
        enc.init(cfg, gen)
    with pytest.raises(RuntimeError, match="CUDA card"):
        port_device.default_device()
    with pytest.raises(RuntimeError, match="CUDA card"):
        convert.from_numpy({"a": np.zeros(2)})
    params = enc.init(cfg, gen, device="cpu")
    assert params["qkv_w"].device.type == "cpu"
    assert port_device.resolve("cpu") == torch.device("cpu")


def test_init_layout_matches_jax():
    cfg = enc.EncoderConfig(dim=64, depth=3, num_heads=4)
    jcfg = jenc.EncoderConfig(dim=64, depth=3, num_heads=4)
    params = enc.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    jparams = jenc.init(jcfg, jax.random.PRNGKey(0))
    assert enc.param_shapes(cfg) == jenc.param_shapes(jcfg)
    assert set(params) == set(jparams)
    for k, v in params.items():
        assert tuple(v.shape) == jparams[k].shape, k
    w = params["qkv_w"]
    assert w.abs().max() <= 0.04 + 1e-6 and 0.015 < w.std() < 0.02
    again = enc.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(params[k], again[k]) for k in params)


def test_cast_params_once():
    cfg = enc.EncoderConfig(dim=64, depth=1, num_heads=4)
    params = enc.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    cast = enc.cast_params(params, enc.BF16)
    assert cast["qkv_w"].dtype == torch.bfloat16
    assert cast["norm1_scale"].dtype == torch.float32
    again = enc.cast_params(cast, enc.BF16)
    assert all(again[k] is cast[k] for k in cast)
    assert enc.cast_params(params, enc.FP32) is params


def test_convert_state_dict_identical_to_jax():
    blocks = torch_ref.make_encoder(64, 3, 4, seed=7)
    state = {k: v.detach().numpy() for k, v in blocks.state_dict().items()}
    got, want = convert.convert_state_dict(state), jconvert.convert_state_dict(state)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert convert.infer_config(got) == enc.EncoderConfig(dim=64, depth=3, num_heads=1)
    with pytest.raises(ValueError):
        convert.convert_state_dict({"0.bogus.weight": np.zeros((2, 2))})
    with pytest.raises(ValueError):
        convert.convert_state_dict({"not_a_layer": np.zeros((2, 2))})


def test_jax_npz_loads_identically(tmp_path):
    params = jenc.init(jenc.EncoderConfig(128, 2, 2), jax.random.PRNGKey(0))
    path = str(tmp_path / "enc.npz")
    jconvert.save_npz(path, params)
    loaded, cfg = convert.load_npz(path, device="cpu")
    assert cfg == enc.EncoderConfig(128, 2, 2)
    for k in params:
        np.testing.assert_array_equal(loaded[k].numpy(), np.asarray(params[k]))
    # and the port writes what the JAX package reads
    path2 = str(tmp_path / "port.npz")
    convert.save_npz(path2, loaded)
    back, jcfg = jconvert.load_npz(path2)
    assert jcfg == jenc.EncoderConfig(128, 2, 2)
    for k in params:
        np.testing.assert_array_equal(np.asarray(back[k]), np.asarray(params[k]))


def test_convert_cli_matches_jax(tmp_path):
    blocks = torch_ref.make_encoder(64, 2, 4, seed=8)
    pth = str(tmp_path / "enc.pth")
    torch.save(blocks.state_dict(), pth)
    convert.main([pth, str(tmp_path / "port.npz")])
    jconvert.main([pth, str(tmp_path / "jax.npz")])
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    params, cfg = convert.convert_pth(pth, device="cpu")
    assert cfg.dim == 64 and params["qkv_w"].shape == (2, 64, 192)


@pytest.mark.parametrize("shapes", [((2, 5, 7), (2, 7, 3)), ((2, 3, 5, 7), (2, 3, 7, 4))])
def test_matmul_at_default_rounds_operands_and_cotangent(shapes):
    """Batched products at "default" (the Mask2Former head's attention and
    mask products): bf16 operands, fp32 sums and result; the backward
    rounds the cotangent to bf16. "highest" is the fp32 product."""
    rng = np.random.default_rng(11)
    a, b = (torch.tensor(rng.standard_normal(s).astype(np.float32)) for s in shapes)
    torch.testing.assert_close(enc.matmul_at(a, b, "highest"), a @ b, atol=0, rtol=0)
    r = lambda t: t.bfloat16().float()  # noqa: E731
    got = enc.matmul_at(a, b, "default")
    torch.testing.assert_close(got, r(a) @ r(b), atol=1e-5, rtol=0)
    assert got.dtype == torch.float32 and not torch.equal(got, r(got))
    ag, bg = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    cot = torch.tensor(rng.standard_normal(tuple(got.shape)).astype(np.float32))
    enc.matmul_at(ag, bg, "default").backward(cot)
    torch.testing.assert_close(ag.grad, r(cot) @ r(b).mT, atol=1e-5, rtol=0)
    torch.testing.assert_close(bg.grad, r(a).mT @ r(cot), atol=1e-5, rtol=0)
    with pytest.raises(ValueError):
        enc.matmul_at(a, b, "tf32")


def test_to_numpy_inverts_from_numpy():
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3), "b": {"c": np.ones(2)}}
    back = convert.to_numpy(convert.from_numpy(tree, "cpu"))
    np.testing.assert_array_equal(back["a"], tree["a"])
    np.testing.assert_array_equal(back["b"]["c"], tree["b"]["c"])
    bf = convert.to_numpy({"w": torch.tensor([1.5, -2.0], dtype=torch.bfloat16)})
    assert bf["w"].dtype == np.float32


def test_port_never_imports_jax():
    code = (
        "import sys, pkgutil, importlib, metatransformer_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', "
        "'metatransformer_tpu.')) or m == 'metatransformer_tpu']\n"
        "assert not bad, bad\n"
        "mods = [m for m in sys.modules if m.startswith(p.__name__)]\n"
        "new = ['ops.flash_attention', 'tokenizers.video', 'models.video_classifier', "
        "'models.video_eval', 'models.video_pretrain', 'ops.point_ops', 'ops.point_interp', "
        "'tokenizers.point', 'models.point_classifier', 'models.point_segmenter', "
        "'models.point_mae', 'models.point_multiview', 'runtime.native', 'serving', "
        "'data.codecs', 'data.video_decode', 'data.video_dataset', 'data.rand_augment', "
        "'demo', 'ops.performer', 'data.graph_collate', 'models.graph_predictor', "
        "'configs', 'configs.config', 'utils.metrics', 'utils.seg_eval', 'utils.profiler', "
        "'data.image_folder', 'recipes', 'train_cli', 'core.beit', 'models.vit_adapter', "
        "'ops.ms_deform_attn', 'ops.window_attention', 'ops.matching', 'heads.upernet', "
        "'heads.maskformer', 'heads.mask2former', 'models.segmentor', 'core.tree', "
        "'heads.detection2d', 'heads.detr', 'models.mask_rcnn', 'models.htc', "
        "'train.augment', 'ops.iou3d', 'ops.voxelize', 'ops.sparse_conv', 'ops.roi_pool3d', "
        "'models.detector3d', 'models.second', 'models.voxel_rcnn', 'models.pv_rcnn']\n"
        "missing = [n for n in new if p.__name__ + '.' + n not in mods]\n"
        "assert not missing, missing\n"
        "print(len(mods))\n"
        # the build_* functions import their models at call time, which walking the
        # package never reaches: build every ported recipe, then look again
        "import os, torch\n"
        "from metatransformer_tpu_torch import recipes\n"
        "from metatransformer_tpu_torch.configs import CONFIG_DIR, load_config\n"
        "built = 0\n"
        "for n in sorted(os.listdir(CONFIG_DIR)):\n"
        "    if not n.endswith('.yaml') or n == 'default.yaml':\n"
        "        continue\n"
        "    try:\n"
        "        recipes.build(load_config(os.path.join(CONFIG_DIR, n)), "
        "torch.Generator().manual_seed(0), smoke=True, device='cpu')\n"
        "        built += 1\n"
        "    except NotImplementedError:\n"
        "        pass\n"
        "assert built == 36, built\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', "
        "'metatransformer_tpu.')) or m == 'metatransformer_tpu']\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        cwd=Path(__file__).resolve().parent.parent,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) >= 80
