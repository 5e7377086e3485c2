"""The port's demo CLI (``demo.py``) on the CPU: every modality's synthetic
path runs raw -> pooled features at ViT-B16 width (FP32), media inputs go
through the port's codecs, a head prints its top-k, and without
``--device`` the demo runs on the card or raises. Its host pieces
(``synthetic_input``, ``load_input``, ``tokenize_text``, ``_load_encoder``)
are held to the JAX demo's.

Drawing the 12 random ViT-B16 blocks takes seconds on the CPU, so one case
runs the default random encoder and the others load a one-block 768-wide
checkpoint through ``--ckpt``.
"""

import wave

import jax
import numpy as np
import pytest
import torch

from metatransformer_tpu import demo as jdemo
from metatransformer_tpu.core import convert as jconvert
from metatransformer_tpu.data import image_folder as jimage_folder
from metatransformer_tpu_torch import demo
from metatransformer_tpu_torch.core import convert, encoder as enc
from metatransformer_tpu_torch.data import video_decode

from tests import torch_ref

torch.set_num_threads(2)

CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def one_block(tmp_path_factory):
    """--ckpt arguments of a seeded one-block, 768-wide encoder (.npz)."""
    path = str(tmp_path_factory.mktemp("ckpt") / "one_block.npz")
    cfg = enc.EncoderConfig(dim=768, depth=1, num_heads=12)
    convert.save_npz(path, enc.init(cfg, torch.Generator().manual_seed(0), "cpu"))
    return ["--ckpt", path]


def test_demo_synthetic_default_encoder(capsys):
    """No --ckpt: the random ViT-B16 encoder, 12 blocks."""
    assert demo.main(["--modality", "image", "--synthetic"] + CPU) == 0
    out = capsys.readouterr().out
    assert "modality=image device=cpu tokens=(1, 196, 768) features=(1, 196, 768)" in out
    assert "pooled[0:8]" in out


@pytest.mark.parametrize(
    "modality",
    ["image", "audio", "time-series", "point", "tabular", "graph", "hyper",
     "text", "imu", "infrared", "x-ray"],  # video: T = 1568 at full width, as test_demo.py
)
def test_demo_synthetic(modality, one_block, capsys):
    assert demo.main(["--modality", modality, "--synthetic"] + one_block + CPU) == 0
    out = capsys.readouterr().out
    assert f"modality={modality}" in out and "pooled[0:8]" in out
    assert "device=cpu" in out and "features=(1, " in out


def test_demo_with_head_and_npy_input(tmp_path, one_block, capsys):
    rng = np.random.default_rng(0)
    np.save(tmp_path / "img.npy", rng.uniform(0, 1, (1, 224, 224, 3)).astype(np.float32))
    np.savez(tmp_path / "head.npz", w=rng.normal(size=(768, 10)), b=np.zeros(10))
    rc = demo.main(["--modality", "image", "--input", str(tmp_path / "img.npy"),
                    "--head", str(tmp_path / "head.npz"), "--top-k", "3"] + one_block + CPU)
    assert rc == 0
    out = capsys.readouterr().out
    assert "top-k:" in out and out.count("class ") == 3


def _wav(path, seconds=0.3, sr=16000):
    pcm = (np.sin(2 * np.pi * 440 * np.arange(int(sr * seconds)) / sr) * 2**14).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def test_demo_with_media_inputs(tmp_path, one_block, capsys):
    """JPEG (image, x-ray) and WAV (audio) through the port's codecs, and
    raw text (a string, a .txt of lines) through the BPE."""
    from PIL import Image

    rng = np.random.default_rng(0)
    Image.fromarray(rng.integers(0, 256, (240, 320, 3), np.uint8)).save(
        tmp_path / "photo.jpg", quality=90)
    _wav(tmp_path / "tone.wav")
    (tmp_path / "lines.txt").write_text("a photo of a cat\n\nwo dogs\n")
    for args, tokens in (
        (["--modality", "image", "--input", str(tmp_path / "photo.jpg")], "tokens=(1, 196, 768)"),
        (["--modality", "x-ray", "--input", str(tmp_path / "photo.jpg")], "tokens=(1, 196,"),
        (["--modality", "audio", "--input", str(tmp_path / "tone.wav")], "tokens=(1, 1212, 768)"),
        (["--modality", "text", "--text", "a photo of a cat"], "tokens=(1, 1, 768)"),
        (["--modality", "text", "--input", str(tmp_path / "lines.txt")], "tokens=(2, 1, 768)"),
    ):
        assert demo.main(args + one_block + CPU) == 0
        out = capsys.readouterr().out
        assert tokens in out and "pooled[0:8]" in out, (args, out)


def test_demo_with_a_converted_checkpoint(tmp_path, capsys):
    """--ckpt takes the port's converted .npz and a released-layout .pth."""
    blocks = torch_ref.make_encoder(768, 1, 12, seed=3)
    torch.save(blocks.state_dict(), tmp_path / "enc.pth")
    params, cfg = convert.convert_pth(str(tmp_path / "enc.pth"), device="cpu")
    convert.save_npz(str(tmp_path / "enc.npz"), params)
    outs = []
    for ckpt in ("enc.pth", "enc.npz"):
        assert demo.main(["--modality", "tabular", "--synthetic", "--ckpt",
                          str(tmp_path / ckpt)] + CPU) == 0
        outs.append(capsys.readouterr().out.splitlines()[1])
    assert outs[0] == outs[1]
    assert cfg.depth == 1


def test_demo_without_a_device_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        demo.main(["--modality", "image", "--synthetic"])
    with pytest.raises(SystemExit):  # no input at all: the parser's error
        demo.main(["--modality", "image"] + CPU)


@pytest.mark.parametrize("modality", ["image", "video", "audio", "time-series", "hyper",
                                      "point", "tabular", "text", "graph"])
def test_synthetic_input_equals_jax(modality):
    got = demo.synthetic_input(modality, np.random.default_rng(5))
    want = jdemo.synthetic_input(modality, np.random.default_rng(5))
    for g, w in ((got, want),) if not isinstance(want, dict) else (
            (got[k], want[k]) for k in want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="no synthetic generator"):
        demo.synthetic_input("smell", np.random.default_rng(0))


def test_load_input_and_tokenize_text_equal_jax(tmp_path, monkeypatch):
    from PIL import Image

    monkeypatch.setattr(jimage_folder, "_CV2", None)  # the reference's PIL branch
    monkeypatch.setattr(jimage_folder, "_CV2_TRIED", True)
    rng = np.random.default_rng(1)
    Image.fromarray(rng.integers(0, 256, (100, 150, 3), np.uint8)).save(tmp_path / "a.png")
    video_decode.write_dib_avi(rng.integers(0, 256, (6, 40, 48, 3), np.uint8),
                               str(tmp_path / "v.avi"))
    _wav(tmp_path / "t.wav")
    np.save(tmp_path / "x.npy", rng.standard_normal((1, 5)))
    np.savez(tmp_path / "g.npz", a=np.arange(3), b=np.ones((2, 2)))
    for name, modality in (("a.png", "image"), ("v.avi", "video"), ("t.wav", "audio"),
                           ("x.npy", None), ("g.npz", None)):
        got = demo.load_input(str(tmp_path / name), modality)
        want = jdemo.load_input(str(tmp_path / name), modality)
        if isinstance(want, dict):
            assert set(got) == set(want)
            got, want = [got[k] for k in sorted(got)], [want[k] for k in sorted(want)]
        else:
            got, want = [got], [want]
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    texts = ["a photo of a cat", "two dogs, 3 birds!"]
    np.testing.assert_array_equal(demo.tokenize_text(texts), jdemo.tokenize_text(texts))


def test_load_encoder_equals_jax_conversion(tmp_path):
    blocks = torch_ref.make_encoder(64, 2, 4, seed=8)
    torch.save(blocks.state_dict(), tmp_path / "enc.pth")
    jparams, jcfg = jdemo._load_encoder(str(tmp_path / "enc.pth"), jax.random.PRNGKey(0))
    params, cfg = demo._load_encoder(str(tmp_path / "enc.pth"), torch.Generator(), "cpu")
    assert (cfg.dim, cfg.depth, cfg.num_heads) == (jcfg.dim, jcfg.depth, jcfg.num_heads)
    for k in jparams:
        np.testing.assert_array_equal(params[k].numpy(), np.asarray(jparams[k]))
    jconvert.save_npz(str(tmp_path / "enc.npz"), jparams)
    params, cfg = demo._load_encoder(str(tmp_path / "enc.npz"), torch.Generator(), "cpu")
    assert cfg.dim == 64 and params["qkv_w"].shape == (2, 64, 192)
