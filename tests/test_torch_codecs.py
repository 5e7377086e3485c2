"""The port's host data modules vs the JAX reference: the serving-edge
codecs (``data/codecs.py``), video container decode
(``data/video_decode.py``), the video dataset helpers
(``data/video_dataset.py``) and RandAugment (``data/rand_augment.py``).

Every decoded payload must equal the JAX package's byte for byte: PNG,
JPEG, BMP, GIF (still and animated), WebP, TIFF, DIB and MJPEG AVI, MP4
through cv2, npy and npz; WAV log-mel at 1e-4. The port decodes images
through Pillow only; the reference prefers cv2 where it imports (it does
here), so the reference is run on its PIL branch, which is the eval
protocol. The numpy augmentations must be exact from one seed.
"""

import io
import json
import os
import sys
import tempfile
import wave

import numpy as np
import pytest

from metatransformer_tpu.data import codecs as jcodecs
from metatransformer_tpu.data import image_folder as jimage_folder
from metatransformer_tpu.data import rand_augment as jra
from metatransformer_tpu.data import video_dataset as jvd
from metatransformer_tpu.data import video_decode as jvdec
from metatransformer_tpu_torch.data import codecs, rand_augment, video_dataset, video_decode

pytest.importorskip("PIL")
from PIL import Image  # noqa: E402


@pytest.fixture
def reference_on_pil(monkeypatch):
    """The JAX package's image decode on its PIL branch (cv2 off)."""
    monkeypatch.setattr(jimage_folder, "_CV2", None)
    monkeypatch.setattr(jimage_folder, "_CV2_TRIED", True)


def _image_bytes(fmt, h=96, w=120, seed=0, **kw) -> bytes:
    arr = np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)
    bio = io.BytesIO()
    Image.fromarray(arr).save(bio, fmt, **kw)
    return bio.getvalue()


def _wav_bytes(seconds=0.5, sr=16000, freq=440.0, channels=1) -> bytes:
    t = np.arange(int(sr * seconds)) / sr
    pcm = (np.sin(2 * np.pi * freq * t) * 2**14).astype(np.int16)
    if channels == 2:
        pcm = np.stack([pcm, pcm // 2], -1)
    bio = io.BytesIO()
    with wave.open(bio, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
    return bio.getvalue()


def _smooth_frames(t=12, h=48, w=64):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = []
    for i in range(t):
        r = 127 + 100 * np.sin(yy / 16 + i * 0.4)
        g = 127 + 100 * np.cos(xx / 20 - i * 0.3)
        b = np.full((h, w), 30.0 + 10 * i)
        frames.append(np.stack([r, g, b], -1))
    return np.clip(np.stack(frames), 0, 255).astype(np.uint8)


def _avi_bytes(writer, frames) -> bytes:
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "clip.avi")
        writer(frames, path)
        with open(path, "rb") as f:
            return f.read()


def _equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _equal(got[k], want[k])
        return
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ codecs


def test_sniff_matches_jax():
    payloads = [_image_bytes("JPEG"), _image_bytes("PNG"), _wav_bytes(),
                _avi_bytes(video_decode.write_dib_avi, _smooth_frames(t=2)),
                codecs.encode_npy(np.zeros(3)), codecs.encode_npz({"a": np.zeros(3)}),
                "hello world".encode(), b"\x00\x00\x00\x18ftypmp42", b"\x1a\x45\xdf\xa3xx"]
    for fmt in ("BMP", "WEBP", "GIF", "TIFF"):
        try:
            payloads.append(_image_bytes(fmt, 8, 8))
        except (KeyError, OSError):  # Pillow built without this codec
            continue
    kinds = [codecs.sniff(p) for p in payloads]
    assert kinds == [jcodecs.sniff(p) for p in payloads]
    assert kinds[:9] == ["jpeg", "png", "wav", "avi", "npy", "npz", "utf8", "mp4", "mkv"]


@pytest.mark.parametrize("fmt", ["JPEG", "PNG", "BMP", "GIF", "WEBP", "TIFF"])
@pytest.mark.parametrize("modality,size", [("image", 64), ("x-ray", 32), ("infrared", 32),
                                           ("video", 32)])
def test_image_payload_equals_jax_pil_branch(fmt, modality, size, reference_on_pil):
    try:
        payload = _image_bytes(fmt, quality=90) if fmt == "JPEG" else _image_bytes(fmt)
    except (KeyError, OSError):
        pytest.skip(f"Pillow built without {fmt}")
    opts = dict(img_size=size, num_frames=4)
    got = codecs.decode_payload(modality, payload, **opts)
    _equal(got, jcodecs.decode_payload(modality, payload, **opts))
    channels = 1 if modality == "infrared" else 3
    want_shape = (1, 4, size, size, 3) if modality == "video" else (1, size, size, channels)
    assert got.shape == want_shape and got.dtype == np.uint8


def test_tall_and_wide_images_crop_as_jax(reference_on_pil):
    for h, w in ((200, 90), (90, 200), (224, 224)):
        payload = _image_bytes("PNG", h, w, seed=h)
        _equal(codecs.decode_payload("image", payload, img_size=48),
               jcodecs.decode_payload("image", payload, img_size=48))


def test_animated_gif_clip_equals_jax():
    frames = [Image.fromarray(np.full((48, 64, 3), 20 * i, np.uint8)) for i in range(12)]
    bio = io.BytesIO()
    frames[0].save(bio, "GIF", save_all=True, append_images=frames[1:], duration=40)
    got = codecs.decode_payload("video", bio.getvalue(), num_frames=4, img_size=32)
    _equal(got, jcodecs.decode_payload("video", bio.getvalue(), num_frames=4, img_size=32))
    means = got[0].reshape(4, -1).mean(1)
    assert means[-1] > means[0] + 50


@pytest.mark.parametrize("writer", ["dib", "mjpeg"])
def test_avi_payload_equals_jax(writer):
    frames = _smooth_frames(t=10, h=64, w=80)
    write = {"dib": video_decode.write_dib_avi, "mjpeg": video_decode.write_mjpeg_avi}[writer]
    jwrite = {"dib": jvdec.write_dib_avi, "mjpeg": jvdec.write_mjpeg_avi}[writer]
    payload = _avi_bytes(write, frames)
    assert payload == _avi_bytes(jwrite, frames)  # the writers agree too
    got = codecs.decode_payload("video", payload, img_size=48, num_frames=8)
    _equal(got, jcodecs.decode_payload("video", payload, img_size=48, num_frames=8))
    assert got.shape == (1, 8, 48, 48, 3)


def test_mp4_payload_through_cv2_equals_jax():
    cv2 = pytest.importorskip("cv2")
    frames = np.stack([np.full((48, 64, 3), 40 * i, np.uint8) for i in range(6)])
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "clip.mp4")
        wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 12, (64, 48))
        assert wr.isOpened()
        for fr in frames:
            wr.write(fr[..., ::-1])
        wr.release()
        with open(path, "rb") as f:
            payload = f.read()
        assert video_decode.count_video_frames(path) == jvdec.count_video_frames(path)
        _equal(video_decode.read_video(path, np.array([5, 0, 2, 2])),
               jvdec.read_video(path, np.array([5, 0, 2, 2])))
    got = codecs.decode_payload("video", payload, img_size=32, num_frames=4)
    _equal(got, jcodecs.decode_payload("video", payload, img_size=32, num_frames=4))
    with pytest.raises(ValueError, match="mp4 payload"):
        codecs.decode_payload("image", payload)


@pytest.mark.parametrize("channels,frames", [(1, 64), (2, 64), (1, 32)])
def test_wav_payload_matches_jax(channels, frames):
    payload = _wav_bytes(channels=channels)
    got = codecs.decode_payload("audio", payload, audio_frames=frames, mel_bins=128)
    want = jcodecs.decode_payload("audio", payload, audio_frames=frames, mel_bins=128)
    assert got.shape == want.shape == (1, frames, 128) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    if frames > 48:  # 0.5 s -> 48 frames; the rest is zero padding
        assert (got[0, 48:] == 0).all()


def test_text_payload_equals_jax():
    for text in ("a photo of a cat", "Ünïcödé, punctuation! and 123 digits"):
        _equal(codecs.decode_payload("text", text.encode()),
               jcodecs.decode_payload("text", text.encode()))
    got = codecs.decode_payload("text", b"short", text_context=16)
    assert got.shape == (1, 16) and got.dtype == np.int32


def test_npy_npz_payloads_equal_jax():
    rng = np.random.default_rng(0)
    pts = rng.standard_normal((256, 3), np.float32)
    for payload in (codecs.encode_npy(pts), jcodecs.encode_npy(pts)):
        _equal(codecs.decode_payload("point", payload), jcodecs.decode_payload("point", payload))
    assert codecs.encode_npy(pts) == jcodecs.encode_npy(pts)
    g = {"x": np.zeros((5, 9), np.float32), "ids": np.arange(5)}
    got = codecs.decode_payload("graph", codecs.encode_npz(g))
    _equal(got, jcodecs.decode_payload("graph", jcodecs.encode_npz(g)))
    assert got["x"].shape == (1, 5, 9)


def test_wrong_container_rejected_as_jax():
    for modality, payload, match in (("audio", _image_bytes("JPEG"), "payload for modality"),
                                     ("point", b"not a container", "tensor modalities"),
                                     ("image", _wav_bytes(), "wav payload"),
                                     ("image", _avi_bytes(video_decode.write_dib_avi,
                                                          _smooth_frames(t=2)), "avi payload")):
        with pytest.raises(ValueError, match=match):
            codecs.decode_payload(modality, payload)
        with pytest.raises(ValueError, match=match):
            jcodecs.decode_payload(modality, payload)


def test_missing_pillow_is_named(monkeypatch):
    """Without Pillow an image payload, an animated GIF and an MJPEG AVI
    raise an ImportError that names it; DIB AVIs and tensors still decode."""
    dib = _avi_bytes(video_decode.write_dib_avi, _smooth_frames(t=4))
    mjpeg = _avi_bytes(video_decode.write_mjpeg_avi, _smooth_frames(t=4))
    png, gif = _image_bytes("PNG"), _image_bytes("GIF")
    monkeypatch.setitem(sys.modules, "PIL", None)
    for modality, payload in (("image", png), ("video", gif), ("video", mjpeg)):
        with pytest.raises(ImportError, match="Pillow"):
            codecs.decode_payload(modality, payload, img_size=32, num_frames=2)
    clip = codecs.decode_payload("video", dib, img_size=32, num_frames=2)
    assert clip.shape == (1, 2, 32, 32, 3)
    with pytest.raises(ImportError, match="Pillow"):
        video_decode.write_mjpeg_avi(_smooth_frames(t=1), "unused.avi")


def test_missing_cv2_is_named(monkeypatch, tmp_path):
    """Containers other than MJPEG / DIB AVI need cv2: without it they
    raise naming it, as the reference does; nothing substitutes."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    assert not video_decode.has_cv2()
    path = tmp_path / "clip.mp4"
    path.write_bytes(b"\x00\x00\x00\x18ftypmp42" + b"\x00" * 64)
    with pytest.raises(RuntimeError, match="cv2"):
        video_decode.read_video(str(path))
    with pytest.raises(RuntimeError, match="cv2"):
        video_decode.count_video_frames(str(path))
    with pytest.raises(RuntimeError, match="cv2"):
        codecs.decode_payload("video", path.read_bytes(), img_size=32, num_frames=2)


# ------------------------------------------------------------ video decode


def test_avi_reader_and_probe_equal_jax(tmp_path):
    frames = np.random.default_rng(0).integers(0, 256, (5, 33, 47, 3), np.uint8)
    for name, write in (("raw.avi", video_decode.write_dib_avi),
                        ("mj.avi", video_decode.write_mjpeg_avi)):
        path = str(tmp_path / name)
        write(frames, path)
        for idx in (None, np.array([0, 3, 3, 4, 1])):
            _equal(video_decode.read_avi(path, idx), jvdec.read_avi(path, idx))
        info, jinfo = video_decode.probe_avi(path), jvdec.probe_avi(path)
        assert vars(info) == vars(jinfo)
        assert video_decode.count_frames(path) == jvdec.count_frames(path) == 5
    np.testing.assert_array_equal(video_decode.read_avi(str(tmp_path / "raw.avi")), frames)


def test_truncated_and_non_avi_rejected(tmp_path):
    path = tmp_path / "junk.avi"
    path.write_bytes(b"RIFF\x10\x00\x00\x00AVI junkdata")
    with pytest.raises(ValueError, match="no video stream"):
        video_decode.read_avi(str(path))
    path.write_bytes(b"\x89PNG\r\n\x1a\nnot an avi file at all")
    with pytest.raises(ValueError, match="not a RIFF"):
        video_decode.read_avi(str(path))


# ----------------------------------------------- video dataset, RandAugment


def test_video_dataset_helpers_equal_jax():
    rng_frames = np.random.default_rng(3)
    frames = rng_frames.integers(0, 256, (20, 40, 56, 3), np.uint8)
    for total, n in ((20, 8), (5, 16), (1, 4)):
        for clip, clips in ((0, 1), (2, 5), (4, 5)):
            _equal(video_dataset.sample_frame_indices(total, n, test_clip=clip,
                                                      test_num_clips=clips),
                   jvd.sample_frame_indices(total, n, test_clip=clip, test_num_clips=clips))
        _equal(video_dataset.sample_frame_indices(total, n, np.random.default_rng(1)),
               jvd.sample_frame_indices(total, n, np.random.default_rng(1)))
    for a, b in zip(video_dataset.three_crop(frames, 24), jvd.three_crop(frames, 24)):
        _equal(a, b)
    for a, b in zip(video_dataset.three_crop(frames.transpose(0, 2, 1, 3), 24),
                    jvd.three_crop(frames.transpose(0, 2, 1, 3), 24)):
        _equal(a, b)
    _equal(video_dataset._resize(frames, 17, 29), jvd._resize(frames, 17, 29))
    _equal(video_dataset.normalize(frames), jvd.normalize(frames))
    cfg = video_dataset.VideoDatasetConfig(num_frames=4, crop_size=16, test_num_clips=2)
    jcfg = jvd.VideoDatasetConfig(num_frames=4, crop_size=16, test_num_clips=2)
    _equal(video_dataset.test_views(frames, cfg), jvd.test_views(frames, jcfg))


@pytest.mark.parametrize("aug,erase", [("", 0.0), ("rand-m7-n4-mstd0.5", 0.0),
                                       ("rand-m9-n2", 1.0)])
def test_train_clip_equals_jax_from_one_seed(aug, erase):
    frames = np.random.default_rng(4).integers(0, 256, (12, 40, 48, 3), np.uint8)
    cfg = video_dataset.VideoDatasetConfig(num_frames=4, crop_size=24, rand_augment=aug,
                                           erase_prob=erase)
    jcfg = jvd.VideoDatasetConfig(num_frames=4, crop_size=24, rand_augment=aug,
                                  erase_prob=erase)
    for seed in range(3):
        _equal(video_dataset.train_clip(frames, cfg, np.random.default_rng(seed)),
               jvd.train_clip(frames, jcfg, np.random.default_rng(seed)))


def test_avi_manifest_batches_equal_jax(tmp_path):
    items = []
    for i in range(4):
        path = tmp_path / f"clip{i}.avi"
        video_decode.write_dib_avi(_smooth_frames(t=10 + i), str(path))
        items.append({"clip": str(path), "label": i % 2})
    manifest = tmp_path / "manifest.jsonl"
    manifest.write_text("\n".join(json.dumps(it) for it in items))
    loaded = video_dataset.read_manifest(str(manifest))
    assert loaded == jvd.read_manifest(str(manifest))
    cfg = video_dataset.VideoDatasetConfig(num_frames=8, crop_size=32)
    jcfg = jvd.VideoDatasetConfig(num_frames=8, crop_size=32)
    got = list(video_dataset.iter_batches(loaded, cfg, 2, np.random.default_rng(0)))
    want = list(jvd.iter_batches(loaded, jcfg, 2, np.random.default_rng(0)))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _equal(g, w)


def test_rand_augment_ops_equal_jax():
    clip = np.random.default_rng(5).uniform(0, 255, (3, 20, 24, 3)).astype(np.float32)
    names = [n for n in dir(jra) if not n.startswith("_") and callable(getattr(jra, n))]
    ops = [n for n in names if n in dir(rand_augment) and n not in (
        "parse_config", "rand_augment_clip", "RandAugmentConfig", "dataclass", "field")]
    ops = [n for n in ops if getattr(jra, n).__module__ == jra.__name__]
    assert {"rotate", "posterize", "equalize", "shear_x", "translate_y"} <= set(ops)
    for name in ops:
        for level in (0.0, 3.0, 7.0, 10.0):
            np.random.seed(int(level))  # the ops draw their sign flips from it
            got = getattr(rand_augment, name)(clip, level)
            np.random.seed(int(level))
            _equal(got, getattr(jra, name)(clip, level))


@pytest.mark.parametrize("spec", ["rand-m7-n4-mstd0.5", "rand-m9-n2", "rand-m5-n3-mstd0"])
def test_rand_augment_clip_equals_jax_from_one_seed(spec):
    assert vars(rand_augment.parse_config(spec)) == vars(jra.parse_config(spec))
    clip = np.random.default_rng(6).uniform(0, 255, (4, 16, 20, 3)).astype(np.float32)
    for seed in range(4):
        _equal(rand_augment.rand_augment_clip(clip, rand_augment.parse_config(spec),
                                              np.random.default_rng(seed)),
               jra.rand_augment_clip(clip, jra.parse_config(spec), np.random.default_rng(seed)))
