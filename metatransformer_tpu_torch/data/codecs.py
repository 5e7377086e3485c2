"""Serving-edge payload codecs: encoded bytes -> model-ready arrays.

Port of ``metatransformer_tpu/data/codecs.py``. A production frontend
receives encoded payloads — JPEG/PNG images, AVI/MP4/MKV video, PCM WAV
audio, UTF-8 text, npy tensors — not float arrays. ``decode_payload``
sniffs the container by magic bytes and produces the wire format the
serving path takes (uint8 pixels, fbank spectrograms, BPE token ids, float
tensors), so ``ServingDaemon.submit`` accepts raw bytes. Decoding is numpy
on the host, on the caller's thread; the arrays go to the card in
``serving.Dispatcher``.

Image bytes decode through Pillow only: short side to ``size * 256 / 224``
with PIL's antialiased bilinear resize, then a centre crop (the eval
protocol). The reference prefers cv2 where it imports, which downscales
without antialiasing, so the two packages agree byte for byte on the
reference's PIL branch. A payload that needs Pillow raises an
``ImportError`` naming it when Pillow is missing; video containers other
than MJPEG / DIB AVI need cv2 (``video_decode``) and raise without it.

npy payloads are the tensor wire format for modalities without a
standard container (point clouds, time-series, IMU, tabular, hyper,
graph dicts via npz): arrays are stored UNBATCHED (one request each) and
get the leading batch axis here.
"""

from __future__ import annotations

import io
from typing import Any, Dict, Optional

import numpy as np

from metatransformer_tpu_torch.data import video_decode
from metatransformer_tpu_torch.ops import fbank as fbank_ops

# magic-byte signatures, checked in order
_JPEG = b"\xff\xd8\xff"
_PNG = b"\x89PNG\r\n\x1a\n"
_GIF = (b"GIF87a", b"GIF89a")
_TIFF = (b"II*\x00", b"MM\x00*")
_BMP = b"BM"
_RIFF = b"RIFF"
_NPY = b"\x93NUMPY"
_ZIP = b"PK\x03\x04"  # npz
_EBML = b"\x1a\x45\xdf\xa3"  # Matroska/WebM

_IMAGE_KINDS = ("jpeg", "png", "bmp", "webp", "gif", "tiff")
_VIDEO_KINDS = {"avi": ".avi", "mp4": ".mp4", "mkv": ".mkv"}


def sniff(payload: bytes) -> str:
    """-> 'jpeg' | 'png' | 'bmp' | 'webp' | 'gif' | 'tiff' | 'avi' |
    'mp4' | 'mkv' | 'wav' | 'npy' | 'npz' | 'utf8'."""
    if payload.startswith(_JPEG):
        return "jpeg"
    if payload.startswith(_PNG):
        return "png"
    if payload.startswith(_GIF):
        return "gif"
    if payload.startswith(_TIFF):
        return "tiff"
    if payload.startswith(_RIFF) and len(payload) >= 12:
        form = payload[8:12]
        if form == b"AVI ":
            return "avi"
        if form == b"WAVE":
            return "wav"
        if form == b"WEBP":
            return "webp"
    if len(payload) >= 12 and payload[4:8] == b"ftyp":
        return "mp4"  # ISO BMFF: mp4/m4v/mov
    if payload.startswith(_EBML):
        return "mkv"  # Matroska/WebM
    if payload.startswith(_NPY):
        return "npy"
    if payload.startswith(_ZIP):
        return "npz"
    if payload.startswith(_BMP):
        return "bmp"
    return "utf8"


def _pil_image(kind: str):
    """PIL's ``Image`` module, or an ImportError naming Pillow."""
    try:
        from PIL import Image
    except ImportError as exc:
        raise ImportError(
            f"decoding a {kind} payload needs Pillow (PIL), which is not importable"
        ) from exc
    return Image


def _decode_image_bytes(payload: bytes, size: int, channels: int) -> np.ndarray:
    """Eval-protocol decode: short side to size*256/224 (PIL bilinear,
    antialiased), center crop. -> uint8 [1, size, size, channels]."""
    Image = _pil_image(sniff(payload))
    with Image.open(io.BytesIO(payload)) as im:
        im = im.convert("L" if channels == 1 else "RGB")
        w, h = im.size
        short = int(round(size * 256 / 224))
        if w <= h:
            nw, nh = short, max(int(round(h * short / w)), short)
        else:
            nh, nw = short, max(int(round(w * short / h)), short)
        im = im.resize((nw, nh), Image.BILINEAR)
        x0, y0 = (nw - size) // 2, (nh - size) // 2
        im = im.crop((x0, y0, x0 + size, y0 + size))
        arr = np.asarray(im, np.uint8)
    if channels == 1:
        arr = arr[..., None]
    return arr[None]


def _decode_video_bytes(
    payload: bytes, num_frames: int, size: int, suffix: str = ".avi"
) -> np.ndarray:
    """Video container (AVI/MP4/MKV/WebM) -> center-view clip: evenly
    sampled frames, short-side resize, center crop (view 0 of the
    reference's multi-view test protocol).
    -> uint8 [1, num_frames, size, size, 3]."""
    import os
    import tempfile

    from metatransformer_tpu_torch.data import video_dataset

    # the demuxers want a path; spill to tmpfs (payloads are MBs, not GBs)
    with tempfile.NamedTemporaryFile(suffix=suffix, delete=False) as f:
        f.write(payload)
        path = f.name
    try:
        total = video_decode.count_video_frames(path)
        idx = video_dataset.sample_frame_indices(
            total, num_frames, test_clip=0, test_num_clips=1
        )
        frames = video_decode.read_video(path, idx)
    finally:
        os.unlink(path)
    crops = video_dataset.three_crop(frames, size)
    return crops[1][None].astype(np.uint8)  # center crop


def _decode_gif_clip(payload: bytes, num_frames: int, size: int) -> np.ndarray:
    """Animated GIF -> center-view clip, same sampling/crop protocol as
    the AVI path. -> uint8 [1, num_frames, size, size, 3]."""
    from metatransformer_tpu_torch.data import video_dataset

    Image = _pil_image("gif")
    with Image.open(io.BytesIO(payload)) as im:
        total = getattr(im, "n_frames", 1)
        idx = video_dataset.sample_frame_indices(
            total, num_frames, test_clip=0, test_num_clips=1
        )
        frames, cache = [], {}
        for i in idx:
            i = int(i)
            if i not in cache:
                im.seek(i)
                cache[i] = np.asarray(im.convert("RGB"), np.uint8)
            frames.append(cache[i])
    crops = video_dataset.three_crop(np.stack(frames), size)
    return crops[1][None].astype(np.uint8)  # center crop


def _decode_wav_bytes(
    payload: bytes, target_frames: int, mel_bins: int
) -> np.ndarray:
    """PCM WAV -> log-mel fbank [1, target_frames, mel_bins] float32
    (the AST input format; fbank math = ops/fbank.py's numpy ``fbank_np``,
    pad/trim on the frame axis like the AST dataloader)."""
    import wave

    with wave.open(io.BytesIO(payload), "rb") as w:
        sr = w.getframerate()
        raw = w.readframes(w.getnframes())
        data = np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32768.0
        if w.getnchannels() > 1:
            data = data.reshape(-1, w.getnchannels()).mean(1)
    cfg = fbank_ops.FbankConfig(sample_rate=sr, num_mel_bins=mel_bins)
    spec = fbank_ops.fbank_np(data, cfg)  # [frames, mel]
    t = spec.shape[0]
    if t >= target_frames:
        spec = spec[:target_frames]
    else:
        spec = np.pad(spec, ((0, target_frames - t), (0, 0)))
    return spec[None].astype(np.float32)


def _decode_text_bytes(payload: bytes, context: int, bpe=None) -> np.ndarray:
    """UTF-8 -> CLIP tokenize semantics (SOT + BPE ids + EOT, zero-pad)
    -> int32 [1, context]."""
    from metatransformer_tpu_torch.tokenizers import bpe as bpe_mod

    enc = bpe if bpe is not None else bpe_mod.CLIPBPE()
    return enc.tokenize(payload.decode("utf-8"), context_length=context)


def _decode_npy(payload: bytes) -> Any:
    kind = sniff(payload)
    if kind == "npz":
        with np.load(io.BytesIO(payload)) as z:
            return {k: z[k][None] for k in z.files}
    arr = np.load(io.BytesIO(payload))
    return arr[None]


def decode_payload(
    modality: str,
    payload: bytes,
    *,
    img_size: int = 224,
    num_frames: int = 16,
    audio_frames: int = 1024,
    mel_bins: int = 128,
    text_context: int = 77,
    bpe=None,
) -> Any:
    """Encoded request bytes -> the batched array(s) the modality's
    tokenizer consumes (leading batch axis of 1)."""
    kind = sniff(payload)
    if kind in ("npy", "npz"):
        return _decode_npy(payload)
    if kind in _IMAGE_KINDS:
        if modality not in ("image", "x-ray", "infrared", "video"):
            raise ValueError(f"{kind} payload for modality {modality!r}")
        if modality == "video":
            if kind == "gif":  # animated GIF -> sampled-frame clip
                return _decode_gif_clip(payload, num_frames, img_size)
            # single still -> repeated-frame clip
            img = _decode_image_bytes(payload, img_size, 3)
            return np.repeat(img[:, None], num_frames, axis=1)
        channels = 1 if modality == "infrared" else 3
        return _decode_image_bytes(payload, img_size, channels)
    if kind in _VIDEO_KINDS:
        if modality != "video":
            raise ValueError(f"{kind} payload for modality {modality!r}")
        return _decode_video_bytes(
            payload, num_frames, img_size, suffix=_VIDEO_KINDS[kind]
        )
    if kind == "wav":
        if modality != "audio":
            raise ValueError(f"wav payload for modality {modality!r}")
        return _decode_wav_bytes(payload, audio_frames, mel_bins)
    # utf8
    if modality != "text":
        raise ValueError(
            f"cannot sniff a container for modality {modality!r}; send npy/"
            "npz tensor payloads for tensor modalities"
        )
    return _decode_text_bytes(payload, text_context, bpe=bpe)


def encode_npy(arr: np.ndarray) -> bytes:
    """Client-side helper: UNBATCHED array -> npy wire bytes."""
    bio = io.BytesIO()
    np.save(bio, arr)
    return bio.getvalue()


def encode_npz(arrays: Dict[str, np.ndarray]) -> bytes:
    """Client-side helper: dict of UNBATCHED arrays -> npz wire bytes
    (graph requests: node/edge data + ids)."""
    bio = io.BytesIO()
    np.savez(bio, **arrays)
    return bio.getvalue()
