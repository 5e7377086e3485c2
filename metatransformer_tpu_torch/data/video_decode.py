"""Video-container decode: AVI (RIFF) -> ``[T, H, W, 3]`` uint8 frames.

Port of ``metatransformer_tpu/data/video_decode.py``: the same numpy
code, kept as the port's own copy. PIL (MJPEG frames) and cv2 (other
containers) are imported where a file needs them, and a missing one
raises; nothing substitutes for it.

The reference ingests video containers through decord
(``Video/dataset/datasets.py:1-60``: ``decord.VideoReader`` over .mp4 /
.avi / .webm Kinetics files). decord/ffmpeg are not in this image, so
this module implements the container layer natively for the two formats
that need no entropy-codec beyond what PIL already ships:

* **MJPEG-in-AVI** (fourcc ``MJPG``): every ``00dc`` chunk is a complete
  baseline-JPEG image; PIL's C decoder handles the codec, this module
  handles the RIFF container walk. MJPEG is the standard
  capture/intermediate format (OpenCV ``VideoWriter`` default on many
  platforms, ffmpeg ``-c:v mjpeg``) so real files exist in the wild.
* **Uncompressed DIB AVI** (biCompression=0): raw bottom-up BGR rows,
  4-byte aligned — the lossless interchange path.

Split of labor matches the image pipeline (``data/image_folder.py``):
container walk + codec on HOST (integer C code), every float op
(scaling, normalize, mixup) on DEVICE. ``write_mjpeg_avi`` /
``write_dib_avi`` produce spec-conformant files for fixtures and for
exporting `.npy` clips into a playable format.

Entropy codecs beyond JPEG (H.264/HEVC/VP9/MPEG-4 in .mp4/.mkv/.mov/
.webm containers, or compressed-fourcc AVIs) decode through OpenCV's
FFmpeg backend when ``cv2`` is importable (``read_video_cv2``). The
top-level ``read_video`` / ``count_video_frames`` dispatch: native RIFF
walk for MJPEG/DIB AVIs (no dependency), cv2 for everything else —
together they cover decord's container surface
(``Video/dataset/datasets.py:1-60``). Without cv2 the boundary is the
documented transcode-to-MJPEG path in PARITY.md.
"""

from __future__ import annotations

import io
import os
import struct
from typing import Iterator, List, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# RIFF walking
# ---------------------------------------------------------------------------


def _pil_image():
    """PIL's ``Image`` module, or an ImportError naming Pillow (MJPEG
    frames are JPEG images)."""
    try:
        from PIL import Image
    except ImportError as exc:
        raise ImportError(
            "MJPEG frames decode and encode through Pillow (PIL), which is not importable"
        ) from exc
    return Image


def _walk_chunks(buf: memoryview, start: int, end: int) -> Iterator[
    Tuple[bytes, int, int]
]:
    """Yield (fourcc, payload_start, payload_size) for chunks in
    [start, end). LIST/RIFF payloads include their 4-byte form type."""
    pos = start
    while pos + 8 <= end:
        fourcc = bytes(buf[pos : pos + 4])
        (size,) = struct.unpack_from("<I", buf, pos + 4)
        payload = pos + 8
        if payload + size > end:  # truncated file: stop at what we have
            size = max(0, end - payload)
        yield fourcc, payload, size
        pos = payload + size + (size & 1)  # chunks are word-aligned


class AviInfo:
    """Parsed stream-0 video metadata."""

    def __init__(self) -> None:
        self.handler = b"\x00\x00\x00\x00"  # strh fccHandler
        self.compression = 0  # strf biCompression
        self.width = 0
        self.height = 0
        self.bit_count = 24
        self.fps = 0.0
        self.num_frames = 0


def _parse_headers(buf: memoryview, hdrl_start: int, hdrl_end: int) -> AviInfo:
    info = AviInfo()
    stream_index = -1
    for fourcc, p, sz in _walk_chunks(buf, hdrl_start, hdrl_end):
        if fourcc == b"LIST" and bytes(buf[p : p + 4]) == b"strl":
            stream_index += 1
            if stream_index > 0:
                continue  # only the first (video) stream matters here
            for f2, p2, sz2 in _walk_chunks(buf, p + 4, p + sz):
                if f2 == b"strh" and sz2 >= 32:
                    fcc_type = bytes(buf[p2 : p2 + 4])
                    if fcc_type != b"vids":
                        stream_index -= 1  # not video; keep looking
                        break
                    info.handler = bytes(buf[p2 + 4 : p2 + 8])
                    scale, rate = struct.unpack_from("<II", buf, p2 + 20)
                    if scale:
                        info.fps = rate / scale
                elif f2 == b"strf" and sz2 >= 40:
                    (_, w, h, _, bits, comp) = struct.unpack_from(
                        "<IiiHHI", buf, p2
                    )
                    info.width, info.bit_count = w, bits
                    info.height = abs(h)  # negative = top-down DIB
                    info.compression = comp
        elif fourcc == b"avih" and sz >= 56:
            (info.num_frames,) = struct.unpack_from("<I", buf, p + 16)
    return info


def _collect_frames(buf: memoryview, movi_start: int, movi_end: int) -> List[
    Tuple[int, int]
]:
    """(payload_start, size) of every stream-0 video chunk, in file
    order. ``00dc`` = compressed, ``00db`` = uncompressed DIB; rec LISTs
    (interleave groups) are recursed into."""
    frames: List[Tuple[int, int]] = []
    for fourcc, p, sz in _walk_chunks(buf, movi_start, movi_end):
        if fourcc == b"LIST" and bytes(buf[p : p + 4]) == b"rec ":
            frames.extend(_collect_frames(buf, p + 4, p + sz))
        elif fourcc in (b"00dc", b"00db") and sz > 0:
            frames.append((p, sz))
    return frames


def _decode_dib(
    raw: bytes, width: int, height: int, bit_count: int, top_down: bool
) -> np.ndarray:
    """Uncompressed DIB frame -> [H, W, 3] uint8 RGB. Rows are BGR(A),
    4-byte aligned, bottom-up unless biHeight was negative."""
    channels = bit_count // 8
    stride = (width * channels + 3) & ~3
    rows = np.frombuffer(raw[: stride * height], np.uint8).reshape(
        height, stride
    )
    pix = rows[:, : width * channels].reshape(height, width, channels)
    if not top_down:
        pix = pix[::-1]
    return np.ascontiguousarray(pix[..., 2::-1])  # BGR(A) -> RGB


def read_avi(
    path: str,
    frame_indices: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Decode an AVI file to ``[T, H, W, 3]`` uint8 RGB.

    ``frame_indices`` (sorted or not, duplicates fine) decodes only the
    requested frames — the segment-sampling path never pays for frames
    it drops, mirroring decord's ``get_batch(indices)``.
    """
    with open(path, "rb") as f:
        data = f.read()
    buf = memoryview(data)
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError(f"{path}: not a RIFF/AVI file")
    (riff_size,) = struct.unpack_from("<I", buf, 4)
    end = min(len(data), 8 + riff_size)

    info: Optional[AviInfo] = None
    frames: List[Tuple[int, int]] = []
    for fourcc, p, sz in _walk_chunks(buf, 12, end):
        if fourcc != b"LIST":
            continue
        form = bytes(buf[p : p + 4])
        if form == b"hdrl":
            info = _parse_headers(buf, p + 4, p + sz)
        elif form == b"movi":
            frames.extend(_collect_frames(buf, p + 4, p + sz))
    if info is None or not frames:
        raise ValueError(f"{path}: no video stream found")

    if frame_indices is None:
        wanted = range(len(frames))
    else:
        wanted = [int(i) for i in np.clip(frame_indices, 0, len(frames) - 1)]

    is_mjpeg = info.handler.upper() in (b"MJPG", b"JPEG") or (
        info.compression in (0x47504A4D, 0x4745504A)  # 'MJPG' / 'JPEG'
    )
    decoded = {}
    out: List[np.ndarray] = []
    for i in wanted:
        if i in decoded:  # duplicate index (short clips): decode once
            out.append(decoded[i])
            continue
        p, sz = frames[i]
        raw = bytes(buf[p : p + sz])
        if is_mjpeg or raw[:2] == b"\xff\xd8":
            Image = _pil_image()
            img = Image.open(io.BytesIO(raw))
            frame = np.asarray(img.convert("RGB"), np.uint8)
        elif info.compression == 0:
            frame = _decode_dib(
                raw, info.width, info.height, info.bit_count, top_down=False
            )
        else:
            cc = info.handler.decode("latin1")
            raise NotImplementedError(
                f"{path}: codec {cc!r}/0x{info.compression:08x} needs an "
                "entropy decoder not in this image; transcode to MJPEG "
                "(`ffmpeg -c:v mjpeg`) or frame arrays first"
            )
        decoded[i] = frame
        out.append(frame)
    return np.stack(out)


def probe_avi(path: str) -> AviInfo:
    """Header-only parse (no frame decode): width/height/fps/frame count
    — the ``decord.VideoReader`` metadata surface."""
    with open(path, "rb") as f:
        data = f.read(64 * 1024)
    buf = memoryview(data)
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError(f"{path}: not a RIFF/AVI file")
    for fourcc, p, sz in _walk_chunks(buf, 12, len(data)):
        if fourcc == b"LIST" and bytes(buf[p : p + 4]) == b"hdrl":
            return _parse_headers(buf, p + 4, p + sz)
    raise ValueError(f"{path}: no hdrl list in first 64 KiB")


def count_frames(path: str) -> int:
    """Total stream-0 frames (full movi walk, no decode)."""
    with open(path, "rb") as f:
        data = f.read()
    buf = memoryview(data)
    (riff_size,) = struct.unpack_from("<I", buf, 4)
    end = min(len(data), 8 + riff_size)
    n = 0
    for fourcc, p, sz in _walk_chunks(buf, 12, end):
        if fourcc == b"LIST" and bytes(buf[p : p + 4]) == b"movi":
            n += len(_collect_frames(buf, p + 4, p + sz))
    return n


# ---------------------------------------------------------------------------
# cv2/FFmpeg path: mp4/mkv/mov/webm containers, non-JPEG entropy codecs
# ---------------------------------------------------------------------------

#: extensions whose containers need the FFmpeg demuxer (vs the native
#: RIFF walk above). Checked case-insensitively by ``read_video``.
CV2_CONTAINER_EXTS = (".mp4", ".m4v", ".mkv", ".mov", ".webm", ".mpg", ".mpeg")


def _cv2():
    try:
        import cv2  # opencv ships in this image with the FFMPEG backend

        return cv2
    except ImportError:
        return None


def has_cv2() -> bool:
    """True when the OpenCV/FFmpeg decode path is available."""
    return _cv2() is not None


def read_video_cv2(
    path: str, frame_indices: Optional[np.ndarray] = None
) -> np.ndarray:
    """Decode any FFmpeg-supported container/codec (H.264, HEVC, VP9,
    MPEG-4, compressed-fourcc AVI, ...) to ``[T, H, W, 3]`` uint8 RGB.

    Sampled-index semantics match ``read_avi`` / decord ``get_batch``:
    unsorted + duplicate indices fine, each frame decoded once. Frames
    are walked sequentially with ``grab()`` (cheap: demux + reference
    update only) and ``retrieve()``d only at wanted indices —
    ``CAP_PROP_POS_FRAMES`` seeking is unreliable on inter-coded
    streams, sequential grab is exact on every codec.
    """
    cv2 = _cv2()
    if cv2 is None:
        raise RuntimeError(
            f"{path}: decoding this container needs OpenCV (cv2) with the "
            "FFmpeg backend, which is not importable in this environment; "
            "transcode to MJPEG AVI (`ffmpeg -c:v mjpeg`) or frame arrays"
        )
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise ValueError(f"{path}: cv2.VideoCapture could not open file")
    try:
        if frame_indices is None:
            frames: List[np.ndarray] = []
            while True:
                ok, bgr = cap.read()
                if not ok:
                    break
                frames.append(np.ascontiguousarray(bgr[..., ::-1]))
            if not frames:
                raise ValueError(f"{path}: no decodable video frames")
            return np.stack(frames)

        wanted = [max(int(i), 0) for i in np.asarray(frame_indices).ravel()]
        need = set(wanted)
        decoded = {}
        for pos in range(max(need) + 1):
            if pos in need:
                ok, bgr = cap.read()
                if not ok:
                    break  # stream shorter than the header claimed
                decoded[pos] = np.ascontiguousarray(bgr[..., ::-1])
            elif not cap.grab():  # cheap skip: demux only, no pixel decode
                break
        if not decoded:
            raise ValueError(f"{path}: no decodable video frames")
        last = decoded[max(decoded)]
        # clamp past-the-end requests to the last decodable frame (header
        # frame counts overshoot on some muxers)
        return np.stack([decoded.get(i, last) for i in wanted])
    finally:
        cap.release()


def count_frames_cv2(path: str) -> int:
    """Stream frame count via container metadata; falls back to a grab
    walk when the demuxer reports none (raw/elementary streams)."""
    cv2 = _cv2()
    if cv2 is None:
        raise RuntimeError(f"{path}: frame counting needs cv2 (not importable)")
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise ValueError(f"{path}: cv2.VideoCapture could not open file")
    try:
        n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        if n > 0:
            return n
        n = 0
        while cap.grab():
            n += 1
        return n
    finally:
        cap.release()


def _is_avi(path: str) -> bool:
    with open(path, "rb") as f:
        head = f.read(12)
    return head[:4] == b"RIFF" and head[8:12] == b"AVI "


def read_video(
    path: str, frame_indices: Optional[np.ndarray] = None
) -> np.ndarray:
    """Container-agnostic decode to ``[T, H, W, 3]`` uint8 RGB — the
    decord ``VideoReader(...).get_batch(indices)`` surface. MJPEG/DIB
    AVIs take the dependency-free native walk; everything else (and
    compressed-fourcc AVIs) goes through cv2/FFmpeg."""
    if _is_avi(path):
        try:
            return read_avi(path, frame_indices)
        except NotImplementedError:
            if not has_cv2():
                raise
            return read_video_cv2(path, frame_indices)
    return read_video_cv2(path, frame_indices)


def count_video_frames(path: str) -> int:
    """Container-agnostic total-frame count (no full decode)."""
    if _is_avi(path):
        return count_frames(path)
    return count_frames_cv2(path)


# ---------------------------------------------------------------------------
# Writers (fixtures + .npy-clip export)
# ---------------------------------------------------------------------------


def _avi_container(
    frame_chunks: List[bytes],
    width: int,
    height: int,
    fps: float,
    handler: bytes,
    compression: int,
    chunk_id: bytes,
) -> bytes:
    n = len(frame_chunks)
    max_sz = max(len(c) for c in frame_chunks)
    usec_per_frame = int(round(1_000_000 / fps))

    avih = struct.pack(
        "<14I", usec_per_frame, max_sz * int(fps), 0, 0x10, n, 0, 1,
        max_sz, width, height, 0, 0, 0, 0,
    )
    strh = (
        b"vids" + handler
        + struct.pack("<IHHIIIIIIII", 0, 0, 0, 0, 1, int(round(fps)), 0,
                      n, max_sz, 0xFFFFFFFF, 0)
        + struct.pack("<4H", 0, 0, width, height)
    )
    strf = struct.pack(
        "<IiiHHIIiiII", 40, width, height, 1, 24, compression,
        width * height * 3, 0, 0, 0, 0,
    )

    def chunk(fourcc: bytes, payload: bytes) -> bytes:
        pad = b"\x00" if len(payload) & 1 else b""
        return fourcc + struct.pack("<I", len(payload)) + payload + pad

    def lst(form: bytes, payload: bytes) -> bytes:
        return chunk(b"LIST", form + payload)

    strl = lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf))
    hdrl = lst(b"hdrl", chunk(b"avih", avih) + strl)
    movi_payload = b"".join(chunk(chunk_id, c) for c in frame_chunks)
    movi = lst(b"movi", movi_payload)

    # idx1: offsets are relative to the start of the movi LIST's 'movi'
    # form tag (the convention every player accepts)
    idx_entries = []
    off = 4
    for c in frame_chunks:
        idx_entries.append(
            chunk_id + struct.pack("<III", 0x10, off, len(c))
        )
        off += 8 + len(c) + (len(c) & 1)
    idx1 = chunk(b"idx1", b"".join(idx_entries))

    body = b"AVI " + hdrl + movi + idx1
    return b"RIFF" + struct.pack("<I", len(body)) + body


def write_mjpeg_avi(
    frames: np.ndarray, path: str, fps: float = 25.0, quality: int = 90
) -> None:
    """[T, H, W, 3] uint8 -> MJPEG AVI file (PIL JPEG per frame)."""
    Image = _pil_image()

    t, h, w, _ = frames.shape
    chunks = []
    for fr in frames:
        bio = io.BytesIO()
        Image.fromarray(fr).save(bio, "JPEG", quality=quality)
        chunks.append(bio.getvalue())
    data = _avi_container(
        chunks, w, h, fps, b"MJPG", 0x47504A4D, b"00dc"
    )
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def write_dib_avi(frames: np.ndarray, path: str, fps: float = 25.0) -> None:
    """[T, H, W, 3] uint8 -> uncompressed (lossless) DIB AVI."""
    t, h, w, _ = frames.shape
    stride = (w * 3 + 3) & ~3
    chunks = []
    for fr in frames:
        bgr = fr[::-1, :, ::-1]  # bottom-up, RGB->BGR
        row = np.zeros((h, stride), np.uint8)
        row[:, : w * 3] = bgr.reshape(h, w * 3)
        chunks.append(row.tobytes())
    data = _avi_container(chunks, w, h, fps, b"DIB ", 0, b"00db")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)
