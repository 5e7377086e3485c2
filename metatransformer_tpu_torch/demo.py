"""Inference demo CLI: raw modality input -> tokens -> shared encoder ->
pooled features (and logits with an optional head).

Port of ``metatransformer_tpu/demo.py``. One CLI covers every modality of
the ``pipeline.Data2Seq`` dispatcher and runs the tokenize -> encode path
the reference README documents (``README.md:113-150``), at the reference's
default precision (FP32, the encoder's default).

Usage:
  python -m metatransformer_tpu_torch.demo --modality image --synthetic
  python -m metatransformer_tpu_torch.demo --modality audio --input mel.npy \\
      --ckpt encoder.npz --head head.npz --top-k 5
  python -m metatransformer_tpu_torch.demo --modality image --synthetic --device cpu

``--input`` takes a ``.npy`` (or ``.npz`` with arrays matching the
tokenizer's inputs, e.g. graph batch dicts), or an encoded media file —
``.jpg/.png/.bmp/.webp/.gif/.tiff`` (image/x-ray/infrared), ``.avi`` or
animated ``.gif`` (video), ``.wav`` (audio) — decoded by the serving-edge
codecs (``data/codecs.py``); ``--synthetic`` generates a correctly-shaped
random input instead. Without ``--ckpt`` the encoder is randomly
initialized (path demo only, not meaningful predictions). ``--device``
defaults to the card and raises without one. The reference's
``--compile-cache`` (XLA's persistent executable cache) has no counterpart:
the port compiles no programs.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from metatransformer_tpu_torch import pipeline
from metatransformer_tpu_torch.core import device as _device
from metatransformer_tpu_torch.core import encoder as enc


def synthetic_input(modality: str, rng: np.random.Generator):
    """A correctly-shaped random raw input per modality."""
    if modality in ("image", "infrared", "x-ray"):
        return rng.uniform(0, 1, (1, 224, 224, 3)).astype(np.float32)
    if modality == "video":
        return rng.uniform(0, 1, (1, 16, 224, 224, 3)).astype(np.float32)
    if modality == "audio":
        return rng.normal(0, 1, (1, 1024, 128)).astype(np.float32)  # log-mel
    if modality in ("time-series", "imu"):
        return rng.normal(0, 1, (1, 96, 7)).astype(np.float32)
    if modality == "hyper":
        return rng.normal(0, 1, (1, 200, 49)).astype(np.float32)
    if modality == "point":
        return rng.normal(0, 0.5, (1, 1024, 3)).astype(np.float32)
    if modality == "tabular":
        return rng.integers(0, 8, (1, 14)).astype(np.int32)
    if modality == "text":
        ids = np.zeros((1, 77), np.int32)
        ids[0, :5] = [49406, 320, 1125, 539, 49407]  # CLIP-style BOS .. EOS
        return ids
    if modality == "graph":
        n, e = 9, 12
        return {
            "node_data": rng.integers(0, 16, (1, n, 9)).astype(np.int32),
            "edge_data": rng.integers(0, 4, (1, e, 3)).astype(np.int32),
            "edge_index": rng.integers(0, n, (1, e, 2)).astype(np.int32),
            "node_num": np.asarray([n], np.int32),
            "edge_num": np.asarray([e], np.int32),
            "lap_eigvec": rng.normal(0, 1, (1, n, 16)).astype(np.float32),
        }
    raise ValueError(f"no synthetic generator for modality {modality!r}")


_MEDIA_EXTS = (
    ".jpg", ".jpeg", ".png", ".bmp", ".webp", ".gif", ".tif", ".tiff",
    ".avi", ".mp4", ".m4v", ".mov", ".mkv", ".webm", ".wav",
)


def load_input(path: str, modality: Optional[str] = None):
    """.npy/.npz tensors, or (with ``modality``) encoded media files —
    JPEG/PNG/AVI/WAV route through the serving-edge codecs
    (``data/codecs.decode_payload``), the same bytes-in path as
    ``ServingDaemon.submit``."""
    if modality is not None and path.lower().endswith(_MEDIA_EXTS):
        from metatransformer_tpu_torch.data import codecs

        with open(path, "rb") as f:
            return codecs.decode_payload(modality, f.read())
    if path.endswith(".npz"):
        with np.load(path) as data:
            return {k: data[k] for k in data.files}
    return np.load(path)


def tokenize_text(texts, merges_path=None):
    """Raw strings -> [B, 77] CLIP ids via the clean-room byte-level BPE
    (tokenizers/bpe.py; Data2Seq/Text.py:9's clip.tokenize step). Without
    a merges file the byte-level fallback vocab is used."""
    from metatransformer_tpu_torch.tokenizers import bpe

    tok = bpe.CLIPBPE.from_file(merges_path) if merges_path else bpe.CLIPBPE()
    return tok.tokenize(texts)


def _load_encoder(
    ckpt: Optional[str], generator: torch.Generator, device: torch.device
) -> Tuple[Dict[str, torch.Tensor], enc.EncoderConfig]:
    if ckpt:
        from metatransformer_tpu_torch.core import convert

        if ckpt.endswith(".pth"):
            return convert.convert_pth(ckpt, device)
        return convert.load_npz(ckpt, device)
    cfg = enc.BASE
    return enc.init(cfg, generator, device), cfg


def _on(raw, device: torch.device):
    if isinstance(raw, dict):
        return {k: torch.as_tensor(v, device=device) for k, v in raw.items()}
    return torch.as_tensor(np.array(raw), device=device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--modality", required=True, choices=sorted(pipeline.MODALITIES))
    p.add_argument("--input", default=None,
                   help=".npy/.npz raw input (.txt for --modality text)")
    p.add_argument("--text", default=None,
                   help="raw string input (text modality): tokenized "
                        "host-side by the clean-room CLIP BPE")
    p.add_argument("--bpe-merges", default=None,
                   help="BPE merges file (plain or .gz); omitted -> "
                        "byte-level fallback vocab")
    p.add_argument("--synthetic", action="store_true",
                   help="generate a correctly-shaped random input")
    p.add_argument("--ckpt", default=None,
                   help="converted encoder .npz (or released .pth)")
    p.add_argument("--head", default=None,
                   help=".npz classifier head with arrays w [D, n] (+ b)")
    p.add_argument("--top-k", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: the CUDA card; raises without one)")
    args = p.parse_args(argv)

    if not args.input and not args.synthetic and args.text is None:
        p.error("one of --input / --text / --synthetic is required")
    device = _device.resolve(args.device)
    if args.text is not None or (args.input or "").endswith(".txt"):
        if args.modality != "text":
            p.error("--text / .txt input requires --modality text")
        if args.text is not None:
            texts = [args.text]
        else:
            with open(args.input) as f:
                texts = [ln for ln in f.read().splitlines() if ln.strip()]
        raw = tokenize_text(texts, args.bpe_merges)
    elif args.input:
        raw = load_input(args.input, modality=args.modality)
    else:
        raw = synthetic_input(args.modality, np.random.default_rng(args.seed))

    g_tok = torch.Generator().manual_seed(args.seed)
    g_enc = torch.Generator().manual_seed(args.seed + 1)
    # configs whose shape parameters come from the data itself
    config = None
    if args.modality == "tabular":
        from metatransformer_tpu_torch.tokenizers import tabular as tab_tok

        config = tab_tok.TabularTokenizerConfig(
            vocab_sizes=tuple(int(c) + 1 for c in np.asarray(raw).max(axis=0))
        )
    elif args.modality in ("time-series", "imu"):
        from metatransformer_tpu_torch.tokenizers import time_series as ts_tok

        config = ts_tok.TimeSeriesConfig(c_in=int(np.asarray(raw).shape[-1]))
    elif args.modality == "hyper":
        from metatransformer_tpu_torch.tokenizers import hyper as hyper_tok

        config = hyper_tok.HyperTokenizerConfig(
            img_size=1, near_band=int(np.asarray(raw).shape[-1]),
            num_tokens=int(np.asarray(raw).shape[1]),
        )
    facade = pipeline.Data2Seq(args.modality, config=config)
    tok_params = facade.init(g_tok, device)
    enc_params, cfg = _load_encoder(args.ckpt, g_enc, device)

    t0 = time.perf_counter()
    with torch.no_grad():
        tokens = facade(tok_params, _on(raw, device))
        feats = enc.encode(enc_params, tokens, cfg)
        pooled = feats.mean(dim=1).cpu()
    dt = time.perf_counter() - t0

    print(f"modality={args.modality} device={device} "
          f"tokens={tuple(tokens.shape)} features={tuple(feats.shape)} "
          f"first-call {dt*1e3:.1f} ms")
    v = pooled[0].numpy()
    print(f"pooled[0:8] = {np.array2string(v[:8], precision=4)}  "
          f"|pooled| = {np.linalg.norm(v):.4f}")

    if args.head:
        with np.load(args.head) as h:
            w = torch.as_tensor(h["w"], dtype=torch.float32)
            b = torch.as_tensor(h["b"], dtype=torch.float32) if "b" in h.files else 0.0
        logits = (pooled @ w + b)[0].numpy()
        top = np.argsort(-logits)[: args.top_k]
        print("top-k:", ", ".join(f"class {i}: {logits[i]:.4f}" for i in top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
