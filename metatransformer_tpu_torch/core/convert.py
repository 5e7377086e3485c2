"""Checkpoint conversion: released PyTorch ``.pth`` encoders -> the stacked
parameter tree of :mod:`metatransformer_tpu_torch.core.encoder`.

Port of ``metatransformer_tpu/core/convert.py`` (the timm encoder layout).
The released checkpoint is a flat state dict of ``nn.Sequential`` of timm
``Block`` with keys like ``0.attn.qkv.weight``; it is loaded strictly.
``.npz`` files are the same as the JAX package's, so both packages can
load one set of weights.

:func:`from_numpy` / :func:`to_numpy` map nested dicts and lists of numpy
arrays to the same tree of tensors and back. They carry the JAX package's
parameter trees (``jax.tree.map(np.asarray, params)``) across unchanged.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from metatransformer_tpu_torch.core import device as _device
from metatransformer_tpu_torch.core import encoder as enc
from metatransformer_tpu_torch.core.tree import tree_map

# timm Block key -> (our leaf name, needs transpose)
_KEY_MAP = {
    "norm1.weight": ("norm1_scale", False),
    "norm1.bias": ("norm1_bias", False),
    "attn.qkv.weight": ("qkv_w", True),
    "attn.qkv.bias": ("qkv_b", False),
    "attn.proj.weight": ("proj_w", True),
    "attn.proj.bias": ("proj_b", False),
    "norm2.weight": ("norm2_scale", False),
    "norm2.bias": ("norm2_bias", False),
    "mlp.fc1.weight": ("fc1_w", True),
    "mlp.fc1.bias": ("fc1_b", False),
    "mlp.fc2.weight": ("fc2_w", True),
    "mlp.fc2.bias": ("fc2_b", False),
}


def convert_state_dict(state: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Convert a flat ``{i}.{submodule}`` torch state dict to a stacked tree.

    Accepts numpy arrays (call :func:`load_torch_checkpoint` for ``.pth``).
    Unknown keys raise: the reference loads ``strict=True`` and so do we.
    """
    per_layer: Dict[int, Dict[str, np.ndarray]] = {}
    for key, value in state.items():
        m = re.match(r"^(\d+)\.(.+)$", key)
        if not m:
            raise ValueError(f"unexpected checkpoint key: {key!r}")
        idx, sub = int(m.group(1)), m.group(2)
        if sub not in _KEY_MAP:
            # ls1/ls2 (LayerScale) and q_norm/k_norm are Identity in the
            # released checkpoints; anything else is a real mismatch.
            raise ValueError(f"unexpected submodule key: {key!r}")
        name, transpose = _KEY_MAP[sub]
        arr = np.asarray(value, dtype=np.float32)
        if transpose:
            arr = arr.T  # torch Linear stores [out, in]; we use [in, out]
        per_layer.setdefault(idx, {})[name] = arr

    depth = len(per_layer)
    if sorted(per_layer) != list(range(depth)):
        raise ValueError(f"non-contiguous layer indices: {sorted(per_layer)}")
    return {
        name: np.stack([per_layer[i][name] for i in range(depth)])
        for name, _ in _KEY_MAP.values()
    }


def infer_config(params: Mapping[str, Any]) -> enc.EncoderConfig:
    depth, dim = params["norm1_scale"].shape
    if (depth, dim) == (12, 768):
        return enc.BASE
    if (depth, dim) == (24, 1024):
        return enc.LARGE
    # Fall back: num_heads follows the released family rule (dim/64).
    return enc.EncoderConfig(dim=dim, depth=depth, num_heads=dim // 64)


def from_numpy(tree: Any, device: _device.Device = None, requires_grad: bool = False) -> Any:
    """Nested dicts and lists of numpy arrays -> the same tree of tensors
    (copies) on ``device`` (None: the card). With ``requires_grad`` every
    floating leaf is a leaf tensor that takes a gradient, as a trainable
    tree must be."""
    device = _device.resolve(device)

    def leaf(a):
        t = torch.tensor(np.asarray(a), device=device)
        return t.requires_grad_(True) if requires_grad and t.is_floating_point() else t

    return tree_map(leaf, tree)


def to_numpy(tree: Any) -> Any:
    """Inverse of :func:`from_numpy`: copies, never views of the tensors
    (a CPU tensor's ``numpy()`` would share its memory). bf16 leaves widen
    (exactly) to fp32, which numpy can hold."""

    def leaf(t):
        t = t.detach().to("cpu", copy=True)
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return tree_map(leaf, tree)


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """Load a ``.pth`` encoder state dict into numpy."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(state, "state_dict"):
        state = state.state_dict()
    if "state_dict" in state and isinstance(state["state_dict"], dict):
        state = state["state_dict"]
    return {k: v.detach().numpy() for k, v in state.items()}


def convert_pth(path: str, device: _device.Device = None):
    """``.pth`` -> (stacked params on ``device``, config)."""
    np_params = convert_state_dict(load_torch_checkpoint(path))
    return from_numpy(np_params, device), infer_config(np_params)


def save_npz(path: str, params: Mapping[str, Any]) -> None:
    np.savez(path, **{k: np.asarray(v) for k, v in to_numpy(dict(params)).items()})


def load_npz(path: str, device: _device.Device = None):
    with np.load(path) as data:
        np_params = {k: data[k] for k in data.files}
    return from_numpy(np_params, device), infer_config(np_params)


def main(argv=None) -> None:
    """CLI: ``python -m metatransformer_tpu_torch.core.convert in.pth out.npz``."""
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("pth_in")
    p.add_argument("npz_out")
    args = p.parse_args(argv)
    params, cfg = convert_pth(args.pth_in, device="cpu")  # a file-to-file tool
    save_npz(args.npz_out, params)
    print(f"converted {args.pth_in} -> {args.npz_out}  ({cfg})")


if __name__ == "__main__":
    main()
