"""The device an entry point runs on when the caller names none.

The port runs on the card: constructors and loaders take ``device=None`` and
resolve it here to the CUDA device, and raise where there is none. Nothing
falls back to the CPU; a caller that wants the CPU (the tests do) passes
``device="cpu"``. Importing a module never calls this.

Where it hands out the card it also sets the fp32 policy
(:func:`fp32_policy`): fp32 convolutions and matmuls in full fp32, never
TF32, as the reference asks for ``Precision.HIGHEST``.
"""

from __future__ import annotations

from typing import Union

import torch

Device = Union[torch.device, str, None]


def default_device() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "metatransformer_tpu_torch runs on a CUDA card and found none; "
            'pass device="cpu" to run on the CPU'
        )
    return torch.device("cuda")


def fp32_policy() -> None:
    """Run fp32 products in full fp32 on the card: TF32 off for cuDNN's
    convolutions (PyTorch's default leaves it on) and for cuBLAS's matmuls
    (off by default). Both flags can be set on a build without CUDA."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def resolve(device: Device = None) -> torch.device:
    """``device`` as a torch.device; None means :func:`default_device`. A
    CUDA device comes back with :func:`fp32_policy` set."""
    out = default_device() if device is None else torch.device(device)
    if out.type == "cuda":
        fp32_policy()
    return out
