"""The device an entry point runs on when the caller names none.

The port runs on the card: constructors and loaders take ``device=None`` and
resolve it here to the CUDA device, and raise where there is none. Nothing
falls back to the CPU; a caller that wants the CPU (the tests do) passes
``device="cpu"``. Importing a module never calls this.
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


def resolve(device: Device = None) -> torch.device:
    """``device`` as a torch.device; None means :func:`default_device`."""
    return default_device() if device is None else torch.device(device)
