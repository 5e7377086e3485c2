"""Hand-written kernels of the port, each beside its plain PyTorch version."""

from metatransformer_tpu_torch.ops import flash_attention, fused_block, point_ops  # noqa: F401

_KERNEL_MODULES = (fused_block, flash_attention, point_ops)


def launch_counts() -> dict:
    """Kernel launches since the last reset, over every kernel of the package."""
    counts = {}
    for module in _KERNEL_MODULES:
        counts.update(module.launch_counts())
    return counts


def reset_launch_counts() -> None:
    for module in _KERNEL_MODULES:
        module.reset_launch_counts()
