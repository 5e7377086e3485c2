"""Hand-written kernels of the port, each beside its plain PyTorch version."""

from metatransformer_tpu_torch.ops import flash_attention, fused_block  # noqa: F401


def launch_counts() -> dict:
    """Kernel launches since the last reset, over every kernel of the package."""
    return {**fused_block.launch_counts(), **flash_attention.launch_counts()}


def reset_launch_counts() -> None:
    fused_block.reset_launch_counts()
    flash_attention.reset_launch_counts()
