from metatransformer_tpu_torch.ops import fused_block  # noqa: F401
