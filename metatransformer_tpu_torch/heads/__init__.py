from metatransformer_tpu_torch.heads import cls  # noqa: F401
