"""Modality tokenizers: ``apply(params, raw) -> tokens [B, T, D]``."""

from metatransformer_tpu_torch.tokenizers import image, video  # noqa: F401
