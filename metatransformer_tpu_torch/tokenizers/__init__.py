"""Modality tokenizers: ``apply(params, raw) -> tokens [B, T, D]``."""

from metatransformer_tpu_torch.tokenizers import (  # noqa: F401
    audio,
    bpe,
    graph,
    hyper,
    image,
    tabular,
    text,
    time_series,
    video,
)
