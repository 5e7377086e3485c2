from metatransformer_tpu_torch.models import (  # noqa: F401
    audio_classifier,
    classifier,
    hyper_classifier,
    image_classifier,
    multimodal_classifier,
    tabular_classifier,
    time_series,
    video_classifier,
    video_eval,
    video_pretrain,
)
