from metatransformer_tpu_torch.models import (  # noqa: F401
    classifier,
    image_classifier,
    video_classifier,
    video_eval,
    video_pretrain,
)
