from metatransformer_tpu_torch.core import convert, encoder  # noqa: F401
from metatransformer_tpu_torch.core.encoder import (  # noqa: F401
    BASE,
    BF16,
    FP32,
    GRAPH_BASE,
    LARGE,
    EncoderConfig,
    Precision,
    encode,
)
