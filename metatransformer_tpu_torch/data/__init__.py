"""Host data modules (numpy): graph collation, the serving-edge payload
codecs, video container decode, the video dataset helpers and RandAugment.
Port of ``metatransformer_tpu/data/``; the port keeps its own copies."""

from metatransformer_tpu_torch.data import graph_collate  # noqa: F401
