from metatransformer_tpu_torch.configs.config import CONFIG_DIR, Config, load_config  # noqa: F401
