from repro_torch.configs.base import VOCAB_ALIGN, ModelConfig, ServingConfig, pad_to, reduced
from repro_torch.configs.registry import ARCHS, ASSIGNED, get_config

__all__ = ["ARCHS", "ASSIGNED", "ModelConfig", "ServingConfig", "VOCAB_ALIGN", "get_config",
           "pad_to", "reduced"]
