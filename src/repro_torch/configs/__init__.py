from repro_torch.configs.base import (
    VOCAB_ALIGN,
    AsyncPipelineConfig,
    DataCoordinatorConfig,
    DistributedConfig,
    EnvConfig,
    ModelConfig,
    ObsConfig,
    RolloutEngineConfig,
    ServingConfig,
    ShapeConfig,
    SHAPES_BY_NAME,
    pad_to,
    reduced,
)
from repro_torch.configs.registry import ARCHS, ASSIGNED, get_config

__all__ = ["ARCHS", "ASSIGNED", "AsyncPipelineConfig", "DataCoordinatorConfig",
           "DistributedConfig", "EnvConfig", "ModelConfig", "ObsConfig",
           "RolloutEngineConfig", "SHAPES_BY_NAME", "ServingConfig", "ShapeConfig",
           "VOCAB_ALIGN", "get_config", "pad_to", "reduced"]
