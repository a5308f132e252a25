from .loader import ConfigError, explicit_overrides, load_config
from .schema import (
    TrainingConfig,
    dataset_spec_from_cfg,
    panoptic_config_from_yaml,
    training_config_from_yaml,
)

__all__ = ["ConfigError", "TrainingConfig", "dataset_spec_from_cfg", "explicit_overrides",
           "load_config", "panoptic_config_from_yaml", "training_config_from_yaml"]
