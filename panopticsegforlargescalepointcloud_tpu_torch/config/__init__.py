from .loader import ConfigError, load_config
from .schema import TrainingConfig, panoptic_config_from_yaml, training_config_from_yaml

__all__ = ["ConfigError", "TrainingConfig", "load_config", "panoptic_config_from_yaml",
           "training_config_from_yaml"]
