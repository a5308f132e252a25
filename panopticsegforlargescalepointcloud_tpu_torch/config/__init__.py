from .loader import ConfigError, load_config
from .schema import panoptic_config_from_yaml

__all__ = ["ConfigError", "load_config", "panoptic_config_from_yaml"]
