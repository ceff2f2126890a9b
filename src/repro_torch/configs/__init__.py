"""Model and serving configs of the port (copies of ``repro.configs``)."""
from repro_torch.configs.base import (ModelConfig, RLConfig, ServeConfig,
                                      get_config, list_archs)

__all__ = ["ModelConfig", "RLConfig", "ServeConfig", "get_config",
           "list_archs"]
