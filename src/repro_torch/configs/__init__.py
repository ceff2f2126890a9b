"""Model and serving configs of the port (copies of ``repro.configs``)."""
from repro_torch.configs.base import (ArchNotPortedError, ModelConfig,
                                      ServeConfig, get_config, list_archs)

__all__ = ["ArchNotPortedError", "ModelConfig", "ServeConfig", "get_config",
           "list_archs"]
