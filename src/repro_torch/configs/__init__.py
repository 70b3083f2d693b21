from repro_torch.configs.base import (LoRAConfig, ModelConfig, get_config,
                                      get_reduced)

__all__ = ["LoRAConfig", "ModelConfig", "get_config", "get_reduced"]
