from repro_torch.configs.base import (ARCH_IDS, LoRAConfig, ModelConfig,
                                      canonical, get_config, get_reduced,
                                      list_archs)

__all__ = ["ARCH_IDS", "LoRAConfig", "ModelConfig", "canonical",
           "get_config", "get_reduced", "list_archs"]
