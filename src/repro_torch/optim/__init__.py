from repro_torch.optim.optimizers import (Optimizer, adamw, apply_updates,
                                          clip_by_global_norm, sgd, tree_map)
from repro_torch.optim.schedules import constant, cosine_decay, linear_warmup

__all__ = ["Optimizer", "adamw", "sgd", "apply_updates",
           "clip_by_global_norm", "tree_map", "constant", "cosine_decay",
           "linear_warmup"]
