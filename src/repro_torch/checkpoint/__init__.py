from repro_torch.checkpoint.store import (latest_step, load_pytree, restore,
                                          save, save_pytree)

__all__ = ["save", "restore", "save_pytree", "load_pytree", "latest_step"]
