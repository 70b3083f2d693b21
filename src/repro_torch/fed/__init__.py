from repro_torch.fed.client import (client_params, evaluate, join_adapters,
                                    loss_and_grads, make_cohort_train,
                                    make_local_train, split_adapters,
                                    split_head)
from repro_torch.fed.simulation import SimConfig, stack_client_data

__all__ = ["split_adapters", "join_adapters", "split_head", "client_params",
           "loss_and_grads", "make_local_train", "make_cohort_train",
           "evaluate", "SimConfig", "stack_client_data"]
