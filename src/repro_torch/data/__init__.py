from repro_torch.data.partition import client_batches, dirichlet_partition
from repro_torch.data.synthetic import TASKS, make_pair_classification

__all__ = ["TASKS", "make_pair_classification", "dirichlet_partition",
           "client_batches"]
