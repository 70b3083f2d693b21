from repro_torch.data.partition import (LazyDirichlet, client_batches,
                                       dirichlet_partition, iid_partition)
from repro_torch.data.synthetic import (TASKS, bigram_nll, make_bigram_lm,
                                        make_pair_classification)

__all__ = ["TASKS", "make_pair_classification", "make_bigram_lm",
           "bigram_nll", "dirichlet_partition", "LazyDirichlet",
           "iid_partition", "client_batches"]
