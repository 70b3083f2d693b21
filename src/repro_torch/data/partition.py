"""Non-IID federated partitioning (Dirichlet over labels, Hsu et al. 2019)
and per-client minibatch sampling: a numpy-only copy of the eager parts of
``repro/data/partition.py``, drawing from the same generator streams."""
from __future__ import annotations

from typing import List

import numpy as np


def dirichlet_partition(
    labels: np.ndarray, num_clients: int, alpha: float = 0.5, seed: int = 0,
    min_size: int = 2,
) -> List[np.ndarray]:
    """Returns per-client sorted index arrays. Smaller alpha = more skew."""
    rng = np.random.default_rng(seed)
    classes = np.unique(labels)
    while True:
        idx_per_client: List[List[int]] = [[] for _ in range(num_clients)]
        for c in classes:
            idx_c = np.flatnonzero(labels == c)
            rng.shuffle(idx_c)
            props = rng.dirichlet([alpha] * num_clients)
            cuts = (np.cumsum(props) * len(idx_c)).astype(int)[:-1]
            for cid, part in enumerate(np.split(idx_c, cuts)):
                idx_per_client[cid].extend(part.tolist())
        if min(len(ix) for ix in idx_per_client) >= min_size:
            break
    return [np.array(sorted(ix), dtype=np.int64) for ix in idx_per_client]


def client_batches(
    tokens: np.ndarray, labels: np.ndarray, idx: np.ndarray,
    steps: int, batch_size: int, seed: int = 0,
):
    """Sample ``steps`` minibatches (with replacement if the shard is small).
    Returns a dict of (steps, batch, ...) arrays."""
    rng = np.random.default_rng(seed)
    picks = rng.choice(idx, size=(steps, batch_size), replace=True)
    return {"tokens": tokens[picks], "labels": labels[picks]}
