"""Non-IID federated partitioning (Dirichlet over labels, Hsu et al. 2019)
and per-client minibatch sampling: a numpy-only copy of
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


class LazyDirichlet:
    """Dirichlet partition that never materializes per-client index lists.

    Holds only the per-class shuffled index pools and a ``(num_clients+1,)``
    cut table per class, O(num_examples + num_clients·num_classes) memory,
    and slices one client's indices on demand in ``indices_for``. Draws
    from the same rng stream as ``dirichlet_partition``, so a single-pass
    eager partition (``min_size=0``, no retry) gives the same indices."""

    def __init__(self, labels: np.ndarray, num_clients: int,
                 alpha: float = 0.5, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.num_clients = int(num_clients)
        self._pools: List[np.ndarray] = []
        self._cuts: List[np.ndarray] = []
        self.sizes = np.zeros(self.num_clients, np.int64)
        for c in np.unique(labels):
            idx_c = np.flatnonzero(labels == c)
            rng.shuffle(idx_c)
            props = rng.dirichlet([alpha] * self.num_clients)
            inner = (np.cumsum(props) * len(idx_c)).astype(int)[:-1]
            cuts = np.concatenate([[0], inner, [len(idx_c)]])
            self._pools.append(idx_c)
            self._cuts.append(cuts)
            self.sizes += np.diff(cuts)

    def indices_for(self, cid: int) -> np.ndarray:
        """One client's sorted example indices, sliced on demand."""
        parts = [pool[cuts[cid]:cuts[cid + 1]]
                 for pool, cuts in zip(self._pools, self._cuts)]
        return np.sort(np.concatenate(parts).astype(np.int64)) if parts \
            else np.empty(0, np.int64)


def iid_partition(n: int, num_clients: int, seed: int = 0
                  ) -> List[np.ndarray]:
    """A uniform random split of ``range(n)`` into ``num_clients`` sorted
    shards of near-equal size."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    return [np.sort(p) for p in np.array_split(perm, num_clients)]


def client_batches(
    tokens: np.ndarray, labels: np.ndarray, idx: np.ndarray,
    steps: int, batch_size: int, seed: int = 0,
):
    """Sample ``steps`` minibatches (with replacement if the shard is small).
    Returns a dict of (steps, batch, ...) arrays."""
    rng = np.random.default_rng(seed)
    picks = rng.choice(idx, size=(steps, batch_size), replace=True)
    return {"tokens": tokens[picks], "labels": labels[picks]}
