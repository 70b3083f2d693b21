"""Rank-assignment policies for heterogeneous clients (a numpy-only copy
of ``repro/core/rank.py``; the same inputs give the same integer ranks).

The paper assigns ranks randomly in [2, 8]; the other policies are
targeted assignments (capacity, data size, the aggregate spectrum). All
return integer ranks per client, computed on the host.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def uniform_ranks(num_clients: int, r: int) -> np.ndarray:
    """Homogeneous baseline (paper: r=8)."""
    return np.full((num_clients,), r, dtype=np.int32)


def random_ranks(
    num_clients: int, r_min: int, r_max: int, seed: int = 0
) -> np.ndarray:
    """The paper's heterogeneous policy: r_k ~ U{r_min..r_max}."""
    rng = np.random.default_rng(seed)
    return rng.integers(r_min, r_max + 1, size=num_clients).astype(np.int32)


def capacity_ranks(
    capacities: Sequence[float], r_min: int, r_max: int
) -> np.ndarray:
    """Proportional to a client's compute budget: the slowest client gets
    r_min, the fastest r_max, linear in between."""
    c = np.asarray(capacities, dtype=np.float64)
    lo, hi = c.min(), c.max()
    t = np.zeros_like(c) if hi == lo else (c - lo) / (hi - lo)
    return np.round(r_min + t * (r_max - r_min)).astype(np.int32)


def data_ranks(
    num_examples: Sequence[int], r_min: int, r_max: int
) -> np.ndarray:
    """Proportional to the log of the local dataset size."""
    return capacity_ranks(np.log1p(np.asarray(num_examples, np.float64)),
                          r_min, r_max)


def spectrum_ranks(
    singular_values: np.ndarray,
    num_clients: int,
    r_min: int,
    r_max: int,
    energy: float = 0.95,
    capacities: Optional[Sequence[float]] = None,
) -> np.ndarray:
    """The smallest r* capturing ``energy`` of the aggregate spectrum's σ²,
    clamped to [r_min, r_max], then per client by capacity."""
    s2 = np.asarray(singular_values, np.float64) ** 2
    cum = np.cumsum(s2) / max(s2.sum(), 1e-30)
    r_star = int(np.searchsorted(cum, energy) + 1)
    r_star = int(np.clip(r_star, r_min, r_max))
    if capacities is None:
        return np.full((num_clients,), r_star, dtype=np.int32)
    cap = capacity_ranks(capacities, r_min, r_max)
    return np.minimum(cap, r_star).astype(np.int32)


def get_policy(name: str):
    return {
        "uniform": uniform_ranks,
        "random": random_ranks,
        "capacity": capacity_ranks,
        "data": data_ranks,
        "spectrum": spectrum_ranks,
    }[name]
