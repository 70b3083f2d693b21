"""Deprecated synchronous front door (port of ``repro/fed/server.py``): use
:class:`repro_torch.fed.FedSession` with a ``SyncRound`` scheduler.

``FedServer`` subclasses :class:`~repro_torch.fed.session.FedSession` and
keeps only the legacy method names (``cohort_adapters`` →
``redistribute``, ``update_global`` → ``aggregate_round``); all the math
lives in the session. ``ServerConfig``, ``AsyncConfig`` and
``assign_ranks`` are re-exported from ``fed/session.py``.
"""
from __future__ import annotations

import warnings
from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core import agg_engine
from repro_torch.fed.session import (AsyncConfig, FedSession,  # noqa: F401
                                     ServerConfig, assign_ranks)


class FedServer(FedSession):
    """Deprecated: construct a ``FedSession`` (and a ``SyncRound``)
    instead. Kept as a delegating shim for existing callers; runs on
    ``device`` (None = CUDA) like every other entry point."""

    def __init__(self, cfg: ModelConfig, server_cfg: ServerConfig,
                 base_params, client_sizes: Sequence[int],
                 capacities: Optional[Sequence[float]] = None,
                 engine: Optional[agg_engine.AggregationEngine] = None,
                 device=None):
        warnings.warn(
            "FedServer is deprecated; use repro_torch.fed.FedSession with "
            "a SyncRound scheduler", DeprecationWarning, stacklevel=2)
        super().__init__(cfg, server_cfg, base_params,
                         client_sizes=client_sizes, capacities=capacities,
                         engine=engine, device=device)

    # -- legacy method names -------------------------------------------------

    def cohort_adapters(self, cohort: np.ndarray) -> Dict[str, dict]:
        return self.redistribute(cohort)

    def update_global(self, stacked_trained, cohort: np.ndarray,
                      stacked_heads=None) -> None:
        self.aggregate_round(stacked_trained, cohort,
                             stacked_heads=stacked_heads)
