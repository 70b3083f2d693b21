"""Deprecated asynchronous front door (port of
``repro/fed/async_server.py``): use :class:`repro_torch.fed.FedSession`
with a :class:`~repro_torch.fed.schedulers.BufferedAsync` scheduler.

``AsyncFedServer`` subclasses :class:`~repro_torch.fed.session.FedSession`:
``adapter_for`` is the session's shared redistribution path and ``submit``
is a buffer-of-one ``flush_async``, the staleness-discounted running
average, one engine call an event:

    w(τ) = base · (1 + τ)^(-staleness_exp),  τ = version − start_version

``simulate_async_rounds`` drives the ``BufferedAsync`` scheduler at buffer
size 1; the task head is merged with the same staleness weight as the
adapter.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core import agg_engine
from repro_torch.fed.schedulers import BufferedAsync
from repro_torch.fed.session import (AsyncConfig, FedSession,  # noqa: F401
                                     ServerConfig)


@dataclass
class _DirectUpdate:
    """A raw (unserialized) update for the legacy ``submit`` path."""
    client_id: int
    start_version: int
    num_examples: int
    adapter: Dict
    head: Optional[Dict] = None


class AsyncFedServer(FedSession):
    """Deprecated: event-driven async server over the session's math, on
    ``device`` (None = CUDA) like every other entry point."""

    def __init__(self, cfg: ModelConfig, scfg: ServerConfig,
                 acfg: AsyncConfig, base_params,
                 client_speeds: Sequence[float],
                 client_sizes: Optional[Sequence[int]] = None,
                 engine: Optional[agg_engine.AggregationEngine] = None,
                 device=None):
        warnings.warn(
            "AsyncFedServer is deprecated; use repro_torch.fed.FedSession "
            "with a BufferedAsync scheduler", DeprecationWarning,
            stacklevel=2)
        super().__init__(cfg, scfg, base_params, client_sizes=client_sizes,
                         engine=engine, acfg=acfg, device=device)
        self.speeds = np.asarray(client_speeds, np.float64)

    @property
    def sizes(self) -> np.ndarray:          # legacy attribute name
        return self.client_sizes

    def submit(self, cid: int, trained_lora: Dict, start_version: int,
               head=None) -> bool:
        """Merge one client's update (full-rank factors with masks);
        returns False if it was dropped as too stale. A buffer-of-one
        ``flush_async``."""
        upd = _DirectUpdate(
            client_id=int(cid), start_version=int(start_version),
            num_examples=int(self.client_sizes[int(cid)]),
            adapter=trained_lora, head=head)
        return self.flush_async([upd])[0]


def simulate_async_rounds(
    server: AsyncFedServer, local_train, frozen, data_fn,
    num_events: int = 40,
) -> Dict[str, List[float]]:
    """Discrete-event simulation over the ``BufferedAsync`` scheduler at
    buffer size 1 (the legacy event-by-event behaviour). ``frozen`` keeps
    the legacy contract: when given, clients train against it even if it
    differs from the session's own base."""
    train = local_train if frozen is None else \
        (lambda _base, trainable, masks, data:
         local_train(frozen, trainable, masks, data))
    sched = BufferedAsync(speeds=server.speeds, buffer_size=1,
                          acfg=server.acfg)
    return sched.run(server, train, data_fn, num_events)
