"""Population-scale client handling: lazy materialization and round samplers
(port of ``repro/fed/population.py``; the same seeds give the same sizes,
ranks, speeds, shards and cohorts).

``ClientPopulation``
    Metadata for N clients is always resident (example counts, ranks,
    speeds: a few numpy vectors). Shard data is built on demand by a
    ``shard_fn(cid)`` when a round's cohort is materialized, and released
    when the round's batches are stacked, so a 10k-client population never
    holds more than the sampled cohort (``max_resident``).
    ``from_partition`` backs it with :class:`repro_torch.data.LazyDirichlet`
    (per-class cut tables, no per-client index lists); ``synthetic``
    generates each client's shard from its own seed.

Samplers (``FedSession(sampler=...)``)
    Per-round cohort selection drawn only from the numpy rng the session
    hands them, so a fixed session seed gives the reference's cohorts:

    ``UniformSampler``            uniform without replacement.
    ``RankStratifiedSampler``     proportional quotas per rank bucket,
                                  largest-remainder rounding, every
                                  non-empty bucket represented whenever the
                                  cohort is big enough.
    ``AvailabilityTraceSampler``  samples only clients whose availability
                                  trace says they are online this round
                                  (``diurnal`` builds the phase-shifted
                                  day/night trace).

Shards are numpy arrays on the host; ``round_data`` stacks a round's
batches into int32 tensors on an explicit device.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import rank as rank_lib
from repro_torch.data.partition import LazyDirichlet, client_batches
from repro_torch.data.synthetic import make_pair_classification
from repro_torch.device import resolve_device

ShardFn = Callable[[int], Tuple[np.ndarray, np.ndarray]]


class ClientPopulation:
    """N clients' metadata, with shard data lazily materialized per round.

    ``shard_fn(cid) -> (tokens, labels)`` builds one client's examples;
    ``num_examples`` (and optionally ``ranks`` / ``speeds``) are the
    always-resident metadata vectors the session and the samplers read.
    ``metrics`` (a ``MetricsRegistry``; a session fills it in with its own
    when None) counts ``fed.population.materialized`` and gauges
    ``fed.population.resident``."""

    def __init__(self, shard_fn: ShardFn, num_examples,
                 ranks=None, speeds=None, seed: int = 0, metrics=None):
        self._shard_fn = shard_fn
        self.num_examples = np.asarray(num_examples, np.int64)
        self.ranks = None if ranks is None \
            else np.asarray(ranks, np.int32)
        self.speeds = None if speeds is None \
            else np.asarray(speeds, np.float64)
        self.seed = int(seed)
        self.metrics = metrics
        self._resident: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        #: high-water mark of simultaneously resident shards (at most the
        #: cohort when every round releases)
        self.max_resident = 0
        #: lifetime count of shard constructions (cache misses)
        self.materialized_total = 0

    @property
    def size(self) -> int:
        return int(len(self.num_examples))

    # -- lazy shard lifecycle ------------------------------------------------

    def materialize(self, cid: int):
        """Build (or reuse) one client's shard; bounded by ``release``."""
        cid = int(cid)
        if cid not in self._resident:
            self._resident[cid] = self._shard_fn(cid)
            self.materialized_total += 1
            self.max_resident = max(self.max_resident, len(self._resident))
            if self.metrics is not None:
                self.metrics.counter("fed.population.materialized").inc()
        if self.metrics is not None:
            self.metrics.gauge("fed.population.resident").set(
                len(self._resident))
        return self._resident[cid]

    def release(self) -> None:
        """Drop every resident shard (end of round)."""
        self._resident.clear()
        if self.metrics is not None:
            self.metrics.gauge("fed.population.resident").set(0)

    def resident(self) -> int:
        return len(self._resident)

    # -- round data ----------------------------------------------------------

    def round_data(self, cohort, rnd: int, local_steps: int,
                   local_batch: int, device=None
                   ) -> Dict[str, torch.Tensor]:
        """One round's stacked cohort batches ``{"tokens": (K, steps, B,
        seq), "labels": (K, steps, B)}`` (int32) on ``device`` (None = CUDA,
        which must exist): materialize exactly the cohort, sample each
        client's minibatches with the simulation's seed convention
        (``seed·7919 + rnd·131 + cid``), then release everything."""
        dev = resolve_device(device)
        toks, labs = [], []
        for cid in cohort:
            tokens, labels = self.materialize(cid)
            b = client_batches(
                tokens, labels, np.arange(len(labels)), local_steps,
                local_batch,
                seed=self.seed * 7919 + int(rnd) * 131 + int(cid))
            toks.append(b["tokens"])
            labs.append(b["labels"])
        self.release()
        return {"tokens": torch.from_numpy(np.stack(toks)).to(dev),
                "labels": torch.from_numpy(np.stack(labs)).to(dev)}

    def data_fn(self, local_steps: int, local_batch: int, device=None):
        """A ``data_fn(cohort, rnd)`` closure for the sync schedulers,
        its batches on ``device`` (None = CUDA)."""
        dev = resolve_device(device)

        def fn(cohort, rnd):
            return self.round_data(cohort, rnd, local_steps, local_batch,
                                   dev)
        return fn

    # -- constructors --------------------------------------------------------

    @classmethod
    def from_partition(cls, tokens: np.ndarray, labels: np.ndarray,
                       num_clients: int, alpha: float = 0.5, seed: int = 0,
                       r_min: int = 2, r_max: int = 8) -> "ClientPopulation":
        """Lazy Dirichlet split of one dataset: only the cut tables are
        resident (``LazyDirichlet``); a client's examples are gathered
        when its shard is materialized."""
        lazy = LazyDirichlet(labels, num_clients, alpha, seed)

        def shard_fn(cid: int):
            idx = lazy.indices_for(cid)
            return tokens[idx], labels[idx]

        ranks = rank_lib.random_ranks(num_clients, r_min, r_max, seed)
        return cls(shard_fn, lazy.sizes, ranks=ranks, seed=seed)

    @classmethod
    def synthetic(cls, num_clients: int, task: str = "mrpc", seed: int = 0,
                  mean_examples: int = 64, r_min: int = 2, r_max: int = 8,
                  vocab_size: int = 256) -> "ClientPopulation":
        """A fully synthetic population: each client's shard generated from
        its own seed on materialization, log-normal shard sizes and
        speeds; nothing but the metadata vectors exists up front."""
        rng = np.random.default_rng(seed)
        sizes = np.clip(
            rng.lognormal(np.log(mean_examples), 0.5, num_clients),
            8, 4 * mean_examples).astype(np.int64)
        ranks = rank_lib.random_ranks(num_clients, r_min, r_max, seed)
        speeds = np.clip(rng.lognormal(0.0, 0.4, num_clients), 0.2, 5.0)

        def shard_fn(cid: int):
            return make_pair_classification(
                task, int(sizes[cid]), seed=seed * 1_000_003 + cid + 1,
                vocab_size=vocab_size)

        return cls(shard_fn, sizes, ranks=ranks, speeds=speeds, seed=seed)


# ---------------------------------------------------------------------------
# Samplers
# ---------------------------------------------------------------------------

class ClientSampler:
    """Per-round cohort selection. ``sample`` draws only from the rng the
    session hands it, so a fixed session seed reproduces the cohort
    sequence."""

    name = "base"

    def sample(self, population: ClientPopulation,
               rng: np.random.Generator, round_idx: int,
               k: int) -> np.ndarray:
        raise NotImplementedError


class UniformSampler(ClientSampler):
    name = "uniform"

    def sample(self, population, rng, round_idx, k):
        k = min(int(k), population.size)
        return np.sort(rng.choice(population.size, size=k, replace=False))


class RankStratifiedSampler(ClientSampler):
    """Proportional per-rank-bucket quotas with largest-remainder
    rounding; whenever ``k >= #buckets`` every non-empty bucket gets at
    least one slot, so aggregation always sees the full rank spectrum."""

    name = "rank_stratified"

    def sample(self, population, rng, round_idx, k):
        if population.ranks is None:
            raise ValueError("rank-stratified sampling needs a population "
                             "with per-client ranks")
        ranks = population.ranks
        k = min(int(k), population.size)
        values = np.unique(ranks)
        buckets = [np.flatnonzero(ranks == v) for v in values]
        sizes = np.asarray([len(b) for b in buckets], np.float64)
        ideal = k * sizes / sizes.sum()
        quota = np.floor(ideal).astype(np.int64)
        floor_q = 1 if k >= len(buckets) else 0
        quota = np.minimum(np.maximum(quota, floor_q),
                           sizes.astype(np.int64))
        while quota.sum() < k:          # largest remainder fills up
            frac = ideal - quota
            frac[quota >= sizes] = -np.inf
            quota[int(np.argmax(frac))] += 1
        while quota.sum() > k:          # the floor guarantee overfilled
            over = quota - ideal
            over[quota <= floor_q] = -np.inf
            quota[int(np.argmax(over))] -= 1
        picks = [rng.choice(b, size=int(q), replace=False)
                 for b, q in zip(buckets, quota) if q > 0]
        return np.sort(np.concatenate(picks))


class AvailabilityTraceSampler(ClientSampler):
    """Samples uniformly among the clients whose availability trace is
    online at this round (``trace[cid, round % period]``); an all-offline
    tick falls back to uniform, so a round never stalls."""

    name = "availability"

    def __init__(self, trace):
        self.trace = np.asarray(trace, bool)
        if self.trace.ndim != 2:
            raise ValueError("trace must be (num_clients, period) bool")

    def sample(self, population, rng, round_idx, k):
        period = self.trace.shape[1]
        avail = np.flatnonzero(self.trace[:, int(round_idx) % period])
        if len(avail) == 0:
            return np.sort(rng.choice(population.size,
                                      size=min(int(k), population.size),
                                      replace=False))
        return np.sort(rng.choice(avail, size=min(int(k), len(avail)),
                                  replace=False))

    @classmethod
    def diurnal(cls, num_clients: int, period: int = 24, duty: float = 0.5,
                seed: int = 0) -> "AvailabilityTraceSampler":
        """Phase-shifted day/night pattern: each client is online for
        ``duty`` of every ``period`` rounds, offset by a random phase."""
        rng = np.random.default_rng(seed)
        phases = rng.integers(0, period, num_clients)
        hours = np.arange(period)
        on = max(1, int(round(duty * period)))
        trace = ((hours[None, :] - phases[:, None]) % period) < on
        return cls(trace)


_SAMPLERS = {"uniform": UniformSampler,
             "rank_stratified": RankStratifiedSampler}


def sampler_from_name(name: Optional[str]):
    """Resolve a config string (``uniform`` / ``rank_stratified``); a
    ``ClientSampler`` passes through. Availability sampling needs a trace,
    so it has no string form."""
    if name is None or isinstance(name, ClientSampler):
        return name
    s = str(name).strip().lower()
    if s in ("", "none"):
        return None
    if s not in _SAMPLERS:
        raise ValueError(f"unknown sampler {name!r}; "
                         f"known: {sorted(_SAMPLERS)}")
    return _SAMPLERS[s]()
