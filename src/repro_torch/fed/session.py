"""FedSession, the server side of a federated run (port of
``repro/fed/session.py``): synchronous rounds and buffered asynchronous
merges on one session.

* **State**: frozen base, global adapter at r_max, task head, per-client
  ranks, per-target rank caps, the numpy rng, the round counter, the comm
  log; every tensor on the session's ``device``.
* **Strategy** (``fed/strategies.py``): the engine configuration that
  aggregates a cohort and the redistribution scale policy.
* **Redistribution**: ``redistribute`` masks the global adapter to each
  client's rank (clamped by per-target caps from spectrum adaptation) and
  applies the strategy's scale correction.
* **Wire accounting** (``fed/messages.py``): ``broadcast_cohort``,
  ``adapter_for``, ``collect_updates`` and ``make_update`` round-trip the
  payloads through serialized ``Broadcast`` / ``ClientUpdate`` messages,
  encoded by the session's wire codec (``codec=`` or
  ``ServerConfig.codec``, ``fed/compress.py``), and log the measured bytes
  (``_log_comm``; a two-tier topology adds ``edge<i>_uplink`` rows on
  ``fed.edge<i>`` tracks). Without a codec the round trip is exact, so the
  measured path is the compute path; with one, what the receiver computes
  on is what it decoded.
* **Populations** (``fed/population.py``): with ``population=`` the
  clients' sizes and ranks come from a lazily materialized population, and
  a ``sampler=`` picks each round's cohort from the session rng.
* **Merges**: ``aggregate_round`` (a synchronous cohort) and
  ``flush_async`` (a buffer of asynchronous updates, each discounted by
  its staleness under ``AsyncConfig``) are the only merge entry points;
  both make one engine call and run the same rank adaptation after it.

The session draws from one ``np.random.default_rng(scfg.seed)`` exactly as
the reference does: the cohort, the capacities of the ``capacity`` policy
and one ``integers(2**31)`` per aggregation, which seeds the engine's
``torch.Generator`` (the reference makes a ``jax.random`` key of it). So
the same configuration gives the reference's cohorts in every round. The
initial global adapter comes from a ``torch.Generator`` seeded with
``scfg.seed`` (the reference's from ``jax.random``): the same
distributions, not the same numbers.

* **Checkpoint / resume** (``save``, ``restore``): the global factors and
  masks, the head and the ranks through ``repro_torch.checkpoint``, the
  round counters, ``target_ranks``, the strategy's name, the rng's
  bit-generator state and the comm log in its JSON meta, and, inside a
  ``BufferedAsync`` run, its live state (the event heap, the pending
  adapters and the K-buffer's wire bytes) under ``async``; the reference's
  keys, so each package restores what the other saved, mid-flight
  included.

* **Observability** (``recorder=``, ``obs/recorder.py``), as the
  reference records it: ``broadcast``, ``collect``, ``aggregate`` and
  ``flush`` spans on the ``fed.server`` track, a ``fed.downlink_bytes`` /
  ``fed.uplink_bytes`` counter sample on ``fed.wire`` a logged message
  batch, and ``health_anomaly`` instants on ``obs.slo``. The session's
  spans do not block: each ends when its host code returns, with the
  device work it queued perhaps still running (``collect`` and the
  message serialization copy to the host, so they wait for what came
  before them). The recorder never synchronizes.

Not ported: the mesh (``mesh=`` raises ``NotImplementedError``); the port
runs one device.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import store
from repro_torch.configs.base import ModelConfig
from repro_torch.core import agg_engine
from repro_torch.core import rank as rank_lib
from repro_torch.device import resolve_device
from repro_torch.fed import compress as compress_lib
from repro_torch.fed import messages as msg_lib
from repro_torch.fed import strategies as strat_lib
from repro_torch.fed.client import split_head
from repro_torch.fed.population import sampler_from_name
from repro_torch.models import transformer as tf_lib
from repro_torch.obs.metrics import MetricsRegistry, percentile
from repro_torch.obs.recorder import NULL_RECORDER
from repro_torch.obs.slo import SLO_TRACK


@dataclass
class ServerConfig:
    num_clients: int = 100
    clients_per_round: int = 20
    strategy: str = "hlora"          # naive | hlora | flora
    svd_method: str = "factored"     # factored | exact | randomized
    split: str = "paper"             # paper | sqrt
    # uniform | random | capacity | data | spectrum. 'spectrum' reads the
    # singular spectrum of ΔW' after each aggregation and assigns the
    # smallest rank capturing ``spectrum_energy`` of it.
    rank_policy: str = "random"
    spectrum_energy: float = 0.95
    # each LoRA target gets its own energy rank from its own spectrum;
    # redistribution masks target t to min(r_client, r_target)
    per_target_ranks: bool = False
    r_min: int = 2
    r_max: int = 8
    seed: int = 0
    # wire codec of every Broadcast / ClientUpdate ("none" keeps the
    # messages byte-identical to the raw format): none | bf16 | int8 |
    # topk[:k] (fed/compress.py)
    codec: str = "none"


@dataclass
class AsyncConfig:
    """Staleness policy for async merges (FedAsync-style)."""
    staleness_exp: float = 0.5     # polynomial discount (1+τ)^-exp
    base_weight: float = 0.25      # mixing rate for fresh updates
    max_staleness: int = 16        # drop updates older than this


def assign_ranks(scfg: ServerConfig, client_sizes, capacities=None,
                 rng=None) -> np.ndarray:
    n = scfg.num_clients
    if scfg.rank_policy == "uniform":
        return rank_lib.uniform_ranks(n, scfg.r_max)
    if scfg.rank_policy == "random":
        return rank_lib.random_ranks(n, scfg.r_min, scfg.r_max, scfg.seed)
    if scfg.rank_policy == "capacity":
        caps = capacities if capacities is not None else \
            (rng or np.random.default_rng(scfg.seed)).random(n)
        return rank_lib.capacity_ranks(caps, scfg.r_min, scfg.r_max)
    if scfg.rank_policy == "data":
        return rank_lib.data_ranks(client_sizes, scfg.r_min, scfg.r_max)
    if scfg.rank_policy == "spectrum":
        # starts at r_max; adapt_ranks() tightens it after each round
        return rank_lib.uniform_ranks(n, scfg.r_max)
    raise ValueError(scfg.rank_policy)


class FedSession:
    def __init__(self, cfg: ModelConfig, scfg: ServerConfig, base_params,
                 client_sizes: Optional[Sequence[int]] = None,
                 capacities: Optional[Sequence[float]] = None,
                 engine: Optional[agg_engine.AggregationEngine] = None,
                 strategy=None,
                 acfg: Optional[AsyncConfig] = None,
                 track_comm: bool = True,
                 mesh=None,
                 recorder=None,
                 metrics: Optional[MetricsRegistry] = None,
                 population=None,
                 sampler=None,
                 codec=None,
                 device=None):
        """``base_params``: a ``Transformer`` on ``device`` (None = CUDA,
        which must exist). ``population``: a ``ClientPopulation`` whose
        sizes and ranks the session takes; ``sampler``: a ``ClientSampler``
        or its name, which needs a population; ``codec``: a ``WireCodec``
        or its name (None: ``scfg.codec``)."""
        if mesh is not None:
            raise NotImplementedError(
                "FedSession(mesh=...) is not ported: the port runs one "
                "device")
        self.device = resolve_device(device)
        if base_params.embed.device != self.device:
            raise ValueError(f"base params on {base_params.embed.device}, "
                             f"the session on {self.device}")
        self.cfg = cfg
        self.scfg = scfg
        self.acfg = acfg if acfg is not None else AsyncConfig()
        if strategy is None:
            strategy = scfg.strategy
        self.strategy = (strategy if isinstance(
            strategy, strat_lib.AggregationStrategy)
            else strat_lib.from_name(strategy, scfg))
        frozen, head = split_head(base_params)
        self.base = frozen
        self.global_head = head   # task head: FedAvg'd in-session
        self.rng = np.random.default_rng(scfg.seed)
        # population mode: client metadata (sizes, ranks) comes from the
        # lazily materialized population; shard data is built per round by
        # its data_fn, so the session holds only the cohort's updates
        self.population = population
        self.sampler = sampler_from_name(sampler)
        if population is not None:
            if population.size != scfg.num_clients:
                raise ValueError(
                    f"population has {population.size} clients but "
                    f"scfg.num_clients={scfg.num_clients}")
            if client_sizes is None:
                client_sizes = population.num_examples
        elif self.sampler is not None:
            raise ValueError("a sampler needs a population")
        self.client_sizes = np.asarray(
            client_sizes if client_sizes is not None
            else np.full(scfg.num_clients, 64), np.int64)
        self.ranks = assign_ranks(scfg, self.client_sizes, capacities,
                                  self.rng)
        if population is not None and population.ranks is not None:
            self.ranks = population.ranks.astype(np.int32).copy()
        # the wire codec of every Broadcast / ClientUpdate; None keeps the
        # messages byte-identical to the raw format
        self.codec = compress_lib.from_name(
            codec if codec is not None else scfg.codec)
        # global adapter at full rank (A gaussian, B zero => ΔW = 0)
        gen = torch.Generator(device=self.device).manual_seed(scfg.seed)
        self.global_lora = tf_lib.init_lora(gen, cfg, device=self.device)
        self.engine = engine if engine is not None \
            else agg_engine.default_engine()
        # singular spectrum of the last aggregated ΔW' per target,
        # {target: (*stack, r_max)}, from the engine
        self.last_spectrum: Optional[dict] = None
        # per-target rank caps ({target: r}) set by adapt_ranks when
        # scfg.per_target_ranks; None until the first adaptation
        self.target_ranks: Optional[Dict[str, int]] = None
        self.rounds_done = 0
        self.version = 0                      # async merge counter
        self.staleness_log: List[int] = []
        self.track_comm = track_comm
        # measured wire bytes, one entry per broadcast_cohort /
        # collect_updates / make_update / adapter_for call
        self.comm_log: Dict[str, List[int]] = {"downlink": [], "uplink": []}
        # recorder defaults to the no-op singleton; metrics are always on.
        # Server phases record on "fed.server" (the scheduler puts rounds
        # and client training on their own tracks, so no track nests)
        self.rec = recorder if recorder is not None else NULL_RECORDER
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        # per-round health rows (``health_snapshot``), observe-only
        self.health_log: List[Dict[str, float]] = []
        self.health_z_threshold: float = 3.0
        self._health_seen: Dict[str, float] = {}
        if population is not None and population.metrics is None:
            population.metrics = self.metrics
        # live BufferedAsync state ({heap, pending, buffer}), installed by
        # the scheduler and serialized by save/restore, so that an async
        # run can checkpoint mid-flight and resume exactly
        self.async_state: Optional[dict] = None

    def _log_comm(self, direction: str, nbytes: int,
                  track: str = "fed.wire") -> None:
        """The comm accounting choke point: the per-call ``comm_log`` row,
        a registry byte counter and, while recording, a wire-traffic
        counter sample on ``track``. A new direction (the topology's
        ``edge<i>_uplink``) makes its own column and counter."""
        self.comm_log.setdefault(direction, []).append(nbytes)
        self.metrics.counter(f"fed.{direction}_bytes").inc(int(nbytes))
        if self.rec.enabled:
            self.rec.counter_sample(f"fed.{direction}_bytes", track,
                                    int(nbytes))

    # -- cohort handling ----------------------------------------------------

    def sample_cohort(self) -> np.ndarray:
        """This round's cohort, drawn from the session rng: by the sampler
        in population mode (recording a ``cohort_sampled`` instant on
        ``fed.server``), else uniformly without replacement."""
        if self.sampler is not None:
            cohort = np.asarray(self.sampler.sample(
                self.population, self.rng, self.rounds_done,
                self.scfg.clients_per_round), np.int64)
            if self.rec.enabled:
                self.rec.instant("cohort_sampled", "fed.server",
                                 sampler=self.sampler.name,
                                 cohort=len(cohort),
                                 round=self.rounds_done)
            return cohort
        return self.rng.choice(self.scfg.num_clients,
                               size=self.scfg.clients_per_round,
                               replace=False)

    def cohort_weights(self, cohort: np.ndarray) -> torch.Tensor:
        n_k = self.client_sizes[cohort].astype(np.float64)
        return torch.tensor(n_k / n_k.sum(), dtype=torch.float32,
                            device=self.device)

    def cohort_heads(self, cohort: np.ndarray) -> Dict[str, torch.Tensor]:
        k = len(cohort)
        return {n: x[None].expand(k, *x.shape).clone()
                for n, x in self.global_head.items()}

    # -- redistribution -----------------------------------------------------

    def _cohort_masks(self, cohort: np.ndarray, mask_shape,
                      cap: Optional[int] = None) -> torch.Tensor:
        """Rank masks for the cohort; ``cap`` (per-target rank) clamps
        every client's rank from above: SVD components are ordered, so the
        first min(r_k, cap) directions are the optimal truncation."""
        r_max = self.cfg.lora.r_max
        masks = np.zeros((len(cohort), *mask_shape), np.float32)
        for i, cid in enumerate(cohort):
            r_k = int(self.ranks[cid]) if cap is None \
                else min(int(self.ranks[cid]), int(cap))
            masks[i, ...] = (np.arange(r_max) < r_k).astype(np.float32)
        return torch.from_numpy(masks).to(self.device)

    def redistribute(self, cohort: np.ndarray) -> Dict[str, dict]:
        """Per-client rank-r_k truncation of the global adapter, clamped
        per target when per-target ranks are adapted, with the strategy's
        scale correction (hlora: r_eff/r_max on B, so the client's
        effective update is exactly the rank-r_k truncation of ΔW';
        naive and flora send plain truncated factors)."""
        k = len(cohort)
        r_max = self.cfg.lora.r_max
        out = {}
        for t, ad in self.global_lora.items():
            cap = None if self.target_ranks is None \
                else self.target_ranks.get(t)
            m = self._cohort_masks(cohort, tuple(ad["mask"].shape), cap)
            a = ad["A"][None].expand(k, *ad["A"].shape) * m[..., None, :]
            b = ad["B"][None].expand(k, *ad["B"].shape) * m[..., :, None]
            if self.strategy.scale_correction:
                r_eff = torch.clamp(m.sum(-1), min=1.0)      # (K, *stack)
                b = b * (r_eff / float(r_max))[..., None, None]
            out[t] = {"A": a, "B": b, "mask": m}
        return out

    def _client_ranks(self, cid: int) -> Dict[str, int]:
        """Per-target effective rank of one client (cap-clamped)."""
        r = int(self.ranks[cid])
        out = {}
        for t in self.global_lora:
            cap = None if self.target_ranks is None \
                else self.target_ranks.get(t)
            out[t] = r if cap is None else min(r, int(cap))
        return out

    # -- wire-level broadcast / collect -------------------------------------

    def make_broadcast(self, cid: int, stacked_slice) -> msg_lib.Broadcast:
        """One client's ``Broadcast`` from its slice of the redistributed
        stack (already masked and scale-corrected)."""
        payload = msg_lib.truncate_adapter(stacked_slice,
                                           self._client_ranks(cid))
        return msg_lib.Broadcast(version=self.version, client_id=int(cid),
                                 adapter=payload,
                                 head=dict(self.global_head),
                                 codec=self.codec)

    @staticmethod
    def _stack_clients(per_client, heads):
        """Re-stack per-client unpacked trees and heads along a cohort
        axis."""
        out = {t: {leaf: torch.stack([c[t][leaf] for c in per_client])
                   for leaf in ("A", "B", "mask")}
               for t in per_client[0]}
        heads_st = {k: torch.stack([h[k] for h in heads]) for k in heads[0]} \
            if heads and heads[0] else {}
        return out, heads_st

    def broadcast_cohort(self, cohort: np.ndarray):
        """Redistribute to a cohort through the wire format: returns
        ``(stacked_tree, stacked_heads)`` rebuilt from the serialized
        ``Broadcast`` messages, and logs the measured downlink bytes."""
        with self.rec.span("broadcast", "fed.server", cohort=len(cohort)):
            stacked = self.redistribute(cohort)
            if not self.track_comm:
                self._log_comm("downlink", 0)
                return stacked, self.cohort_heads(cohort)
            r_max = self.cfg.lora.r_max
            per_client, heads, total = [], [], 0
            for i, cid in enumerate(cohort):
                sl = {t: {"A": ad["A"][i], "B": ad["B"][i]}
                      for t, ad in stacked.items()}
                wire = msg_lib.Broadcast.from_bytes(
                    self.make_broadcast(cid, sl).to_bytes())
                total += wire.num_bytes
                tree, head = wire.unpack(r_max, self.device)
                per_client.append(tree)
                heads.append(head)
            self._log_comm("downlink", total)
            return self._stack_clients(per_client, heads)

    def adapter_for(self, cid: int) -> Tuple[Dict, int]:
        """Async client-facing broadcast: the rank-r_k truncation of the
        current global adapter (``redistribute``: strategy scale and
        per-target caps included) through a ``Broadcast`` round trip whose
        downlink bytes are logged, and the server version. The tree is the
        client's own: no tensor of it is a view of the global adapter."""
        stacked = self.redistribute(np.array([cid]))
        sl = {t: {k: v[0] for k, v in ad.items()}
              for t, ad in stacked.items()}
        if self.track_comm:
            wire = msg_lib.Broadcast.from_bytes(
                self.make_broadcast(cid, sl).to_bytes())
            self._log_comm("downlink", wire.num_bytes)
            tree, _head = wire.unpack(self.cfg.lora.r_max, self.device)
            return tree, self.version
        return sl, self.version

    def make_update(self, cid: int, trained_lora: Dict, start_version: int,
                    head=None, log: bool = True) -> msg_lib.ClientUpdate:
        """One client's trained adapter (and head) as a ``ClientUpdate``,
        logging the measured uplink bytes (``log=False`` when the caller
        accounts for them itself)."""
        ranks = {}
        for t, ad in trained_lora.items():
            m = ad["mask"].reshape(-1, ad["mask"].shape[-1])
            ranks[t] = int(m[0].sum())
        upd = msg_lib.ClientUpdate(
            client_id=int(cid), start_version=int(start_version),
            num_examples=int(self.client_sizes[int(cid)]),
            adapter=msg_lib.truncate_adapter(trained_lora, ranks),
            head=dict(head or {}), codec=self.codec)
        if log:
            self._log_comm("uplink", upd.num_bytes
                           if self.track_comm else 0)
        return upd

    def collect_updates(self, cohort: np.ndarray, trained_tree: Dict,
                        trained_heads=None):
        """Round-trip a trained cohort stack through ``ClientUpdate``
        messages (one uplink comm_log row a round) and return the
        re-stacked tree and heads for :meth:`aggregate_round`."""
        with self.rec.span("collect", "fed.server", cohort=len(cohort)):
            if not self.track_comm:
                self._log_comm("uplink", 0)
                return trained_tree, trained_heads
            r_max = self.cfg.lora.r_max
            per_client, heads, total = [], [], 0
            for i, cid in enumerate(cohort):
                sl = {t: {leaf: ad[leaf][i] for leaf in ("A", "B", "mask")}
                      for t, ad in trained_tree.items()}
                h = None if trained_heads is None else \
                    {k: v[i] for k, v in trained_heads.items()}
                upd = msg_lib.ClientUpdate.from_bytes(
                    self.make_update(cid, sl, self.version, h,
                                     log=False).to_bytes())
                total += upd.num_bytes
                tree, head = upd.unpack(r_max, self.device)
                per_client.append(tree)
                heads.append(head)
            self._log_comm("uplink", total)
            out, heads_st = self._stack_clients(per_client, heads)
            return out, (heads_st or None) if trained_heads is not None \
                else None

    # -- aggregation ---------------------------------------------------------

    def aggregate_round(self, stacked_trained, cohort: np.ndarray,
                        stacked_heads=None, weights=None) -> None:
        """Synchronous cohort merge: one engine call (Eq. 2 + 3 under
        hlora and flora, Eq. 1 under naive), output at full rank r_max.
        Task heads are FedAvg'd with the same cohort weights under every
        strategy. ``weights`` overrides the per-client data weights."""
        with self.rec.span("aggregate", "fed.server", cohort=len(cohort),
                           round=self.rounds_done):
            eta = self.cohort_weights(cohort) if weights is None \
                else torch.as_tensor(weights, dtype=torch.float32,
                                     device=self.device)
            if stacked_heads:
                self.global_head = {
                    k: torch.tensordot(eta, x.float(), dims=1).to(x.dtype)
                    for k, x in stacked_heads.items()}
            full = {t: torch.ones_like(ad["mask"][:1])
                    for t, ad in stacked_trained.items()}
            # drawn every round under every strategy, as the reference
            # draws its key, so the session's stream stays aligned with it
            gen = torch.Generator(device=self.device).manual_seed(
                int(self.rng.integers(2 ** 31)))
            out, spectra = self.engine(
                stacked_trained, eta, self.cfg.lora.alpha,
                **self.strategy.engine_kwargs(), new_masks=full, gen=gen)
            self.global_lora = {
                t: {"A": ad["A"][0], "B": ad["B"][0], "mask": ad["mask"][0]}
                for t, ad in out.items()}
            self.last_spectrum = spectra if self.strategy.has_spectrum \
                else None
            if self.scfg.rank_policy == "spectrum":
                self.adapt_ranks()
            self.rounds_done += 1
            self.metrics.counter("fed.rounds").inc()

    def flush_async(self, updates: Sequence) -> List[bool]:
        """Buffered asynchronous merge: fold K client updates into the
        global adapter in one engine call. Update u_i gets the weight

            w_i = base_weight · (1+τ_i)^(-staleness_exp) · n_i / n̄

        (τ_i = version − start_version_i at flush time, n̄ the buffer's
        mean data size), computed in float64 on the host; the global keeps
        ``max(1 − Σw, 0)`` and the engine normalizes. Updates older than
        ``max_staleness`` are dropped. The task head is averaged with the
        same normalized weights. Returns one accepted flag an update.

        ``updates``: objects with .adapter (rank-truncated from the wire, or
        full-rank with masks), .head (dict, maybe empty), .start_version
        and .num_examples: ``ClientUpdate``s or ``make_update`` results."""
        taus = [self.version - int(u.start_version) for u in updates]
        self.staleness_log.extend(taus)
        stale_h = self.metrics.histogram("fed.staleness")
        for tau in taus:
            stale_h.observe(tau)
        keep = [i for i, tau in enumerate(taus)
                if tau <= self.acfg.max_staleness]
        flags = [i in keep for i in range(len(updates))]
        self.metrics.counter("fed.updates_merged").inc(len(keep))
        self.metrics.counter("fed.updates_dropped").inc(
            len(taus) - len(keep))
        if not keep:
            return flags
        with self.rec.span("flush", "fed.server", merged=len(keep),
                           version=self.version):
            return self._flush_merge(updates, taus, keep, flags)

    def _flush_merge(self, updates, taus, keep, flags) -> List[bool]:
        survivors = [updates[i] for i in keep]
        n = np.asarray([max(int(u.num_examples), 1) for u in survivors],
                       np.float64)
        ws = [float(self.acfg.base_weight
                    * (1.0 + taus[i]) ** (-self.acfg.staleness_exp)
                    * (n[j] / n.mean()))
              for j, i in enumerate(keep)]
        residual = max(1.0 - sum(ws), 0.0)
        eta = torch.tensor([residual] + ws, dtype=torch.float32,
                           device=self.device)
        adapters = [self._unpack_update_adapter(u) for u in survivors]
        tree = {t: {leaf: torch.stack([g[leaf]] + [ad[t][leaf]
                                                   for ad in adapters])
                    for leaf in ("A", "B", "mask")}
                for t, g in self.global_lora.items()}
        new_masks = {t: torch.ones_like(st["mask"][:1])
                     for t, st in tree.items()}
        out, spectra = self.engine(tree, eta, self.cfg.lora.alpha,
                                   **self.strategy.engine_kwargs(),
                                   new_masks=new_masks)
        self.global_lora = {t: {k: v[0] for k, v in ad.items()}
                            for t, ad in out.items()}
        heads = [u.head for u in survivors]
        if self.global_head and heads and all(h for h in heads):
            etan = eta / eta.sum()
            self.global_head = {
                k: torch.tensordot(etan, torch.stack(
                    [g.float()] + [h[k].to(self.device, torch.float32)
                                   for h in heads]), dims=1).to(g.dtype)
                for k, g in self.global_head.items()}
        self.last_spectrum = spectra if self.strategy.has_spectrum else None
        self.version += len(keep)
        if self.scfg.rank_policy == "spectrum":
            self.adapt_ranks()
        return flags

    def _unpack_update_adapter(self, u) -> Dict:
        """An update's adapter arrives either full-rank with masks (the
        legacy direct submit) or rank-truncated from the wire
        (``ClientUpdate``), which is padded back to r_max on the
        session's device."""
        ad = u.adapter
        first = next(iter(ad.values()))
        if "mask" in first:
            return ad
        return msg_lib.pad_adapter(ad, self.cfg.lora.r_max, self.device)

    # -- rank adaptation ----------------------------------------------------

    def _target_spectra(self) -> Dict[str, np.ndarray]:
        """Per-target mean singular spectrum of the aggregated ΔW', from
        the engine; without one (naive runs no SVD), from the row norms
        of the global B factors, normalized per split ('sqrt' puts √σ in
        each factor)."""
        if self.last_spectrum is not None:
            out = {}
            for t, s in self.last_spectrum.items():
                s = s.detach().cpu().numpy().astype(np.float64)
                out[t] = s.reshape(-1, s.shape[-1]).mean(0)
            return out
        out = {}
        for t, ad in self.global_lora.items():
            b = torch.linalg.vector_norm(ad["B"], dim=-1).cpu().numpy()
            s = b.reshape(-1, b.shape[-1]).mean(axis=0)
            if self.strategy.split == "sqrt":
                s = s ** 2
            out[t] = s
        return out

    def adapt_ranks(self) -> None:
        """Read the singular spectrum of the aggregated ΔW' and pick the
        smallest rank capturing ``spectrum_energy`` of it, one rank for
        every client from the spectra pooled across targets; with
        ``scfg.per_target_ranks`` each target also gets its own cap."""
        spectra = self._target_spectra()
        e, lo, hi = (self.scfg.spectrum_energy, self.scfg.r_min,
                     self.scfg.r_max)
        r_star = agg_engine.rank_for_energy(
            np.stack(list(spectra.values())), e, lo, hi)
        self.ranks = np.full((self.scfg.num_clients,), r_star, np.int32)
        if self.scfg.per_target_ranks:
            self.target_ranks = {
                t: agg_engine.rank_for_energy(s, e, lo, hi)
                for t, s in spectra.items()}

    # -- accessors -----------------------------------------------------------

    def global_params(self) -> tf_lib.Transformer:
        """The frozen base with the global head and adapter in place."""
        params = copy.copy(self.base)
        params.cls = dict(self.global_head)
        params.lora = self.global_lora
        return params

    def comm_totals(self) -> Dict[str, int]:
        return {k: int(sum(v)) for k, v in self.comm_log.items()}

    # -- health snapshots ----------------------------------------------------

    #: snapshot keys scanned for z-score anomalies against the history
    _HEALTH_ANOMALY_KEYS = ("downlink_bytes", "uplink_bytes",
                            "stragglers", "staleness_p99")

    def health_snapshot(self) -> Dict[str, float]:
        """One per-round health row: wire bytes, stragglers, merged and
        dropped updates and staleness percentiles since the previous
        snapshot, appended to ``health_log``. With >= 3 earlier rows,
        each of ``_HEALTH_ANOMALY_KEYS`` is z-scored against them; a |z|
        above ``health_z_threshold`` counts in ``fed.health.anomalies`` and,
        while recording, records a ``health_anomaly`` instant on the
        ``obs.slo`` track. Observe-only, from already-counted state (no
        clock read)."""
        seen = self._health_seen

        def delta(key: str, cur: float) -> float:
            d = cur - seen.get(key, 0.0)
            seen[key] = cur
            return float(d)

        snap: Dict[str, float] = {
            "round": float(self.rounds_done),
            "version": float(self.version),
            "downlink_bytes": delta("downlink",
                                    sum(self.comm_log["downlink"])),
            "uplink_bytes": delta("uplink", sum(self.comm_log["uplink"])),
            "stragglers": delta(
                "stragglers",
                self.metrics.counter("fed.stragglers").value),
            "updates_merged": delta(
                "merged", self.metrics.counter("fed.updates_merged").value),
            "updates_dropped": delta(
                "dropped",
                self.metrics.counter("fed.updates_dropped").value),
        }
        new_stale = self.staleness_log[int(seen.get("stale_n", 0)):]
        seen["stale_n"] = float(len(self.staleness_log))
        if new_stale:
            snap["staleness_p50"] = float(percentile(new_stale, 50))
            snap["staleness_p99"] = float(percentile(new_stale, 99))
        else:
            snap["staleness_p50"] = snap["staleness_p99"] = 0.0
        anomalies = []
        if len(self.health_log) >= 3:
            for k in self._HEALTH_ANOMALY_KEYS:
                hist = np.asarray([h[k] for h in self.health_log],
                                  np.float64)
                sd = float(hist.std())
                if sd <= 1e-12:
                    continue
                z = (snap[k] - float(hist.mean())) / sd
                if abs(z) > self.health_z_threshold:
                    anomalies.append(k)
                    self.metrics.counter("fed.health.anomalies").inc()
                    if self.rec.enabled:
                        self.rec.instant("health_anomaly", SLO_TRACK,
                                         metric=k, z=float(z),
                                         value=snap[k],
                                         round=self.rounds_done)
        snap["anomalies"] = float(len(anomalies))
        self.health_log.append(snap)
        return snap

    # -- checkpoint / resume -------------------------------------------------

    def save(self, ckpt_dir: str, step: Optional[int] = None) -> str:
        """Persist the global factors, masks, head and ranks through
        ``repro_torch.checkpoint``; the round counters, ``target_ranks``,
        the strategy's name, the rng's bit-generator state and the comm log
        ride in the JSON meta, so a restored session replays the same
        cohorts and draws. The default step is rounds_done + version, as in
        the reference (sync rounds advance the one, async flushes the
        other). Inside a ``BufferedAsync`` run the live async state rides
        along (``_pack_async_state``)."""
        tree = {"global_lora": self.global_lora,
                "global_head": self.global_head,
                "ranks": np.asarray(self.ranks, np.int32)}
        if self.async_state is not None:
            tree["async"] = self._pack_async_state()
        meta = {
            "rounds_done": self.rounds_done,
            "version": self.version,
            "staleness_log": list(map(int, self.staleness_log)),
            "target_ranks": self.target_ranks,
            "strategy": self.strategy.name,
            "rng_state": self.rng.bit_generator.state,
            "comm_log": {k: list(map(int, v))
                         for k, v in self.comm_log.items()},
        }
        return store.save(ckpt_dir, self.rounds_done + self.version
                          if step is None else step, tree, meta)

    def _pack_async_state(self) -> dict:
        """The live ``BufferedAsync`` state for ``save``: the heap in its
        list order (a valid heap list is its own heapified form, so the
        restored list pops in the same order) as float64 times and int64
        client ids and versions, the pending adapters keyed ``%08d``, and
        the K-buffer's ``ClientUpdate``s as their wire bytes keyed
        ``%06d``."""
        st = self.async_state
        heap = st["heap"]
        return {
            "heap": {
                "t": np.asarray([h[0] for h in heap], np.float64),
                "cid": np.asarray([h[1] for h in heap], np.int64),
                "ver": np.asarray([h[2] for h in heap], np.int64)},
            "pending": {f"{int(cid):08d}": tree
                        for cid, tree in st["pending"].items()},
            "buffer": {f"{i:06d}": u.to_bytes()
                       for i, u in enumerate(st["buffer"])},
        }

    @staticmethod
    def _unpack_async_state(packed: dict) -> dict:
        """Inverse of :meth:`_pack_async_state` on a restored tree (its
        tensors already on the session's device): the heap as Python
        (float, int, int) tuples, so that ties break as before."""
        h = packed["heap"]
        heap = [(float(t), int(c), int(v)) for t, c, v in zip(
            h["t"].tolist(), h["cid"].tolist(), h["ver"].tolist())]
        pending = {int(k): tree
                   for k, tree in packed.get("pending", {}).items()}
        buffer = [msg_lib.ClientUpdate.from_bytes(packed["buffer"][k])
                  for k in sorted(packed.get("buffer", {}))]
        return {"heap": heap, "pending": pending, "buffer": buffer}

    @classmethod
    def restore(cls, ckpt_dir: str, cfg: ModelConfig, scfg: ServerConfig,
                base_params, step: Optional[int] = None,
                **session_kwargs) -> "FedSession":
        """Rebuild a session mid-run, every tensor on its ``device``. The
        saved strategy's name is re-applied unless the caller passes an
        explicit ``strategy``: a session saved under 'flora' must not
        resume under ``scfg.strategy``'s math. ``last_spectrum`` is not
        persisted, so the next ``adapt_ranks`` takes the split-normalized
        factor-norm fallback of ``_target_spectra`` until the first
        aggregation after the restore. A checkpoint taken inside a
        ``BufferedAsync`` run brings back its async state, the pending
        adapters on the session's device, and the run resumes in place."""
        dev = resolve_device(session_kwargs.get("device"))
        tree, meta = store.restore(ckpt_dir, step, device=dev)
        if session_kwargs.get("strategy") is None and meta.get("strategy"):
            session_kwargs["strategy"] = meta["strategy"]
        sess = cls(cfg, scfg, base_params, **session_kwargs)
        sess.global_lora = tree["global_lora"]
        sess.global_head = tree.get("global_head", {})
        sess.ranks = tree["ranks"].cpu().numpy().astype(np.int32)
        sess.rounds_done = int(meta["rounds_done"])
        sess.version = int(meta["version"])
        sess.staleness_log = list(meta.get("staleness_log", []))
        tr = meta.get("target_ranks")
        sess.target_ranks = None if tr is None \
            else {t: int(r) for t, r in tr.items()}
        sess.rng.bit_generator.state = meta["rng_state"]
        cl = meta.get("comm_log")
        if cl:
            sess.comm_log = {k: list(v) for k, v in cl.items()}
        if "async" in tree:
            sess.async_state = cls._unpack_async_state(tree["async"])
        return sess
