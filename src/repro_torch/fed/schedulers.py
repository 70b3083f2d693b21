"""Scheduler policies driving a :class:`~repro_torch.fed.session.FedSession`
(port of ``repro/fed/schedulers.py``).

A scheduler owns when training happens and when the session merges; the
session owns what a merge means (strategy, redistribution, wire
accounting). Three policies:

``SyncRound``      Cohort barrier: sample → broadcast → train the whole
                   cohort → collect → one ``aggregate_round``; with a
                   ``topology`` (``fed/topology.py``) the collect and the
                   merge go through its edge aggregators.

``SemiSync``       Deadline cutoff: the whole cohort is broadcast and
                   trains, but only the clients whose simulated duration
                   (1/speed) beats the deadline are collected and
                   aggregated; the stragglers' work is wasted. With
                   ``deadline=None`` the deadline is a quantile of the
                   population's durations; an infinite one is
                   ``SyncRound``.

``BufferedAsync``  Discrete-event simulation (client ``cid`` finishes every
                   1/speed[cid] time units) with a K-buffer: updates
                   accumulate and the session merges a full buffer in one
                   staleness-discounted engine call (``flush_async``).
                   ``buffer_size=1`` is the legacy event-by-event
                   ``AsyncFedServer.submit``. Its live state sits on
                   ``session.async_state``, so ``save`` can checkpoint a
                   run mid-flight.

All three share the session's redistribution path, so spectrum and
per-target rank adaptation work in every mode. With the session's recorder
on, a round records a ``round{n}`` span on ``fed.rounds`` (and SemiSync a
``deadline_cut`` instant there when it cuts), its training a ``train``
span on ``fed.train``, and an async event a ``train`` span and an
``update_arrival`` instant on the client's own ``fed.client{cid}`` track;
rounds observe ``fed.round_s``. These spans do not block: each ends after
host code whose last device work may still be queued.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.fed.client import join_adapters, split_adapters
from repro_torch.fed.session import AsyncConfig


class Scheduler:
    name = "base"


def _eval_round(history, session, eval_fn, do_eval: bool) -> None:
    if eval_fn is None:
        return
    if do_eval or not history["eval_acc"]:
        m = eval_fn(session.global_lora, session.global_head)
        history["eval_acc"].append(float(m["acc"]))
        history["eval_loss"].append(float(m["loss"]))
    else:
        history["eval_acc"].append(history["eval_acc"][-1])
        history["eval_loss"].append(history["eval_loss"][-1])


@dataclass
class SyncRound(Scheduler):
    """Synchronous cohort rounds (the paper's mode). ``topology`` (a
    :class:`~repro_torch.fed.topology.HierarchicalTopology`) replaces the
    flat collect and aggregate with the two-tier edge-and-root path; ``None``
    is the flat round."""
    name = "sync"

    topology: Optional[object] = None

    def run(self, session, train, data_fn, num_rounds: int,
            eval_fn=None, eval_every: int = 1) -> Dict[str, List]:
        """``train(frozen, trainable, masks, data) -> (trainable, losses)``
        is the cohort trainer; ``data_fn(cohort, rnd)`` returns the
        cohort's stacked batches. The round index continues from
        ``session.rounds_done``."""
        history: Dict[str, List] = {
            "round": [], "train_loss": [], "eval_acc": [], "eval_loss": [],
            "downlink_bytes": [], "uplink_bytes": [], "health": []}
        rec = session.rec
        for i in range(num_rounds):
            rnd = session.rounds_done
            t_rnd = rec.now() if rec.enabled else 0.0
            cohort = session.sample_cohort()
            stacked, heads = session.broadcast_cohort(cohort)
            factors, masks = split_adapters(stacked)
            trainable = {"factors": factors, "head": heads}
            t_tr = rec.now() if rec.enabled else 0.0
            trainable, losses = train(session.base, trainable, masks,
                                      data_fn(cohort, rnd))
            if rec.enabled:
                rec.complete("train", "fed.train", t_tr, rec.now(),
                             round=rnd, cohort=len(cohort))
            trained = join_adapters(trainable["factors"], masks)
            if self.topology is not None:
                self.topology.aggregate(session, cohort, trained,
                                        trainable["head"])
            else:
                tree, up_heads = session.collect_updates(
                    cohort, trained, trainable["head"])
                session.aggregate_round(tree, cohort,
                                        stacked_heads=up_heads)
            if rec.enabled:
                t1 = rec.now()
                rec.complete(f"round{rnd}", "fed.rounds", t_rnd, t1,
                             cohort=len(cohort))
                session.metrics.histogram("fed.round_s").observe(t1 - t_rnd)
            history["round"].append(rnd)
            history["train_loss"].append(float(losses.mean()))
            history["downlink_bytes"].append(session.comm_log["downlink"][-1])
            history["uplink_bytes"].append(session.comm_log["uplink"][-1])
            history["health"].append(session.health_snapshot())
            _eval_round(history, session, eval_fn,
                        rnd % eval_every == 0 or i == num_rounds - 1)
        return history


@dataclass
class SemiSync(Scheduler):
    """Deadline-cutoff semi-synchronous rounds (straggler mitigation)."""
    name = "semisync"

    speeds: np.ndarray = None          # per-client relative speed
    deadline: Optional[float] = None   # None -> quantile of 1/speeds
    deadline_quantile: float = 0.75

    def resolved_deadline(self) -> float:
        if self.deadline is not None:
            return float(self.deadline)
        return float(np.quantile(1.0 / np.asarray(self.speeds, np.float64),
                                 self.deadline_quantile))

    def run(self, session, train, data_fn, num_rounds: int,
            eval_fn=None, eval_every: int = 1) -> Dict[str, List]:
        """As :meth:`SyncRound.run`; the history adds ``stragglers`` and
        ``round_time`` (simulated) a round, and the byte columns count the
        survivors' uplink only."""
        speeds = np.asarray(self.speeds, np.float64)
        deadline = self.resolved_deadline()
        history: Dict[str, List] = {
            "round": [], "train_loss": [], "eval_acc": [], "eval_loss": [],
            "downlink_bytes": [], "uplink_bytes": [], "stragglers": [],
            "round_time": [], "health": []}
        rec = session.rec
        for i in range(num_rounds):
            rnd = session.rounds_done
            t_rnd = rec.now() if rec.enabled else 0.0
            cohort = session.sample_cohort()
            durations = 1.0 / speeds[cohort]
            keep = durations <= deadline
            if not keep.any():                 # never stall a round
                keep[np.argmin(durations)] = True
            if rec.enabled and not keep.all():
                rec.instant("deadline_cut", "fed.rounds", round=rnd,
                            stragglers=int((~keep).sum()),
                            deadline=deadline)
            stacked, heads = session.broadcast_cohort(cohort)
            factors, masks = split_adapters(stacked)
            trainable = {"factors": factors, "head": heads}
            t_tr = rec.now() if rec.enabled else 0.0
            trainable, losses = train(session.base, trainable, masks,
                                      data_fn(cohort, rnd))
            if rec.enabled:
                rec.complete("train", "fed.train", t_tr, rec.now(),
                             round=rnd, cohort=len(cohort))
            trained = join_adapters(trainable["factors"], masks)
            idx = np.flatnonzero(keep)
            pick = torch.from_numpy(idx).to(losses.device)
            sub_tree = {t: {leaf: ad[leaf][pick]
                            for leaf in ("A", "B", "mask")}
                        for t, ad in trained.items()}
            sub_heads = None if not trainable["head"] else {
                k: v[pick] for k, v in trainable["head"].items()}
            tree, up_heads = session.collect_updates(
                cohort[idx], sub_tree, sub_heads)
            session.aggregate_round(tree, cohort[idx],
                                    stacked_heads=up_heads)
            history["round"].append(rnd)
            history["train_loss"].append(float(losses[pick].mean()))
            history["downlink_bytes"].append(session.comm_log["downlink"][-1])
            history["uplink_bytes"].append(session.comm_log["uplink"][-1])
            history["stragglers"].append(int((~keep).sum()))
            session.metrics.counter("fed.stragglers").inc(
                int((~keep).sum()))
            # the server closes the round when every survivor is in: at
            # durations.max() if nobody was cut, else at the deadline,
            # unless the force-kept fastest itself finishes after it
            round_time = (float(durations.max()) if keep.all()
                          else float(max(deadline, durations[keep].max())))
            history["round_time"].append(round_time)
            # simulated time, no clock read: always on
            session.metrics.histogram("fed.round_time_sim").observe(
                round_time)
            if rec.enabled:
                t1 = rec.now()
                rec.complete(f"round{rnd}", "fed.rounds", t_rnd, t1,
                             cohort=len(cohort),
                             stragglers=int((~keep).sum()))
                session.metrics.histogram("fed.round_s").observe(t1 - t_rnd)
            history["health"].append(session.health_snapshot())
            _eval_round(history, session, eval_fn,
                        rnd % eval_every == 0 or i == num_rounds - 1)
        return history


@dataclass
class BufferedAsync(Scheduler):
    """K-buffered staleness-discounted asynchronous merging.

    ``acfg=None`` uses the session's own staleness policy; an explicit
    AsyncConfig here applies only inside ``run``.

    The live event heap, pending adapters and K-buffer are installed on
    ``session.async_state`` and mutated in place, so ``session.save()`` can
    checkpoint a run mid-flight and a restored session resumes the event
    sequence exactly. A run cold-starts only when the session carries no
    async state. ``drain=False`` leaves a partial buffer unflushed at the
    end of ``run``, which makes a split run (run → save → restore → run)
    equal one uninterrupted run."""
    name = "buffered_async"

    speeds: np.ndarray = None
    buffer_size: int = 1
    acfg: Optional[AsyncConfig] = None
    drain: bool = True

    def run(self, session, local_train, data_fn, num_events: int,
            eval_fn=None, eval_every: Optional[int] = None
            ) -> Dict[str, List]:
        """Discrete-event loop: each client trains for 1/speed time units
        and completions are processed in arrival order. ``local_train`` is
        the single-client trainer, ``data_fn(cid)`` one client's batches;
        ``eval_every`` (in events) adds eval_acc / eval_loss rows."""
        prev_acfg = session.acfg
        if self.acfg is not None:
            session.acfg = self.acfg
        try:
            return self._run(session, local_train, data_fn, num_events,
                             eval_fn, eval_every)
        finally:
            session.acfg = prev_acfg

    def _run(self, session, local_train, data_fn, num_events,
             eval_fn, eval_every) -> Dict[str, List]:
        speeds = np.asarray(self.speeds, np.float64)
        n = session.scfg.num_clients
        if session.async_state is None:
            # (finish time, cid, version): Python floats and ints, so that
            # ties break as in the reference
            heap: List[Tuple[float, int, int]] = []
            pending: Dict[int, Dict] = {}
            buffer: List = []
            for cid in range(n):
                ad, ver = session.adapter_for(cid)
                pending[cid] = ad
                heapq.heappush(heap, (1.0 / speeds[cid], cid, ver))
            session.async_state = {"heap": heap, "pending": pending,
                                   "buffer": buffer}
        else:
            # resume mid-flight (a restored checkpoint or a previous run's
            # live state): the heap list is already heap-ordered
            st = session.async_state
            heap, pending, buffer = st["heap"], st["pending"], st["buffer"]
        history: Dict[str, List] = {
            "time": [], "staleness": [], "accepted": [], "flush_events": [],
            "downlink_bytes": [], "uplink_bytes": [],
            "eval_acc": [], "eval_loss": [], "health": []}
        comm_seen = {k: sum(v) for k, v in session.comm_log.items()}

        def flush():
            if not buffer:
                return
            flags = session.flush_async(buffer)
            history["staleness"].extend(
                session.staleness_log[-len(buffer):])
            history["accepted"].extend(flags)
            history["flush_events"].append(len(buffer))
            history["health"].append(session.health_snapshot())
            buffer.clear()

        rec = session.rec
        for step in range(num_events):
            t_now, cid, ver = heapq.heappop(heap)
            factors, masks = split_adapters(pending[cid])
            trainable = {"factors": factors, "head": session.global_head}
            t_tr = rec.now() if rec.enabled else 0.0
            trained, _loss = local_train(session.base, trainable, masks,
                                         data_fn(cid))
            if rec.enabled:
                # one track per client: training bursts and arrivals line
                # up against the server's flush spans
                track = f"fed.client{cid}"
                rec.complete("train", track, t_tr, rec.now(),
                             version=int(ver), t_sim=float(t_now))
                rec.instant("update_arrival", track, version=int(ver),
                            staleness=int(session.version - ver))
            buffer.append(session.make_update(
                cid, join_adapters(trained["factors"], masks), ver,
                head=trained["head"]))
            if len(buffer) >= self.buffer_size:
                flush()
            history["time"].append(t_now)
            if eval_fn is not None and eval_every and \
                    (step % eval_every == 0 or step == num_events - 1):
                m = eval_fn(session.global_lora, session.global_head)
                history["eval_acc"].append(float(m["acc"]))
                history["eval_loss"].append(float(m["loss"]))
            ad, ver = session.adapter_for(cid)
            pending[cid] = ad
            heapq.heappush(heap, (t_now + 1.0 / speeds[cid], cid, ver))
            # measured wire bytes this event (the uplink update and the
            # fresh re-broadcast; the cold broadcasts to every client
            # before the loop are left out here but counted in
            # session.comm_totals())
            for key, col in (("downlink", "downlink_bytes"),
                             ("uplink", "uplink_bytes")):
                tot = sum(session.comm_log[key])
                history[col].append(tot - comm_seen[key])
                comm_seen[key] = tot
        if self.drain:
            flush()                              # drain a partial buffer
        return history
