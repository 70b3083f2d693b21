"""Scheduler policies driving a :class:`~repro_torch.fed.session.FedSession`
(port of ``repro/fed/schedulers.py``: ``SyncRound``, the paper's mode).

A scheduler owns when training happens and when the session merges; the
session owns what a merge means (strategy, redistribution, wire
accounting). ``SyncRound`` is the cohort barrier: sample → broadcast →
train the whole cohort → collect → one ``aggregate_round``. With the
session's recorder on, each round records a ``round{n}`` span on
``fed.rounds`` and a ``train`` span on ``fed.train`` (the server's phases
record on ``fed.server``), and observes ``fed.round_s``. These spans do
not block: the round's span ends after the aggregation's host code, whose
last device work may still be queued.

Not ported yet: ``SemiSync``, ``BufferedAsync`` and ``SyncRound``'s
two-tier ``topology``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.fed.client import join_adapters, split_adapters


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
    """Synchronous cohort rounds (the paper's mode). ``topology`` (the
    reference's two-tier edge/root aggregation) is not ported: only
    ``None``, the flat round, is taken."""
    name = "sync"

    topology: Optional[object] = None

    def __post_init__(self):
        if self.topology is not None:
            raise NotImplementedError(
                "SyncRound(topology=...) is not ported yet (fed/topology.py)")

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
            tree, up_heads = session.collect_updates(
                cohort, trained, trainable["head"])
            session.aggregate_round(tree, cohort, stacked_heads=up_heads)
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
