"""Hierarchical two-tier aggregation: edge aggregators and a root session
(port of ``repro/fed/topology.py``).

Clients upload to their edge aggregator, edges forward to the root, the
root merges. Both tiers drive the session's strategy and engine and the
measured wire format; the topology plugs into ``SyncRound(topology=...)``
and calls only session methods.

Two edge modes:

``stack``   (default, lossless) Each edge concentrates its clients'
            serialized ``ClientUpdate``s into one ``EdgeAggregate``,
            verbatim. The root reassembles the per-client trees in cohort
            order and runs the unchanged flat ``aggregate_round``, so the
            result is bit for bit the flat round's: the same bytes in, the
            same stacked tree, the same engine call. Edge→root bytes are
            the clients' bytes plus one small header an edge.

``engine``  Each edge merges its clients with the session's strategy and
            engine at edge-local weights ``n_i/n_e`` and ships one
            pre-merged r_max update (encoded by the session's codec); the
            root merges the edge aggregates at ``n_e/Σn_e`` through
            ``aggregate_round(weights=)``. The nested weighted mean is the
            flat one, so naive matches the flat round to float tolerance,
            while reconstruct+SVD strategies get the hierarchical
            approximation. The edge merges pass no generator to the engine
            (its fixed default, as ``flush_async``'s merge), as the
            reference passes no key; the root draws from the session rng as
            the flat round does, so the session's stream stays aligned.

Wire accounting goes through the session's ``_log_comm``: client→edge
bytes land as one ``uplink`` row (the flat round's row), each edge→root
message under ``edge<i>_uplink`` on its own ``fed.edge<i>`` track, with
``edge_forward`` / ``edge_merge`` spans there while recording.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from repro_torch.fed import messages as msg_lib


@dataclass
class HierarchicalTopology:
    """Two-tier edge-and-root aggregation plan for one sync round."""

    num_edges: int = 2
    #: how cohort members map to edges: ``contiguous`` (array_split),
    #: ``round_robin`` (position modulo E), ``hash`` (client id modulo E,
    #: stable across rounds, like a geographic assignment)
    assignment: str = "contiguous"
    edge_mode: str = "stack"        # stack | engine

    def __post_init__(self):
        if self.num_edges < 1:
            raise ValueError(f"num_edges must be >= 1, got {self.num_edges}")
        if self.assignment not in ("contiguous", "round_robin", "hash"):
            raise ValueError(f"unknown assignment {self.assignment!r}")
        if self.edge_mode not in ("stack", "engine"):
            raise ValueError(f"unknown edge_mode {self.edge_mode!r}")

    def assign(self, cohort: np.ndarray) -> List[np.ndarray]:
        """Partition cohort positions (indices into the cohort array) into
        per-edge groups; every position lands in exactly one edge."""
        pos = np.arange(len(cohort))
        if self.assignment == "contiguous":
            return [np.asarray(g) for g in np.array_split(pos,
                                                          self.num_edges)]
        if self.assignment == "round_robin":
            return [pos[e::self.num_edges] for e in range(self.num_edges)]
        cids = np.asarray(cohort, np.int64)
        return [pos[cids % self.num_edges == e]
                for e in range(self.num_edges)]

    # -- the round's collect and aggregate, in place of the flat path -------

    def aggregate(self, session, cohort: np.ndarray, trained_tree,
                  trained_heads=None) -> None:
        """Collect the trained cohort through the two-tier wire path and
        run the root merge (``collect_updates`` + ``aggregate_round``, bit
        for bit, in 'stack' mode)."""
        cohort = np.asarray(cohort)
        groups = self.assign(cohort)
        if self.edge_mode == "stack":
            self._aggregate_stack(session, cohort, groups, trained_tree,
                                  trained_heads)
        else:
            self._aggregate_engine(session, cohort, groups, trained_tree,
                                   trained_heads)

    @staticmethod
    def _slice_client(trained_tree, trained_heads, i: int):
        sl = {t: {leaf: ad[leaf][i] for leaf in ("A", "B", "mask")}
              for t, ad in trained_tree.items()}
        h = None if trained_heads is None else \
            {k: v[i] for k, v in trained_heads.items()}
        return sl, h

    def _aggregate_stack(self, session, cohort, groups, trained_tree,
                         trained_heads) -> None:
        rec = session.rec
        if not session.track_comm:
            for e, pos in enumerate(groups):
                session._log_comm(f"edge{e}_uplink", 0,
                                  track=f"fed.edge{e}")
            session._log_comm("uplink", 0)
            session.aggregate_round(trained_tree, cohort,
                                    stacked_heads=trained_heads)
            return
        r_max = session.cfg.lora.r_max
        k = len(cohort)
        per_client: List = [None] * k
        heads: List = [None] * k
        uplink_total = 0
        with rec.span("collect", "fed.server", cohort=k,
                      edges=len(groups)):
            for e, pos in enumerate(groups):
                if len(pos) == 0:
                    continue
                track = f"fed.edge{e}"
                t0 = rec.now() if rec.enabled else 0.0
                updates = []
                for i in pos:
                    sl, h = self._slice_client(trained_tree, trained_heads,
                                               int(i))
                    updates.append(session.make_update(
                        int(cohort[i]), sl, session.version, h, log=False))
                uplink_total += sum(u.num_bytes for u in updates)
                agg = msg_lib.EdgeAggregate(edge_id=e, updates=updates)
                rt = msg_lib.EdgeAggregate.from_bytes(agg.to_bytes())
                session._log_comm(f"edge{e}_uplink", agg.num_bytes,
                                  track=track)
                if rec.enabled:
                    rec.complete("edge_forward", track, t0, rec.now(),
                                 clients=len(pos), bytes=agg.num_bytes)
                # per-client trees in cohort order: the flat
                # collect_updates' inputs to the stacking
                for i, upd in zip(pos, rt.updates):
                    tree, head = upd.unpack(r_max, session.device)
                    per_client[int(i)] = tree
                    heads[int(i)] = head
            session._log_comm("uplink", uplink_total)
        out, heads_st = session._stack_clients(per_client, heads)
        session.aggregate_round(
            out, cohort,
            stacked_heads=(heads_st or None)
            if trained_heads is not None else None)

    def _aggregate_engine(self, session, cohort, groups, trained_tree,
                          trained_heads) -> None:
        rec = session.rec
        r_max = session.cfg.lora.r_max
        dev = session.device
        edge_trees, edge_heads, edge_sizes = [], [], []
        uplink_total = 0
        with rec.span("collect", "fed.server", cohort=len(cohort),
                      edges=len(groups)):
            for e, pos in enumerate(groups):
                if len(pos) == 0:
                    continue
                track = f"fed.edge{e}"
                # client → edge: the flat round's measured per-client
                # updates (one consolidated uplink row)
                per, hds = [], []
                for i in pos:
                    sl, h = self._slice_client(trained_tree, trained_heads,
                                               int(i))
                    if session.track_comm:
                        upd = msg_lib.ClientUpdate.from_bytes(
                            session.make_update(int(cohort[i]), sl,
                                                session.version, h,
                                                log=False).to_bytes())
                        uplink_total += upd.num_bytes
                        tree, head = upd.unpack(r_max, dev)
                    else:
                        tree, head = sl, (h or {})
                    per.append(tree)
                    hds.append(head)
                tree_e, heads_e = session._stack_clients(per, hds)
                sub = cohort[np.asarray(pos)]
                n_e = session.client_sizes[sub].astype(np.float64)
                eta_e = torch.tensor(n_e / n_e.sum(), dtype=torch.float32,
                                     device=dev)
                t0 = rec.now() if rec.enabled else 0.0
                full = {t: torch.ones_like(ad["mask"][:1])
                        for t, ad in tree_e.items()}
                out, _spec = session.engine(
                    tree_e, eta_e, session.cfg.lora.alpha,
                    **session.strategy.engine_kwargs(), new_masks=full)
                merged = {t: {"A": ad["A"][0], "B": ad["B"][0],
                              "mask": ad["mask"][0]}
                          for t, ad in out.items()}
                head_m = {k: torch.tensordot(eta_e, x.float(),
                                             dims=1).to(x.dtype)
                          for k, x in heads_e.items()}
                if session.track_comm:
                    # edge → root: one pre-merged r_max update an edge
                    upd_e = msg_lib.ClientUpdate(
                        client_id=e, start_version=session.version,
                        num_examples=int(n_e.sum()),
                        adapter=msg_lib.truncate_adapter(
                            merged, {t: r_max for t in merged}),
                        head=head_m, codec=session.codec)
                    rt = msg_lib.ClientUpdate.from_bytes(upd_e.to_bytes())
                    session._log_comm(f"edge{e}_uplink", rt.num_bytes,
                                      track=track)
                    tree_r, head_r = rt.unpack(r_max, dev)
                else:
                    session._log_comm(f"edge{e}_uplink", 0, track=track)
                    tree_r, head_r = merged, head_m
                if rec.enabled:
                    rec.complete("edge_merge", track, t0, rec.now(),
                                 clients=len(pos),
                                 examples=int(n_e.sum()))
                edge_trees.append(tree_r)
                edge_heads.append(head_r)
                edge_sizes.append(float(n_e.sum()))
            session._log_comm("uplink", uplink_total)
        w = np.asarray(edge_sizes, np.float64)
        out, heads_st = session._stack_clients(edge_trees, edge_heads)
        session.aggregate_round(
            out, cohort,
            stacked_heads=(heads_st or None)
            if trained_heads is not None else None,
            weights=w / w.sum())
