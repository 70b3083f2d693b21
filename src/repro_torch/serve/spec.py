"""Speculative-decoding drafters, the cheap half of draft-verify (port of
``repro/serve/spec.py``).

The engine's speculative path (``ServeEngine(drafter=...)``) is lossless
by construction: whatever a drafter proposes, the verify step scores every
draft position under the target model and commits only the longest prefix
that equals the target's own greedy tokens, plus the target's next token.
A drafter therefore needs no quality guarantee, only a
``propose(engine, active) -> (len(active), spec_k) int32`` method.

``SelfDrafter`` runs only the first ``draft_layers`` layers of the
engine's own decode step (each row through its own adapter) and reads
logits from the shared head. It reads committed positions through the
page table like decode, and its own K/V lands in exactly the slots the
verify step overwrites.

``NGramDrafter`` matches the row's trailing n-gram against its own
history (prompt + output) and proposes what followed the most recent
earlier occurrence: host work only.

``ScriptedDrafter`` proposes from per-request token scripts: the true
continuation forces acceptance, garbage forces rejection.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class SelfDrafter:
    """Shallow layer-subset self-draft over the paged cache.

    ``propose`` runs up to ``spec_k`` sequential ``draft_layers``-deep
    decode steps for the whole batch. A drafter binds to the first engine
    it drafts for and refuses any other."""

    def __init__(self, draft_layers: int = 1):
        if draft_layers < 1:
            raise ValueError(f"draft_layers must be >= 1, got "
                             f"{draft_layers}")
        self.draft_layers = int(draft_layers)
        self._engine = None

    def _bind(self, engine) -> None:
        if self._engine is engine:
            return
        if self._engine is not None:
            raise RuntimeError("SelfDrafter is bound to another engine: "
                               "make one per engine")
        if self.draft_layers > engine.cfg.num_layers:
            raise ValueError(
                f"draft_layers {self.draft_layers} exceeds model depth "
                f"{engine.cfg.num_layers}")
        self._engine = engine

    def propose(self, engine, active) -> np.ndarray:
        self._bind(engine)
        props = np.zeros((len(active), engine.spec_k), np.int32)
        # the engine discards proposals past each row's window
        # (min(spec_k, remaining - 1)): draft no column no row can use
        k_use = max((engine._spec_window(req) for _, req in active),
                    default=0)
        if k_use == 0:
            return props
        cur = np.zeros((engine.max_batch, 1), np.int32)
        pos = np.zeros((engine.max_batch,), np.int32)
        idx = np.zeros((engine.max_batch,), np.int32)
        lens = np.zeros((engine.max_batch,), np.int32)
        for i, req in active:
            cur[i, 0] = req["out"][-1]
            pos[i] = req["t"]
            idx[i] = req["slot"]
            lens[i] = req["t"] + 1
        alive = (lens > 0).astype(np.int32)
        dev = engine._to_device
        tables, idx_d = dev(engine.kv.tables), dev(idx)
        for step in range(k_use):
            logits = engine._decode_step(tables, idx_d, dev(cur), dev(pos),
                                         dev(lens), layers=self.draft_layers)
            nxt = logits.argmax(dim=-1).int().cpu().numpy()
            for j, (i, _) in enumerate(active):
                props[j, step] = nxt[i]
            cur = nxt[:, None].copy()
            pos = pos + alive
            lens = lens + alive
        return props


class NGramDrafter:
    """Prompt-lookup drafting: propose the continuation of the most recent
    earlier occurrence of the row's trailing ``n``-gram in its own prompt
    and output; repeat the last token when there is none (a wrong draft
    costs nothing)."""

    def __init__(self, n: int = 2):
        if n < 1:
            raise ValueError(f"n must be >= 1, got {n}")
        self.n = int(n)

    def propose(self, engine, active) -> np.ndarray:
        k = engine.spec_k
        props = np.zeros((len(active), k), np.int32)
        for j, (_, req) in enumerate(active):
            hist = np.concatenate([np.asarray(req["prompt"], np.int32),
                                   np.asarray(req["out"], np.int32)])
            props[j] = self._lookup(hist, k)
        return props

    def _lookup(self, hist: np.ndarray, k: int) -> np.ndarray:
        out = np.full((k,), int(hist[-1]), np.int32)
        n = self.n
        if hist.size <= n:
            return out
        tail = hist[-n:]
        for start in range(hist.size - n - 1, -1, -1):
            if (hist[start:start + n] == tail).all():
                follow = hist[start + n:start + n + k]
                out[:follow.size] = follow
                break
        return out


class ScriptedDrafter:
    """Proposes from per-request scripts of future output tokens, indexed
    by the tokens already generated: ``set(uid, script)`` with the
    request's true greedy continuation forces acceptance, a never-matching
    script forces rejection. Rows without a script propose zeros."""

    def __init__(self, scripts: Optional[Dict[str, np.ndarray]] = None):
        self.scripts: Dict[str, np.ndarray] = {}
        for uid, toks in (scripts or {}).items():
            self.set(uid, toks)

    def set(self, uid: str, tokens) -> None:
        self.scripts[uid] = np.asarray(tokens, np.int32).reshape(-1)

    def propose(self, engine, active) -> np.ndarray:
        k = engine.spec_k
        props = np.zeros((len(active), k), np.int32)
        for j, (_, req) in enumerate(active):
            script = self.scripts.get(req["uid"])
            if script is None:
                continue
            done = len(req["out"])
            nxt = script[done:done + k]
            props[j, :nxt.size] = nxt
        return props
