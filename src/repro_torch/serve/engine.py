"""Multi-tenant serving engine: continuous batching over per-request LoRA,
with a paged KV cache, chunked prefill and lossless speculative decode
(port of the paged path of ``repro/serve/engine.py``).

One decode step serves the whole batch. Each of the ``max_batch`` request
rows carries its own adapter-slot index into the registry slabs; inside
every layer the LoRA path is the BGMV gather

    y[i] = x[i] @ W0 + scale[idx[i]] · (x[i] @ A[idx[i]]) @ B[idx[i]]

(``ops.bgmv``). KV state is paged (``serve/pages.py``): admission is
gated by free pages, a decode that crosses a page boundary extends the
row's page list, and the youngest rows are preempted (re-queued and
replayed; greedy decode is deterministic) when an extension cannot be
met. Decode attention reads pages through the table
(``ops.paged_attention``). Prefill is chunked: ``prefill_chunk`` prompt
tokens at a time through ``ops.flash_attention`` at absolute offset
``pos0``, writing K/V straight into the row's pages; padded chunk tails
write to the pool's trash page.

Speculative decode (``drafter=``, ``serve/spec.py``): a drafter proposes
up to ``spec_k`` tokens per row, one verify step scores the context token
and every draft through ``ops.paged_verify_attention`` (per-row causal
frontier over the pages), and each row commits the longest prefix of
drafts equal to the model's own greedy tokens plus the model's next token,
so the tokens are those of plain decode whatever the drafter proposes.
Pages past a row's next write position go back to the pool after every
dispatch (``PagedKV.truncate``).

The reference scans layers with ``lax.scan`` inside jitted steps; here
the steps are eager PyTorch with a Python loop over layers, and the
kernel launch counters in ``kernels/ops.py`` show which path ran. The KV
pools are updated in place (``pool[page, slot] = k``) where the reference
rebuilt them with ``.at[].set``.
"""
from __future__ import annotations

import math
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.common import _act, rope, sinusoidal_positions
from repro_torch.models.transformer import layer_slice, norm
from repro_torch.obs import MetricsRegistry
from repro_torch.serve.pages import PagedKV


def _counter_view(suffix: str):
    """Property exposing a registry counter as a plain int attribute,
    prefixed by the engine's ``name``."""
    def _get(self):
        return self.metrics.counter(f"{self.name}.{suffix}").value

    def _set(self, v):
        self.metrics.counter(f"{self.name}.{suffix}").value = int(v)

    return property(_get, _set)


def _gauge_view(suffix: str):
    def _get(self):
        return self.metrics.gauge(f"{self.name}.{suffix}").value

    def _set(self, v):
        self.metrics.gauge(f"{self.name}.{suffix}").set(int(v))

    return property(_get, _set)


def _apply_slab_lora(x, w0, slab, idx, alpha):
    """x: (B, S, d_in) -> x @ W0 + per-row gathered LoRA delta.

    S == 1 (decode) goes through the BGMV kernel; S > 1 (chunked prefill,
    batch 1) uses the gather-einsum, one adapter gather for the chunk."""
    y = x @ w0
    if slab is None:
        return y
    a, b, m = slab["A"], slab["B"], slab["mask"]     # (S,d,r) (S,r,o) (S,r)
    am = a * m[:, None, :]                            # dead directions -> 0
    scale = alpha / torch.clamp(m.sum(-1), min=1.0)   # (S,)
    if x.shape[1] == 1:
        lo = ops.bgmv(x[:, 0, :], am, b, idx)[:, None, :]
    else:
        i = idx.long()
        lo = torch.einsum("bsr,bro->bso",
                          torch.einsum("bsd,bdr->bsr", x, am[i]), b[i])
    return y + (scale[idx.long()][:, None, None] * lo).to(y.dtype)


def _layer_qkv(x, lp, slab, idx, pos, cfg: ModelConfig):
    """norm -> q/k/v projections with per-row LoRA -> heads + RoPE.
    x: (B, S, d), pos: (B, S) absolute positions."""
    alpha = cfg.lora.alpha
    bsz, s, _ = x.shape
    hd = cfg.resolved_head_dim
    ap = lp["attn"]
    h = norm(x, lp["ln1"])
    q = _apply_slab_lora(h, ap["wq"], slab.get("q"), idx, alpha)
    k = _apply_slab_lora(h, ap["wk"], slab.get("k"), idx, alpha)
    v = _apply_slab_lora(h, ap["wv"], slab.get("v"), idx, alpha)
    if cfg.use_bias:
        q, k, v = q + ap["bq"], k + ap["bk"], v + ap["bv"]
    q = q.reshape(bsz, s, cfg.num_heads, hd)
    k = k.reshape(bsz, s, cfg.num_kv_heads, hd)
    v = v.reshape(bsz, s, cfg.num_kv_heads, hd)
    if cfg.rope_theta > 0:
        q = rope(q, pos, cfg.rope_theta)
        k = rope(k, pos, cfg.rope_theta)
    return h, q, k, v


def _layer_out(x, o, lp, slab, idx, cfg: ModelConfig):
    """Attention output projection + residual + LoRA'd MLP block."""
    alpha = cfg.lora.alpha
    ap = lp["attn"]
    y = _apply_slab_lora(o, ap["wo"], slab.get("o"), idx, alpha)
    if cfg.use_bias and "bo" in ap:
        y = y + ap["bo"]
    x = x + y
    h2 = norm(x, lp["ln2"])
    mp = lp["mlp"]
    u = _apply_slab_lora(h2, mp["w1"], slab.get("w1"), idx, alpha)
    if cfg.use_bias and "b1" in mp:
        u = u + mp["b1"]
    u = _act(cfg.activation)(u)
    if "w3" in mp:
        u = u * _apply_slab_lora(h2, mp["w3"], slab.get("w3"), idx, alpha)
    y = _apply_slab_lora(u, mp["w2"], slab.get("w2"), idx, alpha)
    if cfg.use_bias and "b2" in mp:
        y = y + mp["b2"]
    return x + y


def _layer_decode_paged(x, lp, slab, lc, idx, pos, lens, page, slot, tables,
                        cfg: ModelConfig, page_size: int):
    """One token through one layer against the paged pool.
    page/slot: (B,) write targets (trash for inactive rows); tables: (B, P)
    page tables; lens: (B,) valid tokens including this one."""
    bsz = x.shape[0]
    _, q, k, v = _layer_qkv(x, lp, slab, idx, pos[:, None], cfg)
    lc["k"][page, slot] = k[:, 0]       # in place: the reference used .at[].set
    lc["v"][page, slot] = v[:, 0]
    o = ops.paged_attention(q[:, 0], lc["k"], lc["v"], tables, lens,
                            page_size=page_size)
    o = o.reshape(bsz, 1, cfg.num_heads * cfg.resolved_head_dim)
    return _layer_out(x, o, lp, slab, idx, cfg)


def _layer_verify_paged(x, lp, slab, lc, idx, tpos, lens, page, slot, tables,
                        pos0, cfg: ModelConfig, page_size: int):
    """A window of S speculative tokens per row through one layer.
    x: (B, S, d); tpos: (B, S) absolute positions (pos0[b] + i);
    page/slot: (B, S) write targets (tail tokens past the window and
    inactive rows -> trash); tables: (B, P); lens: (B,) valid tokens
    including the window (0 for inactive rows); pos0: (B,) window start,
    the per-row causal frontier of the multi-token paged read."""
    bsz, s, _ = x.shape
    _, q, k, v = _layer_qkv(x, lp, slab, idx, tpos, cfg)
    lc["k"][page, slot] = k             # in place; several rows may write
    lc["v"][page, slot] = v             # trash, which is never read unmasked
    o = ops.paged_verify_attention(q, lc["k"], lc["v"], tables, lens, pos0,
                                   page_size=page_size)
    o = o.reshape(bsz, s, cfg.num_heads * cfg.resolved_head_dim)
    return _layer_out(x, o, lp, slab, idx, cfg)


def _layer_prefill_paged(x, lp, slab, lc, idx, tpos, page, slot, table_row,
                         pos0: int, cfg: ModelConfig, page_size: int):
    """A chunk of one row's prompt through one layer. x: (1, C, d); tpos:
    (1, C) absolute positions; page/slot: (C,) write targets (padded tail
    tokens -> trash page); table_row: (1, P)."""
    c = x.shape[1]
    hd = cfg.resolved_head_dim
    _, q, k, v = _layer_qkv(x, lp, slab, idx, tpos, cfg)
    lc["k"][page, slot] = k[0]
    lc["v"][page, slot] = v[0]
    p = table_row.shape[1]
    rows = table_row.long()
    kk = lc["k"][rows].reshape(1, p * page_size, cfg.num_kv_heads, hd)
    vv = lc["v"][rows].reshape(1, p * page_size, cfg.num_kv_heads, hd)
    # Causal at absolute offset pos0: stale and trash slots all sit at
    # positions past the chunk's last valid query, so the causal mask
    # alone excludes them. KV heads stay shared: no repeat copy.
    o = ops.flash_attention(q, kk, vv, causal=True, q_offset=pos0)
    o = o.reshape(1, c, cfg.num_heads * hd)
    return _layer_out(x, o, lp, slab, idx, cfg)


class ServeEngine:
    """Continuous-batching multi-LoRA greedy decoder over a paged KV cache.

    ``max_batch`` request rows share one decode step; each request's
    capacity is ``ceil((prompt + max_new) / page_size)`` pages, admission
    waits for free pages, decode extends page lists in place, and prompt
    prefill runs ``prefill_chunk`` tokens per dispatch. Greedy sampling;
    the scheduler is host-side (admission, paging, preemption, token
    routing, finish/recycle), everything per-token is on the device.

    With a ``drafter`` (``serve/spec.py``) every step is one draft-verify
    dispatch over windows of ``spec_k + 1`` tokens; the tokens are those
    of plain decode.

    ``device=None`` means CUDA; the params and the registry must live on
    the engine's device. ``kv_mode="dense"``, ``mesh=`` and any dtype but
    float32 (params, registry, ``cache_dtype``) are not ported yet and
    raise ``NotImplementedError``.
    """

    def __init__(self, params, cfg: ModelConfig, registry, *,
                 max_batch: int = 8, max_seq: int = 128,
                 kv_mode: str = "paged", page_size: int = 8,
                 num_pages: Optional[int] = None, prefill_chunk: int = 16,
                 drafter=None, spec_k: int = 4, mesh=None,
                 cache_dtype=torch.float32,
                 metrics: Optional[MetricsRegistry] = None,
                 name: str = "serve", device=None):
        if cfg.arch_type != "dense" or cfg.num_experts:
            raise NotImplementedError(
                f"serving supports the dense transformer family, got "
                f"{cfg.arch_type!r}")
        if kv_mode != "paged":
            raise NotImplementedError(f"kv_mode={kv_mode!r} is not ported")
        if drafter is not None and spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        if mesh is not None:
            raise NotImplementedError("mesh-sharded serving is not ported")
        # The kernels take one dtype for all float operands, and only
        # float32 serving has been held against the oracle on the card.
        dtypes = {"params": params.embed.dtype, "registry": registry.dtype,
                  "cache_dtype": cache_dtype}
        if any(dt != torch.float32 for dt in dtypes.values()):
            raise NotImplementedError(f"only float32 serving is ported, got "
                                      f"{dtypes}")
        self.device = resolve_device(device)
        for what, dev in (("params", params.embed.device),
                          ("registry", registry.device)):
            if dev != self.device:
                raise ValueError(f"{what} live on {dev}, the engine on "
                                 f"{self.device}")
        self.params = params
        self.cfg = cfg
        self.registry = registry
        self.max_batch = int(max_batch)
        self.max_seq = int(max_seq)
        self.drafter = drafter
        self.spec_k = int(spec_k)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.name = str(name)
        self.page_size = int(page_size)
        pages_per_row = -(-self.max_seq // self.page_size)
        if num_pages is None:
            num_pages = self.max_batch * pages_per_row
        self.kv = PagedKV(cfg.num_layers, int(num_pages), self.page_size,
                          pages_per_row, self.max_batch, cfg.num_kv_heads,
                          cfg.resolved_head_dim, dtype=cache_dtype,
                          device=self.device, metrics=self.metrics,
                          name=f"{self.name}.pages")
        self.prefill_chunk = max(1, int(prefill_chunk))
        # Per-layer views, made once: weights, slabs and pools are only
        # ever written in place, so the views stay current.
        L = cfg.num_layers
        self._layers = [params.layer(i) for i in range(L)]
        self._slabs = [layer_slice(registry.slabs(), i) for i in range(L)]
        self._pools = [{n: pool[i] for n, pool in self.kv.pools.items()}
                       for i in range(L)]
        self._final_norm = params.final_norm.as_dict()
        self._queue: deque = deque()
        self._rows: List[Optional[dict]] = [None] * self.max_batch
        self._done: Dict[str, np.ndarray] = {}
        self._uid = 0
        self.steps = 0
        self.tokens_generated = 0
        self.prefill_calls = 0
        self.prefill_tokens = 0
        self.deferrals = 0
        self.preemptions = 0
        self.bgmv_groups = 0
        self.spec_dispatches = 0
        self.drafted_tokens = 0
        self.accepted_tokens = 0
        self.rollback_pages = 0

    steps = _counter_view("steps")
    tokens_generated = _counter_view("tokens")
    prefill_calls = _counter_view("prefill_calls")
    prefill_tokens = _counter_view("prefill_tokens")
    deferrals = _counter_view("deferrals")
    preemptions = _counter_view("preemptions")
    bgmv_groups = _gauge_view("bgmv_groups")
    spec_dispatches = _counter_view("spec.dispatches")
    drafted_tokens = _counter_view("spec.drafted")
    accepted_tokens = _counter_view("spec.accepted")
    rollback_pages = _counter_view("spec.rollback_pages")

    # -- introspection ------------------------------------------------------

    def kv_cache_bytes(self) -> int:
        return self.kv.nbytes()

    def row_capacity(self) -> int:
        """Max tokens (prompt + generation) one request may ever hold."""
        return self.kv.row_capacity()

    # -- device steps -------------------------------------------------------

    def _embed(self, tokens: torch.Tensor, pos: torch.Tensor
               ) -> torch.Tensor:
        x = self.params.embed[tokens.long()]                    # (B, S, d)
        if self.cfg.rope_theta == 0:
            x = x * math.sqrt(self.cfg.d_model) + sinusoidal_positions(
                pos, self.cfg.d_model).to(x.dtype)
        return x

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return norm(x, self._final_norm) @ self.params.head()

    @torch.no_grad()
    def _decode_step(self, tables, idx, tokens, pos, lens,
                     layers: Optional[int] = None) -> torch.Tensor:
        """tokens: (B, 1), pos: (B,), lens: (B,) valid tokens including this
        one (0 for inactive rows), tables: (B, P) -> logits (B, V).

        ``layers=d`` runs only the first ``d`` layers before the head (the
        self-draft step). A position past the row's page table writes to
        trash: a draft loop of fixed length can run there near the end of
        a request, and clipping the index instead would alias the write
        onto the row's last live page and corrupt committed KV. Plain
        decode never reaches past the table, so it computes the same."""
        ps = self.page_size
        p = tables.shape[1]
        x = self._embed(tokens, pos[:, None])
        pageidx = (pos // ps).long()
        page = torch.gather(tables, 1,
                            torch.clamp(pageidx, max=p - 1)[:, None])[:, 0]
        page = torch.where((lens > 0) & (pageidx < p), page,
                           self.kv.trash).long()
        slot = (pos % ps).long()
        n = self.cfg.num_layers if layers is None else int(layers)
        for lp, slab, lc in zip(self._layers[:n], self._slabs[:n],
                                self._pools[:n]):
            x = _layer_decode_paged(x, lp, slab, lc, idx, pos, lens, page,
                                    slot, tables, self.cfg, ps)
        return self._logits(x[:, 0, :])

    @torch.no_grad()
    def _verify_step(self, tables, idx, tokens, pos0, nv) -> torch.Tensor:
        """Score a window of S = spec_k + 1 tokens per row (the context
        token and spec_k drafts) in one pass. tokens: (B, S), pos0: (B,)
        window start (where the context token's KV lands), nv: (B,) valid
        tokens in the window (0 for inactive rows), tables: (B, P)
        -> logits (B, S, V). Token i of row b sits at position pos0[b] + i;
        its K/V is written into the row's pages first (tokens past nv go to
        trash), then all S positions attend causally through the pages."""
        ps = self.page_size
        s = tokens.shape[1]
        p = tables.shape[1]
        ar = torch.arange(s, device=self.device)
        tpos = pos0[:, None] + ar[None, :]                       # (B, S)
        x = self._embed(tokens, tpos)
        # Positions past the window may step past the table: clip, then
        # send everything past nv to trash.
        page = torch.gather(tables, 1,
                            torch.clamp(tpos // ps, max=p - 1).long())
        page = torch.where(ar[None, :] < nv[:, None], page,
                           self.kv.trash).long()
        slot = (tpos % ps).long()
        lens = torch.where(nv > 0, pos0 + nv, 0).to(torch.int32)
        for lp, slab, lc in zip(self._layers, self._slabs, self._pools):
            x = _layer_verify_paged(x, lp, slab, lc, idx, tpos, lens, page,
                                    slot, tables, pos0, self.cfg, ps)
        return self._logits(x)

    @torch.no_grad()
    def _prefill_chunk(self, table_row, idx, tokens, pos0: int, nvalid: int
                       ) -> torch.Tensor:
        """One chunk of one row's prompt. table_row: (1, P), idx: (1,),
        tokens: (1, C) -> final hidden states (1, C, d), before the final
        norm; the caller takes logits only where it samples."""
        ps = self.page_size
        c = tokens.shape[1]
        p = table_row.shape[1]
        ar = torch.arange(c, device=self.device)
        tpos = (pos0 + ar)[None, :]                              # (1, C)
        x = self._embed(tokens, tpos)
        page = table_row[0].long()[torch.clamp(tpos[0] // ps, max=p - 1)]
        page = torch.where(ar < nvalid, page, self.kv.trash)
        slot = tpos[0] % ps
        for lp, slab, lc in zip(self._layers, self._slabs, self._pools):
            x = _layer_prefill_paged(x, lp, slab, lc, idx, tpos, page, slot,
                                     table_row, pos0, self.cfg, ps)
        return x

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device)

    # -- scheduler ----------------------------------------------------------

    def submit(self, prompt, adapter_id: str,
               max_new_tokens: int = 16) -> str:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        total = prompt.size + max_new_tokens
        if total > self.row_capacity():
            raise ValueError(
                f"prompt+generation {total} exceeds per-request capacity "
                f"{self.row_capacity()} ({self.kv.pages_for(total)} pages)")
        if not self.registry.has(adapter_id):
            raise KeyError(f"unknown adapter {adapter_id!r}")
        uid = f"req{self._uid}"
        self._uid += 1
        self._queue.append({"uid": uid, "prompt": prompt, "out": [], "t": 0,
                            "max_new": int(max_new_tokens),
                            "adapter": adapter_id})
        return uid

    def _finish(self, row: int, req: dict) -> None:
        self._done[req["uid"]] = np.asarray(req["out"], np.int32)
        self.registry.release(req["adapter"])
        self.kv.release(row)
        self._rows[row] = None

    def _preempt(self, row: int) -> None:
        """Evict a row: free its pages and adapter pin and replay the
        request from scratch later (greedy decode is deterministic)."""
        req = self._rows[row]
        self.registry.release(req["adapter"])
        pages_freed = self.kv.allocated(row)
        self.kv.release(row)
        req.update(t=0, out=[])
        req.pop("slot", None)
        req["_replays"] = req.get("_replays", 0) + 1
        self._queue.appendleft(req)
        self._rows[row] = None
        self.preemptions += 1
        self.metrics.counter(f"{self.name}.replay_pages").inc(pages_freed)

    def _admit(self) -> int:
        admitted = 0
        free_rows = [r for r in range(self.max_batch)
                     if self._rows[r] is None]
        while self._queue and free_rows:
            head = self._queue[0]
            # Page-gated admission: cover the prompt plus the first
            # generated token; later growth extends.
            need = self.kv.pages_for(head["prompt"].size + 1)
            if self.kv.allocator.free_count < need:
                self.deferrals += 1
                break   # FCFS: wait for pages, don't starve the head
            row = free_rows[0]
            try:
                slot = self.registry.acquire(head["adapter"])
            except RuntimeError:
                break   # every slab slot pinned: wait for a release
            free_rows.remove(row)
            req = self._queue.popleft()
            req["slot"] = slot
            self._rows[row] = req
            admitted += 1
            if not self.kv.admit(row, need):   # free_count said yes
                raise RuntimeError(
                    f"page accounting violated: admission of row {row} "
                    f"failed after the free-count check")
            self._prefill_row(row, req)
        return admitted

    def _prefill_row(self, row: int, req: dict) -> None:
        """Chunked prefill: the whole prompt in ceil(len/chunk) dispatches,
        then the first generated token from the last valid position."""
        prompt = req["prompt"]
        c = self.prefill_chunk
        t0 = time.perf_counter()
        idx = torch.full((1,), req["slot"], dtype=torch.int32,
                         device=self.device)
        table_row = self._to_device(self.kv.tables[row:row + 1])
        x, nv = None, 0
        for lo in range(0, prompt.size, c):
            nv = min(c, prompt.size - lo)
            toks = np.zeros((1, c), np.int32)
            toks[0, :nv] = prompt[lo:lo + nv]
            x = self._prefill_chunk(table_row, idx, self._to_device(toks),
                                    lo, nv)
            self.prefill_calls += 1
        self.prefill_tokens += int(prompt.size)
        with torch.no_grad():
            first = int(torch.argmax(self._logits(x[0, nv - 1])))
        self.metrics.histogram(f"{self.name}.prefill_row_s").observe(
            time.perf_counter() - t0)
        req["t"] = int(prompt.size)
        req["out"] = [first]
        self.tokens_generated += 1
        if len(req["out"]) >= req["max_new"]:
            self._finish(row, req)

    def _spec_window(self, req: dict) -> int:
        """Draft tokens worth verifying for this row: never more than the
        request could still commit (a dispatch commits 1..k+1 tokens)."""
        return min(self.spec_k, req["max_new"] - len(req["out"]) - 1)

    def _ensure_pages(self, lookahead: Optional[Dict[int, int]] = None
                      ) -> None:
        """Every active row must own the page its next token lands in,
        plus ``lookahead[row]`` further positions for a speculative
        window, extending, and preempting the youngest other rows when the
        pool is dry."""
        lookahead = lookahead or {}
        alloc = self.kv.allocator
        for row in range(self.max_batch):
            req = self._rows[row]
            if req is None:
                continue
            needed = (req["t"] + lookahead.get(row, 0)) \
                // self.page_size + 1
            if self.kv.allocated(row) >= needed:
                continue
            grow = needed - self.kv.allocated(row)
            if self.kv.extend(row, grow):
                continue
            alloc.pin(row)
            victims = alloc.victims(grow)
            alloc.unpin(row)
            if victims is None:
                raise RuntimeError(
                    f"KV pool exhausted: row {row} needs {grow} more "
                    f"page(s) and no unpinned row can be preempted")
            if any(self._rows[int(v)]["t"] >= req["t"] for v in victims):
                # Never tear down a row at least as far along as the one
                # asking: at exactly-critical pressure the laggard and the
                # leader would otherwise preempt each other forever.
                # Re-queueing the laggard keeps the most advanced row
                # monotone, so decode always terminates.
                self._preempt(row)
                continue
            for victim in victims:
                self._preempt(int(victim))
            if not self.kv.extend(row, grow):  # victims covered grow
                raise RuntimeError(
                    f"page accounting violated: row {row} cannot extend by "
                    f"{grow} page(s) after preemption")

    def _slot_order(self, idx: np.ndarray, active_mask: np.ndarray):
        """Stable permutation grouping batch rows by adapter slot (inactive
        rows last), so rows sharing an adapter sit adjacent for the BGMV
        gather. Returns ``(perm, inv)``: inputs take ``x[perm]``, outputs
        come back via ``y[inv]``."""
        key = np.where(active_mask, idx, np.iinfo(np.int32).max)
        self.bgmv_groups = len(set(idx[active_mask].tolist()))
        perm = np.argsort(key, kind="stable")
        inv = np.empty_like(perm)
        inv[perm] = np.arange(perm.size)
        return perm, inv

    def step_batch(self) -> None:
        """Admit (+prefill), page, run one decode (or draft-verify) step,
        harvest/recycle."""
        admitted = self._admit()
        look = None
        if self.drafter is not None:
            look = {i: self._spec_window(r)
                    for i, r in enumerate(self._rows) if r is not None}
        self._ensure_pages(look)
        active = [(i, r) for i, r in enumerate(self._rows) if r is not None]
        if not active:
            # admitted rows may have finished inside _admit (prefill +
            # max_new=1): that is progress, not a stall
            if self._queue and admitted == 0:
                if self.kv.allocator.free_count < self.kv.pages_for(
                        self._queue[0]["prompt"].size + 1):
                    raise RuntimeError(
                        f"{len(self._queue)} queued requests but the page "
                        f"pool is exhausted and no row is active")
                raise RuntimeError(
                    f"{len(self._queue)} queued requests but no adapter "
                    f"slot can be acquired and no row is active")
            return
        if self.drafter is not None:
            self._spec_dispatch(active)
            return
        tokens = np.zeros((self.max_batch, 1), np.int32)
        pos = np.zeros((self.max_batch,), np.int32)
        idx = np.zeros((self.max_batch,), np.int32)
        lens = np.zeros((self.max_batch,), np.int32)
        for i, req in active:
            t = req["t"]
            tokens[i, 0] = req["prompt"][t] if t < req["prompt"].size \
                else req["out"][-1]
            pos[i] = t
            idx[i] = req["slot"]
            lens[i] = t + 1
        t0 = time.perf_counter()
        perm, inv = self._slot_order(idx, lens > 0)
        dev = self._to_device
        logits = self._decode_step(dev(self.kv.tables[perm]), dev(idx[perm]),
                                   dev(tokens[perm]), dev(pos[perm]),
                                   dev(lens[perm]))
        nxt = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()[inv]
        self.metrics.histogram(f"{self.name}.decode_step_s").observe(
            time.perf_counter() - t0)
        self.steps += 1
        for i, req in active:
            req["t"] += 1
            if req["t"] >= req["prompt"].size:       # past prefill: sample
                req["out"].append(int(nxt[i]))
                self.tokens_generated += 1
            if len(req["out"]) >= req["max_new"]:    # finished: recycle row
                self._finish(i, req)

    def _spec_dispatch(self, active) -> None:
        """One draft-verify round: the drafter proposes up to ``spec_k``
        tokens per row, one verify step scores every draft position plus
        the model's own next token, and each row commits the longest
        matching prefix + 1 (exact greedy match, so the tokens equal plain
        decode's). Rejected suffixes roll back by truncating the row's page
        list: KV written for rejected positions dies by the length mask and
        is overwritten in place when decode reaches those positions."""
        s = self.spec_k + 1
        tokens = np.zeros((self.max_batch, s), np.int32)
        pos0 = np.zeros((self.max_batch,), np.int32)
        idx = np.zeros((self.max_batch,), np.int32)
        nv = np.zeros((self.max_batch,), np.int32)
        props = np.asarray(self.drafter.propose(self, active), np.int32)
        if props.shape != (len(active), self.spec_k):
            raise ValueError(
                f"drafter proposed {props.shape}, expected "
                f"{(len(active), self.spec_k)}")
        for j, (i, req) in enumerate(active):
            # rows join the batch past their prompt (prefill runs at
            # admission), so the context token is always a sample
            k_b = self._spec_window(req)
            tokens[i, 0] = req["out"][-1]
            tokens[i, 1:1 + k_b] = props[j, :k_b]
            nv[i] = k_b + 1
            pos0[i] = req["t"]
            idx[i] = req["slot"]
        t0 = time.perf_counter()
        perm, inv = self._slot_order(idx, nv > 0)
        dev = self._to_device
        logits = self._verify_step(dev(self.kv.tables[perm]), dev(idx[perm]),
                                   dev(tokens[perm]), dev(pos0[perm]),
                                   dev(nv[perm]))
        greedy = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy(
            )[inv]
        self.metrics.histogram(f"{self.name}.decode_step_s").observe(
            time.perf_counter() - t0)
        self.steps += 1
        self.spec_dispatches += 1
        for i, req in active:
            k_b = int(nv[i]) - 1
            accepted = 0
            while accepted < k_b and \
                    tokens[i, 1 + accepted] == greedy[i, accepted]:
                accepted += 1
            commit = accepted + 1     # matched drafts + the model's own
            req["out"].extend(int(x) for x in greedy[i, :commit])
            req["t"] += commit
            self.tokens_generated += commit
            self.drafted_tokens += k_b
            self.accepted_tokens += accepted
            if len(req["out"]) >= req["max_new"]:
                self._finish(i, req)
            else:
                # rollback: pages past the next write position go home
                self.rollback_pages += self.kv.truncate(i, req["t"])

    def spec_stats(self) -> Dict[str, float]:
        """Speculative-decode counts (all zeros without a drafter)."""
        return {
            "dispatches": self.spec_dispatches,
            "drafted": self.drafted_tokens,
            "accepted": self.accepted_tokens,
            "acceptance_rate": self.accepted_tokens
            / max(self.drafted_tokens, 1),
            "rollback_pages": self.rollback_pages,
        }

    def run(self) -> Dict[str, np.ndarray]:
        """Drive until every submitted request has finished."""
        while self._queue or any(r is not None for r in self._rows):
            self.step_batch()
        out, self._done = self._done, {}
        return out
