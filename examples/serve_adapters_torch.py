"""Serving example on the PyTorch port (``repro_torch.serve``): continuous-
batched decode with per-request LoRA over a paged KV cache, scenario for
scenario the counterpart of ``examples/serve_adapters.py``.

The HLoRA server produces per-client, heterogeneous-rank adapters; at
deployment each request carries its own. ``main`` puts four adapters of
ranks 2/4/6/8 into an AdapterRegistry slab and serves eight requests spread
across them through one ServeEngine step (factored adapters gathered per
row, no merge), checked token for token against per-request merged-weight
decoding. Then one adapter is hot-swapped: an in-place write of its slab
slot, after which a request on it gives the merged-weight tokens of the new
adapter.

``oversubscribed`` serves long-prompt traffic through a deliberately small
page pool: more concurrent requests than a dense ring cache of the same
memory could hold. Page-gated admission defers what the pool cannot hold
yet, and every deferred request still finishes with oracle-exact tokens.

``speculative`` replays traffic through lossless draft-verify decode: a
scripted drafter proposes the request's previous answer, one multi-token
verify step scores the whole window, rejected suffixes roll their pages
back: the same tokens as plain decode in a fraction of the dispatches.

``observability`` records both engine flavours into one recorder and
exports the timeline as a Chrome trace (perfetto) and a JSONL archive, then
folds the same events into time series and per-class TTFT SLOs and renders
the static HTML ops report (``repro_torch.obs``).

  PYTHONPATH=src python examples/serve_adapters_torch.py
  PYTHONPATH=src python examples/serve_adapters_torch.py --device cpu

It serves reduced Gemma-2B on the CUDA card unless ``--device cpu`` is
given. Each scenario takes its ``Fixture`` (config, weights, registry,
adapters) and returns its results, so that a caller can serve other weights,
full-width ones, through it; ``main(argv)`` builds a fresh reduced fixture
for each, as the reference does, and returns the four results by scenario
name. The port has no jit: where the reference prints retraces, this prints
what shows a hot-swap took, the registry's loads and the swapped request
against the merged-weight oracle of the scaled adapter. ``observability``
writes ``results/serve_torch.trace.json``, ``results/serve_torch.events.
jsonl`` and ``results/serve_torch_report.html``.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import get_reduced
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as model_lib
from repro_torch.models.transformer import Transformer
from repro_torch.obs import (MetricsRegistry, Objective, Recorder,
                             SeriesStore, SLOMonitor, snapshot_text,
                             validate_chrome_trace, write_chrome_trace,
                             write_html, write_jsonl)
from repro_torch.serve import AdapterRegistry, ScriptedDrafter, ServeEngine
from repro_torch.serve.oracle import make_demo_adapter, merged_greedy

STEPS = 16
PROMPT_LEN = 8
RANKS = (2, 4, 6, 8)
TRACE = os.path.join("results", "serve_torch.trace.json")
EVENTS = os.path.join("results", "serve_torch.events.jsonl")
REPORT = os.path.join("results", "serve_torch_report.html")


class Fixture(NamedTuple):
    """What a scenario serves: ``params`` for ``cfg``, a ``registry`` of
    the ``adapters`` ``client0``, ``client1``, ... (their trees are the
    registry's sources), all on ``device``; ``seed`` draws the prompts."""
    cfg: ModelConfig
    params: Transformer
    registry: AdapterRegistry
    adapters: Dict[str, Dict[str, Dict[str, torch.Tensor]]]
    device: torch.device
    seed: int = 0


def make_fixture(cfg: ModelConfig, device=None, seed: int = 0) -> Fixture:
    """Random weights from ``seed`` and four demo adapters of ranks
    2/4/6/8 in a registry of 4 slots, on ``device`` (None = CUDA)."""
    dev = resolve_device(device)
    params = model_lib.init_params(cfg, seed=seed, device=dev)
    adapters = {}
    for i, r in enumerate(RANKS):
        gen = torch.Generator(device=dev).manual_seed(seed + 100 + i)
        adapters[f"client{i}"] = make_demo_adapter(gen, cfg, r)
    registry = AdapterRegistry(cfg, capacity=len(RANKS), device=dev)
    for aid, tree in adapters.items():
        registry.register(aid, tree)
    return Fixture(cfg, params, registry, adapters, dev, seed)


def make_prompts(fx: Fixture, stream: int, n: int, length: int
                 ) -> np.ndarray:
    """(n, length) int32 tokens in [3, vocab), from ``fx.seed`` and a
    scenario's ``stream``."""
    rng = np.random.default_rng([fx.seed, stream])
    return rng.integers(3, fx.cfg.vocab_size, (n, length)).astype(np.int32)


def _client(fx: Fixture, i: int) -> str:
    return f"client{i % len(fx.adapters)}"


def _timed(fn: Callable) -> Tuple[float, object]:
    """(seconds, result) of ``fn()``; the engines' results reach the host
    before they return, so the time holds the device's work."""
    t0 = time.perf_counter()   # repro: allow=clock-discipline (CLI timing)
    out = fn()
    return time.perf_counter() - t0, out  # repro: allow=clock-discipline


def _engine(fx: Fixture, **kw) -> ServeEngine:
    return ServeEngine(fx.params, fx.cfg, fx.registry, device=fx.device,
                       **kw)


def multi_lora(fx: Fixture) -> dict:
    """The reference's ``main``: 8 requests over the 4 adapters in one
    engine against the merged-weight oracle, then a hot-swap of client1."""
    cfg = fx.cfg
    engine = _engine(fx, max_batch=8, max_seq=PROMPT_LEN + STEPS)
    prompts = make_prompts(fx, 3, 8, PROMPT_LEN)
    uids = [engine.submit(prompts[i], _client(fx, i), max_new_tokens=STEPS)
            for i in range(8)]
    t_engine, outs = _timed(engine.run)
    steps_first = engine.steps

    t_merged, oracles = _timed(lambda: [
        merged_greedy(fx.params, cfg, prompts[i], fx.adapters[_client(fx, i)],
                      STEPS) for i in range(8)])

    # hot-swap client1's adapter mid-deployment: an in-place slab write
    tree = fx.adapters["client1"]
    for t in tree:
        tree[t]["B"] = tree[t]["B"] * 1.5
    loads = fx.registry.loads
    fx.registry.refresh("client1")
    swap_loads = fx.registry.loads - loads
    uid = engine.submit(prompts[0], "client1", max_new_tokens=4)
    swapped = engine.run()[uid]
    swap_equal = bool(np.array_equal(
        swapped, merged_greedy(fx.params, cfg, prompts[0], tree, 4)))

    match = sum(int(np.array_equal(outs[u], o))
                for u, o in zip(uids, oracles))
    total_tok = 8 * STEPS
    print(f"batched multi-LoRA engine: {t_engine:.2f}s for 8 req × "
          f"{STEPS} tokens ({total_tok / t_engine:.0f} tok/s), "
          f"{steps_first} steps")
    print(f"merged per-request oracle: {t_merged:.2f}s")
    print(f"greedy outputs exactly match oracle: {match}/8")
    print(f"hot-swap: registry loads +{swap_loads} (expect +1), swapped "
          f"request equal to the scaled adapter's merged oracle: "
          f"{swap_equal}")
    print("tokens (req 0):", outs[uids[0]].tolist())
    return {"match": match, "requests": 8, "steps": steps_first,
            "tok_s": total_tok / t_engine, "swap_loads": swap_loads,
            "swap_equal": swap_equal, "prompts": prompts,
            "tokens": [outs[u] for u in uids]}


def oversubscribed(fx: Fixture) -> dict:
    """Long prompts against a deliberately small page pool.

    12 requests of 48+8 = 56 tokens each (7 pages at page_size 8) share a
    24-page pool: at most 3 requests fit at once. A dense ring cache
    spending the same memory (24*8 = 192 slots at max_seq 56) would hold
    only 3 rows ever; here all 12 batch rows exist, admission waits for
    pages, and every deferred request still finishes with oracle-exact
    greedy tokens.
    """
    cfg = fx.cfg
    num_req, prompt_len, steps, ps, num_pages = 12, 48, 8, 8, 24
    engine = _engine(fx, max_batch=num_req, max_seq=prompt_len + steps,
                     page_size=ps, num_pages=num_pages, prefill_chunk=16)
    dense_rows_same_memory = (num_pages * ps) // (prompt_len + steps)
    prompts = make_prompts(fx, 5, num_req, prompt_len)
    uids = [engine.submit(prompts[i], _client(fx, i), max_new_tokens=steps)
            for i in range(num_req)]
    t, outs = _timed(engine.run)
    engine.kv.allocator.check()
    match = sum(
        int(np.array_equal(outs[uids[i]], merged_greedy(
            fx.params, cfg, prompts[i], fx.adapters[_client(fx, i)],
            steps)))
        for i in range(num_req))
    pool_kb = engine.kv_cache_bytes() / 1024
    print(f"\noversubscribed: {num_req} req x {prompt_len + steps} tok "
          f"through a {num_pages}-page pool ({pool_kb:.0f} KiB KV) in "
          f"{t:.2f}s")
    print(f"  dense ring of equal memory admits {dense_rows_same_memory} "
          f"concurrent rows; the pool served all {num_req} "
          f"({engine.deferrals} deferrals, {engine.preemptions} "
          f"preemptions)")
    print(f"  greedy outputs exactly match oracle: {match}/{num_req}")
    return {"match": match, "requests": num_req,
            "deferrals": engine.deferrals, "preemptions": engine.preemptions,
            "dense_rows_same_memory": dense_rows_same_memory,
            "kv_bytes": engine.kv_cache_bytes(), "prompts": prompts,
            "tokens": [outs[u] for u in uids]}


def speculative(fx: Fixture) -> dict:
    """Lossless draft-verify decode on replayed traffic.

    The same request comes back (a regenerate click, a retried call) and
    its previous answer is a near-perfect draft. The drafter scripts the
    prior output, one verify step scores all ``spec_k + 1`` positions, and
    a dispatch commits the whole accepted window. Acceptance is exact
    greedy token match, so even a garbage draft only costs speed: the
    output is byte-identical to plain decode, and rejected suffixes roll
    their pages back into the pool.
    """
    num_req, steps, spec_k = 8, 16, 4
    prompts = make_prompts(fx, 9, num_req, 8)

    outs, times, stats = {}, {}, {}
    drafter = ScriptedDrafter()
    for name, dr in (("plain", None), ("replay", drafter)):
        engine = _engine(fx, max_batch=num_req,
                         max_seq=prompts.shape[1] + steps, drafter=dr,
                         spec_k=spec_k)

        def wave():
            uids = [engine.submit(prompts[i], _client(fx, i),
                                  max_new_tokens=steps)
                    for i in range(num_req)]
            if dr is not None:       # draft from the previous answers
                for u, prev in zip(uids, outs["plain"]):
                    drafter.set(u, prev)
            t, done = _timed(engine.run)
            return t, [done[u] for u in uids]

        wave()                       # warm-up (first calls, allocator)
        before = engine.spec_stats()
        times[name], outs[name] = wave()
        after = engine.spec_stats()
        # stats of the timed wave only: counters accumulate across waves
        stats[name] = {k: after[k] - before[k] for k in
                       ("dispatches", "drafted", "accepted",
                        "rollback_pages")}
    st = stats["replay"]
    exact = sum(int(np.array_equal(a, b))
                for a, b in zip(outs["replay"], outs["plain"]))
    total = num_req * steps
    acceptance = st["accepted"] / max(st["drafted"], 1)
    print(f"\nspeculative replay: {total} tokens plain "
          f"{times['plain']:.2f}s ({total / times['plain']:.0f} tok/s) "
          f"vs draft-verify {times['replay']:.2f}s "
          f"({total / times['replay']:.0f} tok/s, "
          f"{times['plain'] / times['replay']:.2f}x)")
    print(f"  acceptance {acceptance:.2f} over "
          f"{st['dispatches']} dispatches, "
          f"{st['rollback_pages']} pages rolled back, "
          f"byte-identical to plain: {exact}/{num_req}")
    return {"exact": exact, "requests": num_req, **st,
            "acceptance": acceptance,
            "plain_tok_s": total / times["plain"],
            "replay_tok_s": total / times["replay"], "prompts": prompts,
            "tokens": outs}


def observability(fx: Fixture) -> dict:
    """Record a full serving timeline and export it for perfetto.

    Two engines share one recorder, each under its own track prefix: a
    plain engine squeezed through a small page pool (so the trace shows
    deferrals, preemptions and replays beside the prefill and decode
    spans) and a speculative engine replaying the first engine's answers
    through draft-verify (verify spans on its engine track). Written:

      results/serve_torch.trace.json     Chrome trace-event JSON (validated)
      results/serve_torch.events.jsonl   lossless per-event archive
      results/serve_torch_report.html    static ops report (series
                                         sparklines, SLO attainment, metrics)
    """
    rec = Recorder()
    metrics = MetricsRegistry()

    # plain engine, tight pool: 8 req x 24 tok through 10 pages of 4; two
    # SLO classes with generous TTFT ceilings (the report's attainment
    # table is the point, not a performance gate)
    engine = _engine(fx, max_batch=8, max_seq=PROMPT_LEN + STEPS,
                     page_size=4, num_pages=10, prefill_chunk=4,
                     recorder=rec, metrics=metrics, name="serve",
                     slo_ttft_s={"interactive": 60.0, "batch": 600.0})
    prompts = make_prompts(fx, 7, 8, PROMPT_LEN)
    uids = [engine.submit(prompts[i], _client(fx, i), max_new_tokens=STEPS,
                          slo_class="interactive" if i % 2 == 0
                          else "batch") for i in range(8)]
    outs = engine.run()

    # spec engine on the same recorder: replay those answers as drafts
    drafter = ScriptedDrafter()
    spec = _engine(fx, max_batch=4, max_seq=PROMPT_LEN + STEPS,
                   drafter=drafter, spec_k=4, recorder=rec,
                   metrics=metrics, name="spec")
    spec_uids = []
    for i in range(4):
        u = spec.submit(prompts[i], _client(fx, i), max_new_tokens=STEPS)
        drafter.set(u, outs[uids[i]])
        spec_uids.append(u)
    spec_outs = spec.run()

    os.makedirs(os.path.dirname(TRACE), exist_ok=True)
    events = rec.events()
    doc = write_chrome_trace(events, TRACE, dropped=rec.dropped)
    counts = validate_chrome_trace(doc)
    n = write_jsonl(events, EVENTS)
    names = {e[1] for e in events}
    covered = [s for s in ("prefill_chunk", "decode_step", "draft",
                           "verify_step", "preempt", "replay", "defer")
               if s in names]
    tracks = len({e[2] for e in events})
    acceptance = spec.accepted_tokens / max(spec.drafted_tokens, 1)
    print(f"\nobservability: {n} events ({counts['X']} spans) on {tracks} "
          f"tracks -> {TRACE} (drop into ui.perfetto.dev)")
    print(f"  span/instant coverage: {', '.join(covered)}")
    print(f"  {engine.preemptions} preemptions, {engine.deferrals} "
          f"deferrals visible in-trace; spec acceptance {acceptance:.2f}")

    # the watching layer over the same events: time series, SLOs over the
    # per-class TTFT, and the static ops report
    store = SeriesStore(bucket_s=0.25)
    store.fold(events)
    slo = SLOMonitor([
        Objective("ttft", series="first_token.ttft_s", threshold=60.0,
                  target=0.9),
        Objective("decode", series="span.decode_step", threshold=60.0,
                  target=0.9)], recorder=rec)
    slo.fold(events)
    write_html(REPORT, title="serve_adapters_torch ops report", store=store,
               slo=slo, metrics=metrics, dropped=rec.dropped)
    attainment = engine.slo_attainment()
    att = ", ".join(f"{c}={a:.0%}" for c, a in attainment.items())
    print(f"  slo attainment: {att} -> {REPORT}")
    print(snapshot_text(store=store, slo=slo, title="  -- snapshot --"))
    print(metrics.summary_text("  -- metrics --"))
    return {"events": n, "spans": counts["X"], "tracks": tracks,
            "covered": covered, "preemptions": engine.preemptions,
            "deferrals": engine.deferrals, "acceptance": acceptance,
            "spec_dispatches": spec.spec_dispatches,
            "attainment": attainment, "prompts": prompts,
            "tokens": [outs[u] for u in uids],
            "spec_tokens": [spec_outs[u] for u in spec_uids],
            "files": [TRACE, EVENTS, REPORT]}


SCENARIOS = {"main": multi_lora, "oversubscribed": oversubscribed,
             "speculative": speculative, "observability": observability}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' "
                         "runs on the CPU)")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, dict]:
    """Every scenario on a fresh reduced Gemma-2B fixture; the results by
    scenario name."""
    args = parse_args(argv)
    cfg = get_reduced("gemma-2b")
    return {name: scenario(make_fixture(cfg, args.device))
            for name, scenario in SCENARIOS.items()}


if __name__ == "__main__":
    main()
