#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card (sm_90a,
``nvcc`` under ``$CUDA_HOME`` or ``/usr/local/cuda``):

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compile the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. kernels: each kernel against its plain PyTorch version at the shapes
   full-width Gemma-2B serving gives it, in float32 and bfloat16, with
   kernel, plain and library times; the verify kernel also against the
   decode kernel at one token per row;
4. engine: ``ServeEngine`` serving full-width Gemma-2B (float32, random
   weights from a seed) with four adapters of ranks 2/4/6/8 for 8 requests,
   every kernel's launch count above 0, and every request's tokens equal to
   the merged-weight oracle; then one more wave under ``torch.profiler``
   for the device-busy share of wall time and device time by kernel;
5. speculative decode: the same 8 requests through ``ServeEngine(drafter=,
   spec_k=4)`` on phase 4's weights and registry, in four waves (scripted
   forced-accept and forced-reject, n-gram, self-draft), each wave's tokens
   equal to phase 4's plain tokens and the verify kernel launched;
6. a ``{"kernels": [...]}`` summary line, then ``{"ok": true, ...}`` last.

It exits non-zero, printing no result, when CUDA is unavailable.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

PEAK_BYTES_PER_S = 3.35e12                 # H100 SXM HBM3
PEAK_OPS_PER_S = {"float32": 67e12,        # CUDA cores, no tensor cores
                  "bfloat16": 989e12}      # dense tensor cores
# A token may differ from the oracle only where the oracle's top-2 logit gap
# is below GAP_TOL: the engine and the oracle sum the same float32 products
# in other orders (kernels, batch 8 vs batch 1, merged vs factored LoRA),
# which moves O(1) logits by far less than 1e-3 but can flip a near-tie.
GAP_TOL = 1e-3


def log(*args):
    print(*args, flush=True)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def device_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20) -> float:
    """Device time of one call: ``iters`` calls captured into a CUDA graph,
    replayed between CUDA events (so host launch cost is left out)."""
    import torch
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reps = 5
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(bytes_moved: float, ops: float, dtype) -> dict:
    name = str(dtype).replace("torch.", "")
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[name] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# Per-element limit |kernel - plain| <= RTOL * |plain| + ATOL, by dtype.
# float32: the same products summed in another order; outputs are O(1).
# bfloat16: both sides compute in float32 from the same bf16 inputs and
# round the result to 8 significant bits, so they may land one bf16 ulp
# apart (<= 2^-7 |plain|), plus the float32 reordering (~1e-6 here).
TOLERANCE = {"float32": (0.0, 1e-4, "float32 sums in another order, "
                         "outputs O(1)"),
             "bfloat16": (2.0 ** -7, 1e-5, "one bf16 ulp of each element "
                          "plus float32 reordering")}


def compare(name, got, want) -> float:
    import torch
    torch.cuda.synchronize()
    rtol, atol, why = TOLERANCE[str(want.dtype).replace("torch.", "")]
    diff = (got.float() - want.float()).abs()
    limit = rtol * want.float().abs() + atol
    err = float(diff.max())
    worst = float((diff / limit).max())
    ok = math.isfinite(err) and worst <= 1.0
    log(f"  {name}: max_abs_err {err:.3e}, tolerance {rtol:.2e}*|plain| + "
        f"{atol:.0e} per element ({why}), worst err/limit {worst:.3f} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (err/limit {worst})")
    return err


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def check_bgmv(torch, ops, bgmv_mod, gen) -> dict:
    log("bgmv (decode LoRA gather: B=8, S=4, R=8, d_in 2048):")
    row = None
    idx = torch.tensor([0, 0, 1, 1, 2, 2, 3, 3], dtype=torch.int32,
                       device="cuda")
    mask = (torch.arange(8, device="cuda")[None, :]
            < torch.tensor([2, 4, 6, 8], device="cuda")[:, None]).float()
    for dtype in (torch.float32, torch.bfloat16):
        for d_out in (2048, 256):
            x = torch.randn(8, 2048, generator=gen, device="cuda").to(dtype)
            a = (torch.randn(4, 2048, 8, generator=gen, device="cuda")
                 / math.sqrt(2048) * mask[:, None, :]).to(dtype)
            b = (0.05 * torch.randn(4, 8, d_out, generator=gen,
                                    device="cuda")).to(dtype)
            want = bgmv_mod.bgmv_plain(x, a, b, idx)
            got = ops.bgmv(x, a, b, idx)
            err = compare(f"{dtype} d_out={d_out}", got, want)
            ms = time_ms(lambda: ops.bgmv(x, a, b, idx))
            plain_ms = time_ms(lambda: bgmv_mod.bgmv_plain(x, a, b, idx))
            slots = len(set(idx.tolist()))
            moved = (nbytes(x, idx) + x.shape[0] * d_out * x.element_size()
                     + slots * (2048 * 8 + 8 * d_out) * x.element_size())
            ops_n = 2 * 8 * (2048 * 8 + 8 * d_out)
            bd = bound(moved, ops_n, dtype)
            log(f"    ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms null "
                f"(no single PyTorch call) bound_ms {bd['bound_ms']:.5f} "
                f"({bd['bound_by']})")
            if dtype == torch.float32 and d_out == 2048:
                row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "library_ms": None, **bd}
    return row


def check_paged(torch, ops, paged_mod, gen) -> dict:
    log("paged_attention (decode: B=8, Hkv=1, G=8, Dh=256, page 16):")
    row = None
    # the engine phase's pool: 8 rows x 13 pages of 16 (max_seq 208)
    b, hkv, g, dh, ps, p, n_pool = 8, 1, 8, 256, 16, 13, 104
    lengths = torch.tensor([0, 1, 16, 17, 77, 150, 177, 208],
                           dtype=torch.int32, device="cuda")
    perm = torch.randperm(n_pool, generator=gen, device="cuda")
    tables = perm[:b * p].reshape(b, p).to(torch.int32).contiguous()
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn(b, hkv * g, dh, generator=gen, device="cuda").to(dtype)
        kp = torch.randn(n_pool + 1, ps, hkv, dh, generator=gen,
                         device="cuda").to(dtype)
        vp = torch.randn(n_pool + 1, ps, hkv, dh, generator=gen,
                         device="cuda").to(dtype)
        want = paged_mod.paged_attention_plain(q, kp, vp, tables, lengths)
        got = ops.paged_attention(q, kp, vp, tables, lengths, page_size=ps)
        err = compare(f"{dtype} lengths={lengths.tolist()}", got, want)
        if bool((got[0] != 0).any()):
            raise AssertionError("a length-0 row must give exact zeros")
        ms = time_ms(lambda: ops.paged_attention(q, kp, vp, tables, lengths,
                                                 page_size=ps))
        plain_ms = time_ms(lambda: paged_mod.paged_attention_plain(
            q, kp, vp, tables, lengths))
        tokens = int(lengths.sum())
        moved = (2 * nbytes(q) + nbytes(tables, lengths)
                 + 2 * tokens * hkv * dh * q.element_size())
        bd = bound(moved, 4 * tokens * hkv * g * dh, dtype)
        log(f"    ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms null "
            f"(no single PyTorch call reads through page tables) bound_ms "
            f"{bd['bound_ms']:.5f} ({bd['bound_by']})")
        if dtype == torch.float32:
            row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "library_ms": None, **bd}
    return row


def check_flash(torch, ops, flash_mod, gen) -> dict:
    import torch.nn.functional as F
    log("flash_attention (prefill chunk: Sq=64, H=8, Hkv=1, D=256, "
        "Skv=208 gathered pages):")
    row = None
    cases = [("chunk q_offset=128", 1, 128, None),
             ("chunk q_offset=128 window=48", 1, 128, 48),
             ("per-row q_offset=(0, 100)", 2, None, None)]
    for dtype in (torch.float32, torch.bfloat16):
        for label, b, off, window in cases:
            q = torch.randn(b, 64, 8, 256, generator=gen,
                            device="cuda").to(dtype)
            k = torch.randn(b, 208, 1, 256, generator=gen,
                            device="cuda").to(dtype)
            v = torch.randn(b, 208, 1, 256, generator=gen,
                            device="cuda").to(dtype)
            q_offset = off if off is not None else torch.tensor(
                [0, 100], dtype=torch.int32, device="cuda")
            kw = dict(causal=True, window=window, q_offset=q_offset)
            want = flash_mod.flash_attention_plain(q, k, v, **kw)
            got = ops.flash_attention(q, k, v, **kw)
            err = compare(f"{dtype} {label}", got, want)
            if dtype != torch.float32 or label != cases[0][0]:
                continue
            ms = time_ms(lambda: ops.flash_attention(q, k, v, **kw))
            plain_ms = time_ms(lambda: flash_mod.flash_attention_plain(
                q, k, v, **kw))
            vis = flash_mod.visibility(q_offset, 64, 208, b, True, window,
                                       q.device)
            qt = q.transpose(1, 2).contiguous()
            kt = k.transpose(1, 2).contiguous()
            vt = v.transpose(1, 2).contiguous()
            mask = vis[:, None]
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True))
            keys = int(vis.any(1).sum())
            moved = 2 * nbytes(q) + 2 * keys * 256 * q.element_size()
            bd = bound(moved, 4 * int(vis.sum()) * 8 * 256, dtype)
            log(f"    ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
                f"{library_ms:.4f} (scaled_dot_product_attention, boolean "
                f"mask, enable_gqa) bound_ms {bd['bound_ms']:.5f} "
                f"({bd['bound_by']})")
            row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "library_ms": library_ms, **bd}
    return row


def check_verify(torch, ops, verify_mod, paged_mod, gen) -> dict:
    log("paged_verify_attention (verify: B=8, Sq=5, Hkv=1, G=8, Dh=256, "
        "page 16):")
    row = None
    # the engine's pool and a spec_k = 4 window: ragged offsets, windows of
    # 1..5 valid tokens, row 0 inactive
    b, sq, hkv, g, dh, ps, p, n_pool = 8, 5, 1, 8, 256, 16, 13, 104
    offs = torch.tensor([0, 42, 60, 77, 100, 150, 177, 203],
                        dtype=torch.int32, device="cuda")
    nv = torch.tensor([0, 5, 5, 3, 5, 1, 5, 5], dtype=torch.int32,
                      device="cuda")
    lengths = torch.where(nv > 0, offs + nv, 0).to(torch.int32)
    perm = torch.randperm(n_pool, generator=gen, device="cuda")
    tables = perm[:b * p].reshape(b, p).to(torch.int32).contiguous()
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn(b, sq, hkv * g, dh, generator=gen,
                        device="cuda").to(dtype)
        kp = torch.randn(n_pool + 1, ps, hkv, dh, generator=gen,
                         device="cuda").to(dtype)
        vp = torch.randn(n_pool + 1, ps, hkv, dh, generator=gen,
                         device="cuda").to(dtype)
        args = (q, kp, vp, tables, lengths, offs)
        want = verify_mod.paged_verify_attention_plain(*args)
        got = ops.paged_verify_attention(*args, page_size=ps)
        err = compare(f"{dtype} q_offsets={offs.tolist()} "
                      f"lengths={lengths.tolist()}", got, want)
        if bool((got[0] != 0).any()):
            raise AssertionError("a length-0 row must give exact zeros")
        if dtype != torch.float32:
            continue
        # one token per row at q_offsets = lengths - 1 is decode attention
        lens1 = torch.tensor([0, 1, 16, 17, 77, 150, 177, 208],
                             dtype=torch.int32, device="cuda")
        offs1 = torch.clamp(lens1 - 1, min=0).to(torch.int32)
        ver = ops.paged_verify_attention(q[:, :1].contiguous(), kp, vp,
                                         tables, lens1, offs1,
                                         page_size=ps)[:, 0]
        dec = ops.paged_attention(q[:, 0].contiguous(), kp, vp, tables,
                                  lens1, page_size=ps)
        torch.cuda.synchronize()
        d1 = float((ver - dec).abs().max())
        ok = d1 <= 1e-6
        log(f"  Sq=1 at q_offsets = lengths - 1 against the decode kernel: "
            f"max_abs_err {d1:.3e} (tolerance 1e-6, bit-identical "
            f"{bool(torch.equal(ver, dec))}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("verify kernel at Sq=1 disagrees with the "
                                 "decode kernel")
        ms = time_ms(lambda: ops.paged_verify_attention(*args, page_size=ps))
        plain_ms = time_ms(lambda: verify_mod.paged_verify_attention_plain(
            *args))
        # K/V read once up to each row's frontier; every query token sees
        # the positions up to its own (and below the length)
        front = torch.clamp(torch.minimum(lengths, offs + sq), min=0)
        seen = torch.minimum(lengths[:, None], offs[:, None] + 1
                             + torch.arange(sq, device="cuda")[None, :])
        seen = torch.where(lengths[:, None] > 0, seen, 0)
        moved = (2 * nbytes(q) + nbytes(tables, lengths, offs)
                 + 2 * int(front.sum()) * hkv * dh * q.element_size())
        bd = bound(moved, 4 * int(seen.sum()) * hkv * g * dh, dtype)
        log(f"    ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms null "
            f"(no single PyTorch call reads through page tables) bound_ms "
            f"{bd['bound_ms']:.5f} ({bd['bound_by']})")
        row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "library_ms": None, **bd}
    return row


# ---------------------------------------------------------------------------
# phase 4: the engine on full-width Gemma-2B
# ---------------------------------------------------------------------------

def first_difference_ok(got, want, oracle, gaps) -> str:
    """'' when ``got`` equals ``want``; else a description of the first
    difference, which is allowed only where the oracle, still on ``want``'s
    path, had a top-2 logit gap below GAP_TOL (a float32 near-tie)."""
    import numpy as np
    if got.shape != want.shape:
        raise AssertionError(f"{got.shape} tokens, expected {want.shape}")
    diff = np.nonzero(got != want)[0]
    if diff.size == 0:
        return ""
    j = int(diff[0])
    on_path = bool((oracle[:j] == want[:j]).all())
    msg = (f"first differing token at {j}: {int(got[j])} vs {int(want[j])}, "
           f"oracle top-2 gap {gaps[j]:.3e} (tolerance {GAP_TOL}), oracle "
           f"on the same path before it: {on_path}")
    if not on_path or gaps[j] >= GAP_TOL:
        raise AssertionError(msg)
    return msg


def run_engine(torch, np) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as model_lib
    from repro_torch.serve import AdapterRegistry, ServeEngine
    from repro_torch.serve.oracle import make_demo_adapter, \
        merged_greedy_gaps

    cfg = get_config("gemma-2b")
    steps, page_size, chunk = 32, 16, 64
    t0 = time.perf_counter()
    params = model_lib.init_params(cfg, seed=0, device="cuda")
    ranks = (2, 4, 6, 8)
    adapters = {}
    for i, r in enumerate(ranks):
        gen = torch.Generator(device="cuda").manual_seed(100 + i)
        adapters[f"client{i}"] = make_demo_adapter(gen, cfg, r)
    registry = AdapterRegistry(cfg, capacity=len(ranks), device="cuda")
    for aid, tree in adapters.items():
        registry.register(aid, tree)
    torch.cuda.synchronize()
    log(f"  gemma-2b full width: {cfg.param_count() / 1e9:.3f} B params "
        f"float32, set-up {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    lens = rng.integers(40, 201, size=8)
    prompts = [rng.integers(3, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in lens]
    max_seq = int(lens.max()) + steps
    engine = ServeEngine(params, cfg, registry, max_batch=8, max_seq=max_seq,
                         page_size=page_size, prefill_chunk=chunk,
                         device="cuda")

    # warm-up wave (cuBLAS handles, allocator): not counted
    engine.submit(prompts[0][:chunk + 3], "client0", max_new_tokens=3)
    engine.run()
    for h in ("decode_step_s", "prefill_row_s"):
        engine.metrics.histogram(f"serve.{h}").reset()
    calls0, steps0 = engine.prefill_calls, engine.steps

    uids = [engine.submit(prompts[i], f"client{i % len(ranks)}",
                          max_new_tokens=steps) for i in range(8)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    outs = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    n_steps = engine.steps - steps0
    n_chunks = engine.prefill_calls - calls0
    log(f"  launches {launches} over {n_steps} decode steps and {n_chunks} "
        f"prefill chunks (expect bgmv {4 * cfg.num_layers}/step, "
        f"paged {cfg.num_layers}/step, flash {cfg.num_layers}/chunk)")
    expect = {"bgmv": 4 * cfg.num_layers * n_steps,
              "paged_attention": cfg.num_layers * n_steps,
              "flash_attention": cfg.num_layers * n_chunks,
              "paged_verify_attention": 0}     # plain decode: no verify
    for name in ("bgmv", "paged_attention", "flash_attention"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the main "
                                 f"path")
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != {expect}")
    dec = engine.metrics.histogram("serve.decode_step_s")
    pre = engine.metrics.histogram("serve.prefill_row_s")
    tok_s = 8 * steps / wall
    log(f"  served 8 requests x {steps} tokens (prompts {lens.tolist()}) in "
        f"{wall:.3f} s: {tok_s:.1f} tok/s; decode step p50 "
        f"{dec.percentile(50) * 1e3:.3f} ms (n={dec.count}); prefill "
        f"{pre.total / max(n_chunks, 1) * 1e3:.3f} ms/chunk ({n_chunks} "
        f"chunks of {chunk}); peak memory {peak_gb:.2f} GiB (KV pool "
        f"{engine.kv_cache_bytes() / 2**20:.1f} MiB)")

    t0 = time.perf_counter()
    exact = 0
    oracle, gaps = [], []
    for i, uid in enumerate(uids):
        tree = adapters[f"client{i % len(ranks)}"]
        want, gap = merged_greedy_gaps(params, cfg, prompts[i], tree, steps)
        oracle.append(want)
        gaps.append(gap)
        msg = first_difference_ok(outs[uid], want, want, gap)
        if msg:
            log(f"  request {i} against the oracle: {msg}")
        else:
            exact += 1
    log(f"  oracle (merged weights, token-by-token plain decode): {exact}/8 "
        f"exact in {time.perf_counter() - t0:.1f} s")
    profile_engine(torch, engine, prompts, len(ranks))
    return {"launches": launches, "params": params, "cfg": cfg,
            "registry": registry, "prompts": prompts, "steps": steps,
            "plain": [outs[u] for u in uids], "oracle": oracle, "gaps": gaps,
            "plain_steps": n_steps,
            "engine_kw": dict(max_batch=8, max_seq=max_seq,
                              page_size=page_size, prefill_chunk=chunk),
            "adapters": [f"client{i % len(ranks)}" for i in range(8)]}


def profile_engine(torch, engine, prompts, n_adapters,
                   step: str = "decode") -> None:
    """One more wave (8 requests x 8 tokens) under torch.profiler, after
    the counted and checked wave, in two windows: the first engine step
    (admission and chunked prefill of every request, plus one decode or
    verify step) and the remaining steps. For each: the device-busy share
    of the wall time and device time by kernel."""
    for i, p in enumerate(prompts):
        engine.submit(p, f"client{i % n_adapters}", max_new_tokens=8)
    steps0 = engine.steps
    profile_window(torch, "admission + prefill", engine.step_batch)
    profile_window(torch, step, engine.run)
    log(f"  ({step} window: {engine.steps - steps0 - 1} steps)")


def profile_window(torch, label, fn) -> None:
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.key_averages()
              if e.device_type == cuda and e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    groups = {"port kernels": ("bgmv_kernel", "paged_attn_kernel",
                               "flash_attn_kernel", "paged_verify_kernel"),
              "GEMM/GEMV": ("gemm", "gemv", "Gemv", "Gemm")}
    by_group = {g: 0.0 for g in (*groups, "other")}
    for e in events:
        g = next((g for g, keys in groups.items()
                  if any(k in e.key for k in keys)), "other")
        by_group[g] += e.self_device_time_total / 1e3
    events.sort(key=lambda e: -e.self_device_time_total)
    log(f"  profiled {label}: wall {wall * 1e3:.1f} ms, device busy "
        f"{device_ms:.1f} ms ({100 * device_ms / (wall * 1e3):.1f}% of "
        f"wall); device ms by group: "
        + ", ".join(f"{g} {v:.2f}" for g, v in by_group.items()))
    for e in events[:10]:
        log(f"    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  "
            f"{e.key[:90]}")


# ---------------------------------------------------------------------------
# phase 5: speculative decode on full-width Gemma-2B
# ---------------------------------------------------------------------------

def run_spec(torch, ctx) -> dict:
    """Four waves of phase 4's 8 requests with ``spec_k = 4`` on phase 4's
    weights and registry (no second copy), each on a fresh engine with the
    launch counts set to 0 just before and read just after. Returns the
    launches summed over the waves."""
    from repro_torch.kernels import ops
    from repro_torch.serve import (NGramDrafter, ScriptedDrafter,
                                   SelfDrafter, ServeEngine)

    cfg, steps, plain = ctx["cfg"], ctx["steps"], ctx["plain"]
    spec_k, layers = 4, cfg.num_layers

    def engine_with(drafter):
        return ServeEngine(ctx["params"], cfg, ctx["registry"],
                           drafter=drafter, spec_k=spec_k, device="cuda",
                           **ctx["engine_kw"])

    # warm-up (first verify and draft calls): not counted
    warm = engine_with(SelfDrafter(1))
    warm.submit(ctx["prompts"][0][:67], "client0", max_new_tokens=6)
    warm.run()
    del warm

    waves = [("forced-accept", ScriptedDrafter(), plain),
             ("forced-reject", ScriptedDrafter(),
              [(p + 1) % cfg.vocab_size for p in plain]),
             ("ngram(2)", NGramDrafter(2), None),
             ("self(2)", SelfDrafter(2), None)]
    total = {name: 0 for name in ops.LAUNCHES}
    for label, drafter, scripts in waves:
        engine = engine_with(drafter)
        uids = [engine.submit(p, a, max_new_tokens=steps)
                for p, a in zip(ctx["prompts"], ctx["adapters"])]
        if scripts is not None:
            for uid, script in zip(uids, scripts):
                drafter.set(uid, script)
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        outs = engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        for name, n in launches.items():
            total[name] += n
        st = engine.spec_stats()
        ver = engine.metrics.histogram("serve.decode_step_s")
        pre = engine.metrics.histogram("serve.prefill_row_s")
        log(f"  {label}: {8 * steps / wall:.1f} tok/s ({wall:.3f} s), "
            f"{st['dispatches']} dispatches (plain decode took "
            f"{ctx['plain_steps']} steps), acceptance "
            f"{st['acceptance_rate']:.3f} ({st['accepted']}/{st['drafted']}), "
            f"rollback pages {st['rollback_pages']}, verify step p50 "
            f"{ver.percentile(50) * 1e3:.3f} ms (n={ver.count}, total "
            f"{ver.total * 1e3:.1f} ms), prefill {pre.total * 1e3:.1f} ms "
            f"({engine.prefill_calls} chunks); launches {launches}")
        for i, uid in enumerate(uids):
            msg = first_difference_ok(outs[uid], plain[i], ctx["oracle"][i],
                                      ctx["gaps"][i])
            if msg:
                log(f"    request {i} against plain decode: {msg}")
        chunks = engine.prefill_calls
        expect = {"paged_verify_attention": layers * st["dispatches"],
                  "flash_attention": layers * chunks}
        if isinstance(drafter, SelfDrafter):
            # draft steps: 2 layers each, 4 LoRA'd projections per layer
            draft = launches["paged_attention"]
            if draft <= 0 or draft % drafter.draft_layers:
                raise AssertionError(f"self-draft launched paged attention "
                                     f"{draft} times")
            expect.update(paged_attention=draft, bgmv=4 * draft)
        else:
            expect.update(paged_attention=0, bgmv=0)
        if launches != expect:
            raise AssertionError(f"{label}: launch counts {launches} != "
                                 f"{expect}")
        if label == "forced-accept" and \
                not st["dispatches"] < ctx["plain_steps"]:
            raise AssertionError(f"forced-accept took {st['dispatches']} "
                                 f"dispatches, plain {ctx['plain_steps']}")
        if label == "forced-reject" and \
                (st["accepted"] != 0 or st["rollback_pages"] <= 0):
            raise AssertionError(f"forced-reject: {st}")
        engine.kv.allocator.check()
        del engine
    log(f"  4 waves, every request equal to plain decode; launches summed "
        f"over the waves {total}")
    profile_engine(torch, engine_with(NGramDrafter(2)), ctx["prompts"], 4,
                   step="verify")
    return total


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import bgmv as bgmv_mod
    from repro_torch.kernels import flash_attn as flash_mod
    from repro_torch.kernels import paged_attn as paged_mod
    from repro_torch.kernels import verify as verify_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = device_line()
    log(f"[1] device: {card}; torch {torch.__version__} CUDA "
        f"{torch.version.cuda}")

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load()
    log(f"[2] build: {time.perf_counter() - t0:.1f} s -> "
        f"{os.path.relpath(lib_path, ROOT)}")
    for line in str(_build.build_info.get("log", "")).splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log("    " + line.strip())

    log("[3] kernels against their plain versions")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {"bgmv": check_bgmv(torch, ops, bgmv_mod, gen),
            "paged_attention": check_paged(torch, ops, paged_mod, gen),
            "flash_attention": check_flash(torch, ops, flash_mod, gen),
            "paged_verify_attention": check_verify(torch, ops, verify_mod,
                                                   paged_mod, gen)}
    log("[4] engine: full-width gemma-2b")
    ctx = run_engine(torch, np)
    log("[5] speculative decode: full-width gemma-2b, spec_k 4")
    spec_launches = run_spec(torch, ctx)
    # each kernel's launches on the path that exercises it: phase 4 for
    # plain serving, phase 5 for the verify step
    launches = dict(ctx["launches"], paged_verify_attention=spec_launches[
        "paged_verify_attention"])

    meta = {"bgmv": ("src/repro_torch/kernels/csrc/bgmv.cu",
                     "src/repro/kernels/bgmv.py:43"),
            "paged_attention": ("src/repro_torch/kernels/csrc/paged_attn.cu",
                                "src/repro/kernels/paged_attn.py:103"),
            "flash_attention": ("src/repro_torch/kernels/csrc/flash_attn.cu",
                                "src/repro/kernels/flash_attn.py:75"),
            "paged_verify_attention": ("src/repro_torch/kernels/csrc/verify.cu",
                                       "src/repro/kernels/verify.py:103")}
    kernels = []
    for name, (source, replaces) in meta.items():
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched")
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        **rows[name]})
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
