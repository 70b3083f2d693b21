#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card (sm_90a,
``nvcc`` under ``$CUDA_HOME`` or ``/usr/local/cuda``):

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compile the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. kernels: each kernel against its plain PyTorch version at the shapes
   full-width Gemma-2B serving (RoBERTa-large training for lora_matmul)
   gives it, in float32 and bfloat16, with kernel, plain and library
   times; flash_attention also with the same bits on a second call, at
   the last chunk of a 2k-token prompt, and in every other variant built
   (head dims 64 and 128, element-wise staging, one split without the
   merge), its library time the faster of two SDPA calls with the kernels
   each ran; the paged decode and verify kernels with the same bits on a
   second call at the engine's shape, minitron-4b's GQA heads, 2048
   positions and every other variant built, each with its split plan and
   registers, the verify kernel also against the decode kernel at one
   token per row; lora_matmul's forward and dx also at two ragged shapes
   (one taking the kernels with element loads) and at M = 1 on Gemma-2B's
   widths, each at the other split count and with an operand off 16-byte
   alignment, with each plan and the kernels' registers, the same bits on
   a second call, and cuBLAS's base products timed beside them; its
   backward (dx, dA, dB; float32) through ``apply_lora`` against autograd
   through the plain version, and every other rank variant built (R 13,
   29, 64) forward and backward;
   recon_agg (float32) batched at the server's shapes on RoBERTa-large
   (48 items, Kc 4 and 20, d 1024, R 8), ragged, at rank 16 and in the
   single-item form, with the same bits on a second call;
4. engine: ``ServeEngine`` serving full-width Gemma-2B (float32, random
   weights from a seed) with four adapters of ranks 2/4/6/8 for 8 requests,
   every kernel's launch count above 0, and every request's tokens equal to
   the merged-weight oracle; then one more wave under ``torch.profiler``
   for the device-busy share of wall time, device time by kernel, and the
   flash kernels' device time per prefill chunk;
5. speculative decode: the same 8 requests through ``ServeEngine(drafter=,
   spec_k=4)`` on phase 4's weights and registry, in four waves (scripted
   forced-accept and forced-reject, n-gram, self-draft), each wave's tokens
   equal to phase 4's plain tokens and the verify kernel launched;
6. client training on full-width RoBERTa-large (float32, random weights
   from a seed, LoRA on q and v): (a) one step of four clients (ranks
   2/4/6/8) on the card against the same step on the CPU (plain versions):
   loss, every trainable leaf's gradient, the factors and head after one
   AdamW step (against the CPU side's change); (b) one ``make_cohort_train`` call, 4 clients x 8 local steps of
   16 x 32 tokens on mrpc, with finite losses, masked rank directions
   bit-unchanged and the lora_matmul kernels' launch counts exact, then
   one ``evaluate`` on 1024 examples and a profiled window of 3 steps;
7. server aggregation (Eq. 2-3) of phase 6's trained cohort on the card:
   ``AggregationEngine`` with hlora ``factored`` (Gram), ``exact`` and
   ``randomized`` and with ``naive``; Eq. 1's bias per target; at fixed
   tolerances (stated beside them): (a) the kernel's dW' against the plain
   version's on the CPU, (b) exact's spectra against factored's, the
   CPU's and a float64 SVD's, (c) Eckart-Young for every item and client
   against ``svdvals`` of the kernel's dW', (d) exact's client updates against
   factored's where the truncation is well separated, (e) randomized on a
   sub-cohort inside its contract against exact, (f) recon_agg launched
   exactly once per exact or randomized call and never otherwise, and
   exact on shape groups of one target over a layer stack against the CPU;
   each method's time, and exact's split between the kernel and the SVD;
8. a ``{"kernels": [...]}`` summary line, then ``{"ok": true, ...}`` last.

It exits non-zero, printing no result, when CUDA is unavailable.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import re
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


def compare_scaled(name, got, want, rel: float, why: str) -> float:
    """|kernel - plain| <= rel * max|plain| per element: for sums whose
    terms are large against the result (gradients summed over rows), where
    the rounding error scales with the leaf, not with each element."""
    import torch
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    limit = rel * float(want.float().abs().max())
    err = float(diff.max())
    ok = math.isfinite(err) and err <= limit
    log(f"  {name}: max_abs_err {err:.3e}, tolerance {rel:.0e}*max|plain| "
        f"= {limit:.3e} ({why}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version ({err} > {limit})")
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


# Phase 3's paged shapes: (label, B, Hkv, G, Dh, page_size, P, decode
# lengths, verify q_offsets, verify windows). The engine's pool (8 rows x 13
# pages of 16, max_seq 208) and a spec_k = 4 window (ragged offsets, 1..5
# valid tokens, row 0 inactive); minitron-4b's GQA heads (G 3, not a power
# of two); 2048 positions a row, which the plan splits into runs of pages.
PAGED_SHAPES = [
    ("engine: Gemma-2B", 8, 1, 8, 256, 16, 13,
     (0, 1, 16, 17, 77, 150, 177, 208),
     (0, 42, 60, 77, 100, 150, 177, 203), (0, 5, 5, 3, 5, 1, 5, 5)),
    ("minitron-4b GQA", 8, 8, 3, 128, 16, 13,
     (0, 1, 16, 17, 77, 150, 177, 208),
     (0, 42, 60, 77, 100, 150, 177, 203), (0, 5, 5, 3, 5, 1, 5, 5)),
    ("long context", 8, 1, 8, 256, 16, 128,
     (0, 1, 300, 777, 1024, 1500, 2047, 2048),
     (0, 290, 777, 1019, 1500, 2000, 2043, 2043), (0, 5, 5, 5, 3, 1, 5, 5)),
]
# The other instantiations the paged sources build: the head-dim template
# 64 (and element-wise staging, Dh not a multiple of the 16-byte vector),
# and one split, which writes the output without the merge.
PAGED_VARIANTS = [
    ("Dh 64, Hkv 2, G 2, pages of 8", 3, 2, 2, 64, 8, 5,
     (0, 9, 40), (0, 4, 35), (0, 5, 5)),
    ("Dh 30 (template 64, element-wise staging), G 4", 3, 1, 4, 30, 16, 4,
     (0, 33, 64), (0, 28, 59), (0, 5, 5)),
    ("one page a row (one split, no merge)", 4, 1, 8, 256, 16, 1,
     (0, 1, 9, 16), (0, 0, 4, 11), (0, 1, 5, 5)),
]


def ptxas_lines() -> list:
    """(entry, line) for each register and spill line of this run's build
    log, the entry named by its kernel and mangled template arguments
    (empty when the library was built by an earlier run)."""
    from repro_torch.kernels import _build
    out, entry = [], ""
    for line in str(_build.build_info.get("log", "")).splitlines():
        if "Compiling entry" in line:
            m = re.search(r"\d+([A-Za-z_]+_kernel)(I.*?E)?E", line)
            entry = "".join(g for g in m.groups() if g) if m else ""
        elif "registers" in line or "spill" in line:
            out.append((entry, line.strip()))
    return out


def paged_plan_line(torch, paged_mod, kernel, b, sq, h, hkv, p, ps, dh,
                    dtype) -> str:
    """The plan of one paged call and its split and merge kernels'
    registers and spills (ptxas)."""
    plan = paged_mod.plan_page_splits(
        b, sq, h, hkv, p, ps,
        torch.cuda.get_device_properties(0).multi_processor_count)
    kdim = 64 if dh <= 64 else 128 if dh <= 128 else 256
    tname = "If" if dtype == torch.float32 else "bfloat16"
    lines = ptxas_lines()
    split = [ln for e, ln in lines if e.startswith(kernel + "I")
             and tname in e and f"Li{kdim}E" in e]
    merge = [ln for e, ln in lines
             if e.startswith(kernel.replace("_kernel", "_merge_kernel") + "I")
             and tname in e]
    missing = "not in this run's build log"
    used = f"; merge: {' / '.join(merge) or missing}" \
        if plan.n_splits > 1 else " (one split: no merge)"
    return (f"plan: {plan.n_splits} splits of {plan.pages_per_split} pages, "
            f"{plan.blocks} blocks ({plan.row_blocks} row blocks); "
            f"{kernel} ({str(dtype)[6:]}, Dh template {kdim}): "
            f"{' / '.join(split) or missing}{used}")


def paged_inputs(torch, gen, b, hkv, dh, ps, p, dtype):
    """K/V pools of b * p pages (plus the trash page) and a random page
    table over them."""
    n_pool = b * p
    tables = torch.randperm(n_pool, generator=gen, device="cuda").reshape(
        b, p).to(torch.int32).contiguous()
    kp = torch.randn(n_pool + 1, ps, hkv, dh, generator=gen,
                     device="cuda").to(dtype)
    vp = torch.randn(n_pool + 1, ps, hkv, dh, generator=gen,
                     device="cuda").to(dtype)
    return kp, vp, tables


def same_bits(name, got, fn):
    """A second call on the same inputs must give the same bits."""
    import torch
    if not torch.equal(fn(), got):
        raise AssertionError(f"{name}: the same inputs gave other bits")


def check_paged(torch, ops, paged_mod, gen) -> dict:
    """The decode kernel against its plain version at PAGED_SHAPES and
    PAGED_VARIANTS, float32 and bf16, each case twice for the same bits,
    length-0 rows exact zeros; timed at the shapes of 13 or more pages."""
    log("paged_attention (decode, one token a row; split over runs of pages, "
        "then merged):")
    row = None
    for label, b, hkv, g, dh, ps, p, lens, _, _ in PAGED_SHAPES \
            + PAGED_VARIANTS:
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        log(f"  {label}: B={b}, Hkv={hkv}, G={g}, Dh={dh}, {p} pages of "
            f"{ps}, lengths={list(lens)}")
        for dtype in (torch.float32, torch.bfloat16):
            kp, vp, tables = paged_inputs(torch, gen, b, hkv, dh, ps, p,
                                          dtype)
            q = torch.randn(b, hkv * g, dh, generator=gen,
                            device="cuda").to(dtype)
            call = lambda: ops.paged_attention(q, kp, vp, tables, lengths,
                                               page_size=ps)
            want = paged_mod.paged_attention_plain(q, kp, vp, tables, lengths)
            got = call()
            err = compare(f"{dtype}", got, want)
            same_bits(f"paged_attention {label}", got, call)
            if bool((got[lengths == 0] != 0).any()):
                raise AssertionError("a length-0 row must give exact zeros")
            log("    " + paged_plan_line(torch, paged_mod, "paged_attn_kernel",
                                         b, 1, hkv * g, hkv, p, ps, dh,
                                         dtype))
            if dtype != torch.float32 or p < 13:
                continue
            ms = time_ms(call)
            plain_ms = time_ms(lambda: paged_mod.paged_attention_plain(
                q, kp, vp, tables, lengths))
            tokens = int(lengths.sum())
            moved = (2 * nbytes(q) + nbytes(tables, lengths)
                     + 2 * tokens * hkv * dh * q.element_size())
            bd = bound(moved, 4 * tokens * hkv * g * dh, dtype)
            log(f"    ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms null "
                f"(no single PyTorch call reads through page tables) "
                f"bound_ms {bd['bound_ms']:.5f} ({bd['bound_by']})")
            if row is None:
                row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "library_ms": None, **bd}
    log("  the same bits on a second call: every case above")
    return row


def kernel_names(torch, fn) -> str:
    """The CUDA kernels torch.profiler sees for one call of ``fn``, by
    device time: which backend a library call took."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == cuda and e.self_device_time_total > 0),
                    key=lambda e: -e.self_device_time_total)
    return "; ".join(e.key[:100] for e in events[:3]) or "none seen"


def time_flash(torch, ops, flash_mod, q, k, v, kw, err) -> dict:
    """Kernel, plain and library times of one flash call, its bound, and
    the split plan. The library time is the faster of two SDPA calls:
    enable_gqa with the boolean mask, and K/V expanded to H heads outside
    the timed call (as recon_agg's P, Q are pre-folded); each call's
    backend is printed."""
    import torch.nn.functional as F
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    ms = time_ms(lambda: ops.flash_attention(q, k, v, **kw))
    plain_ms = time_ms(lambda: flash_mod.flash_attention_plain(q, k, v,
                                                               **kw))
    vis = flash_mod.visibility(kw["q_offset"], sq, skv, b, True,
                               kw["window"], q.device)
    qt = q.transpose(1, 2).contiguous()
    kt = k.transpose(1, 2).contiguous()
    vt = v.transpose(1, 2).contiguous()
    ke = kt.repeat_interleave(h // hkv, dim=1).contiguous()
    ve = vt.repeat_interleave(h // hkv, dim=1).contiguous()
    mask = vis[:, None]
    calls = {"enable_gqa": lambda: F.scaled_dot_product_attention(
                 qt, kt, vt, attn_mask=mask, enable_gqa=True),
             "K/V expanded": lambda: F.scaled_dot_product_attention(
                 qt, ke, ve, attn_mask=mask)}
    lib_ms = {}
    for name, fn in calls.items():
        lib_ms[name] = time_ms(fn)
        log(f"    SDPA ({name}, boolean mask): {lib_ms[name]:.4f} ms; "
            f"kernels: {kernel_names(torch, fn)}")
    library_ms = min(lib_ms.values())
    plan = flash_mod.plan_splits(b, sq, skv, h, hkv, causal=True,
                                 window=kw["window"],
                                 q_offset=kw["q_offset"],
                                 target_blocks=torch.cuda.get_device_properties(
                                     0).multi_processor_count)
    keys = int(vis.any(1).sum())
    moved = 2 * nbytes(q) + 2 * keys * hkv * d * q.element_size()
    bd = bound(moved, 4 * int(vis.sum()) * h * d, q.dtype)
    log(f"    ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
        f"{library_ms:.4f} (the faster SDPA call) bound_ms "
        f"{bd['bound_ms']:.5f} ({bd['bound_by']}); plan: keys "
        f"[{plan.kbeg}, {plan.kend}) in {plan.n_splits} splits of "
        f"{plan.split_len}, {plan.blocks} blocks")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, **bd}


def check_flash(torch, ops, flash_mod, gen) -> dict:
    log("flash_attention (prefill chunk: Sq=64, H=8, Hkv=1, D=256, "
        "Skv=208 gathered pages):")
    row = None

    def again(kw, q, k, v):
        return lambda: ops.flash_attention(q, k, v, **kw)

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
            same_bits("flash_attention", got, again(kw, q, k, v))
            if dtype == torch.float32 and label == cases[0][0]:
                row = time_flash(torch, ops, flash_mod, q, k, v, kw, err)
    log("  the same bits on a second call: every case above")

    log("flash_attention (long prompt, its last chunk: Sq=64, H=8, Hkv=1, "
        "D=256, Skv=2048, q_offset 1984):")
    q = torch.randn(1, 64, 8, 256, generator=gen, device="cuda")
    k = torch.randn(1, 2048, 1, 256, generator=gen, device="cuda")
    v = torch.randn(1, 2048, 1, 256, generator=gen, device="cuda")
    kw = dict(causal=True, window=None, q_offset=1984)
    got = ops.flash_attention(q, k, v, **kw)
    err = compare("torch.float32 long prompt", got,
                  flash_mod.flash_attention_plain(q, k, v, **kw))
    same_bits("flash_attention", got, again(kw, q, k, v))
    time_flash(torch, ops, flash_mod, q, k, v, kw, err)

    # every other variant the source builds: the head-dim templates 128
    # and 64, element-wise staging (D not a multiple of the 16-byte
    # vector), and the one-split path that writes the output without the
    # merge
    log("flash_attention, the other variants built:")
    for label, (b, sq, h, hkv, d, skv, off, window) in (
            ("D 128, Hkv 2, per-row offsets (5, 250)",
             (2, 37, 8, 2, 128, 300, (5, 250), None)),
            ("D 64, G 3, offset 40, window 20",
             (1, 50, 3, 1, 64, 90, 40, 20)),
            ("D 30 (template 64, element-wise staging), G 2, suffix",
             (1, 9, 4, 2, 30, 40, None, None)),
            ("one split (no merge): Sq 600, G 8, Skv 32, offset 0",
             (1, 600, 8, 1, 256, 32, 0, None))):
        if isinstance(off, tuple):
            off = torch.tensor(off, dtype=torch.int32, device="cuda")
        kw = dict(causal=True, window=window, q_offset=off)
        plan = flash_mod.plan_splits(
            b, sq, skv, h, hkv, causal=True, window=window, q_offset=off,
            target_blocks=torch.cuda.get_device_properties(
                0).multi_processor_count)
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn(b, sq, h, d, generator=gen,
                            device="cuda").to(dtype)
            k = torch.randn(b, skv, hkv, d, generator=gen,
                            device="cuda").to(dtype)
            v = torch.randn(b, skv, hkv, d, generator=gen,
                            device="cuda").to(dtype)
            got = ops.flash_attention(q, k, v, **kw)
            compare(f"{dtype} {label} ({plan.n_splits} splits)", got,
                    flash_mod.flash_attention_plain(q, k, v, **kw))
            same_bits("flash_attention", got, again(kw, q, k, v))
    return row


def check_verify(torch, ops, verify_mod, paged_mod, gen) -> dict:
    """The verify kernel (Sq = 5) against its plain version at PAGED_SHAPES
    and PAGED_VARIANTS, float32 and bf16, each case twice for the same bits,
    length-0 rows exact zeros; at Sq = 1 with q_offsets = lengths - 1
    against the decode kernel; timed at the shapes of 13 or more pages."""
    log("paged_verify_attention (verify, Sq=5 tokens a row; split over runs "
        "of pages, then merged):")
    row = None
    sq = 5
    for label, b, hkv, g, dh, ps, p, lens1, offs, nv in PAGED_SHAPES \
            + PAGED_VARIANTS:
        offs = torch.tensor(offs, dtype=torch.int32, device="cuda")
        nv = torch.tensor(nv, dtype=torch.int32, device="cuda")
        lengths = torch.where(nv > 0, offs + nv, 0).to(torch.int32)
        log(f"  {label}: B={b}, Hkv={hkv}, G={g}, Dh={dh}, {p} pages of "
            f"{ps}, q_offsets={offs.tolist()} lengths={lengths.tolist()}")
        for dtype in (torch.float32, torch.bfloat16):
            kp, vp, tables = paged_inputs(torch, gen, b, hkv, dh, ps, p,
                                          dtype)
            q = torch.randn(b, sq, hkv * g, dh, generator=gen,
                            device="cuda").to(dtype)
            args = (q, kp, vp, tables, lengths, offs)
            call = lambda: ops.paged_verify_attention(*args, page_size=ps)
            want = verify_mod.paged_verify_attention_plain(*args)
            got = call()
            err = compare(f"{dtype}", got, want)
            same_bits(f"paged_verify_attention {label}", got, call)
            if bool((got[lengths == 0] != 0).any()):
                raise AssertionError("a length-0 row must give exact zeros")
            log("    " + paged_plan_line(torch, paged_mod,
                                         "paged_verify_kernel", b, sq,
                                         hkv * g, hkv, p, ps, dh, dtype))
            if dtype != torch.float32:
                continue
            # one token per row at q_offsets = lengths - 1 is decode attention
            l1 = torch.tensor(lens1, dtype=torch.int32, device="cuda")
            o1 = torch.clamp(l1 - 1, min=0).to(torch.int32)
            ver = ops.paged_verify_attention(q[:, :1].contiguous(), kp, vp,
                                             tables, l1, o1,
                                             page_size=ps)[:, 0]
            dec = ops.paged_attention(q[:, 0].contiguous(), kp, vp, tables,
                                      l1, page_size=ps)
            torch.cuda.synchronize()
            d1 = float((ver - dec).abs().max())
            ok = d1 <= 1e-6
            log(f"    Sq=1 at q_offsets = lengths - 1 against the decode "
                f"kernel: max_abs_err {d1:.3e} (tolerance 1e-6, "
                f"bit-identical {bool(torch.equal(ver, dec))}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("verify kernel at Sq=1 disagrees with "
                                     "the decode kernel")
            if p < 13:
                continue
            ms = time_ms(call)
            plain_ms = time_ms(lambda: verify_mod.paged_verify_attention_plain(
                *args))
            # K/V read once up to each row's frontier; every query token
            # sees the positions up to its own (and below the length)
            front = torch.clamp(torch.minimum(lengths, offs + sq), min=0)
            seen = torch.minimum(lengths[:, None], offs[:, None] + 1
                                 + torch.arange(sq, device="cuda")[None, :])
            seen = torch.where(lengths[:, None] > 0, seen, 0)
            moved = (2 * nbytes(q) + nbytes(tables, lengths, offs)
                     + 2 * int(front.sum()) * hkv * dh * q.element_size())
            bd = bound(moved, 4 * int(seen.sum()) * hkv * g * dh, dtype)
            log(f"    ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms null "
                f"(no single PyTorch call reads through page tables) "
                f"bound_ms {bd['bound_ms']:.5f} ({bd['bound_by']})")
            if row is None:
                row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "library_ms": None, **bd}
    log("  the same bits on a second call: every case above")
    return row


# (label, M, K, N, R): the training path's shape, two ragged ones (the
# second with K and N not multiples of 4: the kernels with element loads)
# and the merged-weight oracle's M = 1 on Gemma-2B's widths
LORA_SHAPES = [
    ("training: 16 x 32 tokens through a q or v projection of "
     "RoBERTa-large", 512, 1024, 1024, 8),
    ("ragged", 500, 1000, 1000, 6),
    ("ragged, element loads", 37, 999, 1001, 5),
    ("M = 1, Gemma-2B q and o (oracle)", 1, 2048, 2048, 8),
    ("M = 1, Gemma-2B k and v (oracle)", 1, 2048, 256, 8),
]


def lora_plan_line(torch, lora_mod, op, plan, dtype, vec, r) -> str:
    """The plan of one forward or dx call and the ptxas registers and
    spills of the kernels it launches (the bottleneck, the tile GEMM in
    the instantiation ``vec`` picks, the merge where it splits)."""
    tname = "f" if dtype == torch.float32 else "13__nv_bfloat16"
    rmax = next(t for t in (8, 16, 32, 64) if r <= t)
    flag = f"Lb{int(vec)}E"
    if op == "forward":
        entries = [f"lora_xa_kernelI{tname}Li{rmax}E",
                   f"lora_fwd_kernelI{tname}{flag}"]
        merge = f"lora_fwd_merge_kernelI{tname}E"
    else:
        entries = [f"lora_g_kernelILi{rmax}E", f"lora_dx_kernelI{flag}"]
        merge = "lora_dx_merge_kernel"
    if plan.n_splits > 1:
        entries.append(merge)
    lines = ptxas_lines()
    regs = []
    for entry in entries:
        found = [ln.replace("ptxas info    : ", "") for e, ln in lines
                 if e == entry]
        regs.append(f"{entry}: {' / '.join(found) or 'not in this build log'}")
    return (f"plan: tile {lora_mod.TILE[0]} x {lora_mod.TILE[1]}, "
            f"{plan.n_splits} splits of {plan.k_per_split}, {plan.blocks} "
            f"GEMM blocks ({plan.tiles_m} x {plan.tiles_n} tiles), "
            f"{'16-byte' if vec else 'element'} loads; " + "; ".join(regs))


def check_lora_matmul(torch, ops, lora_mod, gen) -> dict:
    """The lora_matmul kernels: forward (float32 and bf16) and dx at
    LORA_SHAPES against their plain versions, each case twice for the same
    bits, with the plan and the kernels' registers; each shape also with
    the other split count (one split where the plan splits, two where it
    does not), and with x and dy one element off 16-byte alignment
    (element loads); times at the training path's shape and at M = 1; the backward
    through ``apply_lora``'s autograd Function against autograd through the
    plain version; then every other rank variant built, forward and
    backward, at a ragged shape. Returns the three kernels' rows."""
    from repro_torch.core import lora as lora_lib
    from repro_torch.kernels import _build
    log("lora_matmul (training: x (512, 1024), W0 (1024, 1024), R 8, "
        "scale 2):")
    rows = {}
    why = "float32 sums of K (xa), N (dx, g) or M (dA, dB) products in " \
          "another order"
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def inputs(m, k, n, r, dtype):
        x = torch.randn(m, k, generator=gen, device="cuda")
        w0 = torch.randn(k, n, generator=gen, device="cuda") / math.sqrt(k)
        a = torch.randn(k, r, generator=gen, device="cuda") / math.sqrt(k)
        b = 0.05 * torch.randn(r, n, generator=gen, device="cuda")
        return [t.to(dtype).contiguous() for t in (x, w0, a, b)]

    def off16(t):
        """A copy of t whose data starts one element past 16-byte
        alignment."""
        buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
        skip = (-buf.data_ptr() % 16) // t.element_size() + 1
        view = buf[skip:skip + t.numel()].view(t.shape)
        view.copy_(t)
        return view

    scale = torch.tensor(2.0, device="cuda")
    lib = _build.load()
    for label, m, k, n, r in LORA_SHAPES:
        log(f"  {label}: x ({m}, {k}), W0 ({k}, {n}), R {r}")
        for dtype in (torch.float32, torch.bfloat16):
            x, w0, a, b = inputs(m, k, n, r, dtype)
            want, xa_ref = lora_mod.lora_matmul_parts(x, w0, a, b, scale)
            call = lambda: ops.lora_matmul(x, w0, a, b, scale, return_xa=True)
            got, xa = call()
            err = compare(f"{dtype} forward", got, want)
            compare_scaled("    xa", xa, xa_ref, 1e-5, why)
            same_bits("lora_matmul forward", torch.cat(
                [got.float().flatten(), xa.flatten()]),
                lambda: torch.cat([t.float().flatten() for t in call()]))
            plan = lora_mod.plan_splits(m, n, k, sms)
            vec = lora_mod.vector_loads(x.element_size(), k, n, (
                x.data_ptr(), w0.data_ptr(), got.data_ptr()))
            log("    " + lora_plan_line(torch, lora_mod, "forward", plan,
                                        dtype, vec, r))
            other = lora_mod.split_plan(m, n, k,
                                        1 if plan.n_splits > 1 else 2)
            o_call = lambda: lora_mod.launch(lib, x, w0, a, b, scale,
                                             plan=other)
            got_o = o_call()
            compare(f"{dtype} forward, {other.n_splits} splits of "
                    f"{other.k_per_split}", got_o, want)
            same_bits("lora_matmul forward, other split", got_o, o_call)
            xo = off16(x)
            o_call = lambda: ops.lora_matmul(xo, w0, a, b, scale)
            got_o = o_call()
            compare(f"{dtype} forward, x one element off 16-byte alignment "
                    f"(element loads)", got_o, want)
            same_bits("lora_matmul forward, element loads", got_o, o_call)
            if dtype == torch.float32 and m == 512:
                ms = time_ms(call)
                plain_ms = time_ms(lambda: lora_mod.lora_matmul_parts(
                    x, w0, a, b, scale))
                cublas_ms = time_ms(lambda: x @ w0)
                ops_n = 2 * m * k * n + 2 * m * r * (k + n)
                bd = bound(nbytes(x, w0, a, b, got, xa), ops_n, dtype)
                log(f"    ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
                    f"null (no single PyTorch call computes the fused "
                    f"function; cuBLAS x @ W0 alone {cublas_ms:.4f} ms) "
                    f"bound_ms {bd['bound_ms']:.5f} ({bd['bound_by']})")
                rows["lora_matmul"] = {"max_abs_err": err, "ms": ms,
                                       "plain_ms": plain_ms,
                                       "library_ms": None, **bd}
            elif dtype == torch.float32 and m == 1:
                plain_ms = time_ms(lambda: lora_mod.lora_matmul_parts(
                    x, w0, a, b, scale))
                log(f"    ms {time_ms(call):.4f} plain_ms {plain_ms:.4f} "
                    f"cuBLAS x @ W0 alone {time_ms(lambda: x @ w0):.4f}")
            if dtype != torch.float32:
                continue            # the backward takes float32 only
            dy = torch.randn(m, n, generator=gen, device="cuda")
            dx_ref, g_ref = lora_mod.lora_matmul_dx_plain(dy, w0, a, b,
                                                          scale)
            call = lambda: ops.lora_matmul_dx(dy, w0, a, b, scale)
            dx, g = call()
            dx_err = compare_scaled("  dx", dx, dx_ref, 1e-5, why)
            compare_scaled("    g", g, g_ref, 1e-5, why)
            same_bits("lora_matmul_dx", torch.cat([dx.flatten(),
                                                   g.flatten()]),
                      lambda: torch.cat([t.flatten() for t in call()]))
            g_call = lambda: ops.lora_matmul_dx(dy, w0, a, b, scale,
                                                need_dx=False)[1]
            g_only = g_call()
            compare_scaled("    g alone (dx skipped)", g_only, g_ref, 1e-5,
                           why)
            same_bits("lora_matmul_dx g alone", g_only, g_call)
            plan = lora_mod.plan_splits(m, k, n, sms)
            vec = lora_mod.vector_loads(4, n, k, (dy.data_ptr(),
                                                  w0.data_ptr(),
                                                  dx.data_ptr()))
            log("    " + lora_plan_line(torch, lora_mod, "dx", plan, dtype,
                                        vec, r))
            other = lora_mod.split_plan(m, k, n,
                                        1 if plan.n_splits > 1 else 2)
            o_call = lambda: lora_mod.launch_dx(lib, dy, w0, a, b, scale,
                                                plan=other)[0]
            got_o = o_call()
            compare_scaled(f"    dx, {other.n_splits} splits of "
                           f"{other.k_per_split}", got_o, dx_ref, 1e-5, why)
            same_bits("lora_matmul_dx, other split", got_o, o_call)
            dyo = off16(dy)
            o_call = lambda: ops.lora_matmul_dx(dyo, w0, a, b, scale)[0]
            got_o = o_call()
            compare_scaled("    dx, dy one element off 16-byte alignment "
                           "(element loads)", got_o, dx_ref, 1e-5, why)
            same_bits("lora_matmul_dx, element loads", got_o, o_call)
            if m == 512:
                ms, plain_ms = time_ms(call), time_ms(
                    lambda: lora_mod.lora_matmul_dx_plain(dy, w0, a, b,
                                                          scale))
                cublas_ms = time_ms(lambda: dy @ w0.T)
                bd = bound(nbytes(dy, w0, a, b, dx, g),
                           2 * m * n * k + 2 * m * r * (n + k),
                           torch.float32)
                log(f"    dx: ms {ms:.4f} plain_ms {plain_ms:.4f} "
                    f"library_ms null (no single PyTorch call; cuBLAS "
                    f"dy @ W0^T alone {cublas_ms:.4f} ms; g alone "
                    f"{time_ms(g_call):.4f} ms) bound_ms "
                    f"{bd['bound_ms']:.5f} ({bd['bound_by']})")
                rows["lora_matmul_dx"] = {"max_abs_err": dx_err, "ms": ms,
                                          "plain_ms": plain_ms,
                                          "library_ms": None, **bd}
            elif m == 1:
                plain_ms = time_ms(lambda: lora_mod.lora_matmul_dx_plain(
                    dy, w0, a, b, scale))
                log(f"    dx: ms {time_ms(call):.4f} plain_ms "
                    f"{plain_ms:.4f} cuBLAS dy @ W0^T alone "
                    f"{time_ms(lambda: dy @ w0.T):.4f}")
    log("  the same bits on a second call: every case above")

    # backward at the path's shape, rank 6 of r_max 8: through apply_lora
    # (the Function, so the kernels) against autograd of the plain version
    m, k, n, rank = 512, 1024, 1024, 6
    x, w0, a, b = inputs(m, k, n, 8, torch.float32)
    dy = torch.randn(m, n, generator=gen, device="cuda")
    mask = lora_lib.make_rank_mask(rank, 8, device="cuda")
    grads = {}
    for label, use_kernel in (("kernel", True), ("plain", False)):
        xl, al, bl = (t.clone().requires_grad_(True) for t in (x, a, b))
        if use_kernel:
            y = lora_lib.apply_lora(xl, w0, {"A": al, "B": bl, "mask": mask},
                                    16.0)
        else:
            am, bm = lora_lib.masked_factors({"A": al, "B": bl, "mask": mask})
            y = lora_mod.lora_matmul_plain(xl, w0, am, bm,
                                           16.0 / rank)
        y.backward(dy)
        grads[label] = (xl.grad, al.grad, bl.grad)
    errs = [compare_scaled(f"{name} (rank {rank} of 8, through apply_lora)",
                           g, p, 1e-5, why)
            for name, g, p in zip(("dx", "dA", "dB"), grads["kernel"],
                                  grads["plain"])]
    ga, gb = grads["kernel"][1], grads["kernel"][2]
    if bool(ga[:, rank:].any()) or bool(gb[rank:, :].any()):
        raise AssertionError("masked rank directions got a nonzero gradient")
    log(f"  masked directions (A columns, B rows {rank}..7): gradient "
        f"exactly 0")
    am, bm = a * mask, b * mask[:, None]
    # g alone on masked factors: layer 0's dx op in training
    g_call = lambda: ops.lora_matmul_dx(dy, w0, am, bm, scale,
                                        need_dx=False)[1]
    g_only = g_call()
    _, g_ref = lora_mod.lora_matmul_dx_plain(dy, w0, am, bm, scale,
                                             need_dx=False)
    compare_scaled(f"g alone (dx skipped; rank {rank} of 8)", g_only, g_ref,
                   1e-5, why)
    same_bits("lora_matmul_dx g alone, masked factors", g_only, g_call)
    _, xa = ops.lora_matmul(x, w0, am, bm, scale, return_xa=True)
    _, g = ops.lora_matmul_dx(dy, w0, am, bm, scale)
    call = lambda: ops.lora_matmul_grad_ab(x, xa, dy, g, scale)
    da, db = call()
    same_bits("lora_matmul_grad_ab", torch.cat([da.flatten(), db.flatten()]),
              lambda: torch.cat([t.flatten() for t in call()]))
    r = 8
    ms = time_ms(call)
    plain_ms = time_ms(lambda: lora_mod.lora_matmul_grad_ab_plain(
        x, xa, dy, g, scale))
    bd = bound(nbytes(x, xa, dy, g) + (k * r + r * n) * 4,
               2 * m * r * (k + n), torch.float32)
    log(f"  lora_matmul_grad_ab: ms {ms:.4f} plain_ms {plain_ms:.4f} "
        f"library_ms null (no single PyTorch call) bound_ms "
        f"{bd['bound_ms']:.5f} ({bd['bound_by']})")
    rows["lora_matmul_grad_ab"] = {"max_abs_err": max(errs[1:]), "ms": ms,
                                   "plain_ms": plain_ms, "library_ms": None,
                                   **bd}

    # every other rank variant the source builds (RMAX 16, 32, 64; the
    # ranks are not multiples of 8, so the rank edge is masked too) at the
    # ragged shape: the forward in float32 and bf16, dx, g, g alone and
    # dA/dB (float32: the backward refuses bf16) against the plain versions
    m, k, n = 500, 1000, 1000
    for r in (13, 29, 64):
        x, w0, a, b = inputs(m, k, n, r, torch.float32)
        xb, w0b, ab, bb = (t.to(torch.bfloat16) for t in (x, w0, a, b))
        call = lambda: ops.lora_matmul(xb, w0b, ab, bb, scale)
        got = call()
        compare(f"torch.bfloat16 forward ({m}, {k}) x ({k}, {n}) R {r}",
                got, lora_mod.lora_matmul_plain(xb, w0b, ab, bb, scale))
        same_bits(f"bf16 forward R {r}", got, call)
        call = lambda: ops.lora_matmul(x, w0, a, b, scale, return_xa=True)
        y, xa = call()
        y_ref, xa_ref = lora_mod.lora_matmul_parts(x, w0, a, b, scale)
        compare(f"torch.float32 forward ({m}, {k}) x ({k}, {n}) R {r}", y,
                y_ref)
        compare_scaled("    xa", xa, xa_ref, 1e-5, why)
        same_bits(f"forward R {r}", torch.cat([y.flatten(), xa.flatten()]),
                  lambda: torch.cat([t.flatten() for t in call()]))
        dy = torch.randn(m, n, generator=gen, device="cuda")
        call = lambda: ops.lora_matmul_dx(dy, w0, a, b, scale)
        dx, g = call()
        same_bits(f"dx R {r}", torch.cat([dx.flatten(), g.flatten()]),
                  lambda: torch.cat([t.flatten() for t in call()]))
        dx_ref, g_ref = lora_mod.lora_matmul_dx_plain(dy, w0, a, b, scale)
        g_call = lambda: ops.lora_matmul_dx(dy, w0, a, b, scale,
                                            need_dx=False)[1]
        g_only = g_call()
        same_bits(f"g alone R {r}", g_only, g_call)
        call = lambda: ops.lora_matmul_grad_ab(x, xa_ref, dy, g_ref, scale)
        da, db = call()
        same_bits(f"dA/dB R {r}", torch.cat([da.flatten(), db.flatten()]),
                  lambda: torch.cat([t.flatten() for t in call()]))
        da_ref, db_ref = lora_mod.lora_matmul_grad_ab_plain(x, xa_ref, dy,
                                                            g_ref, scale)
        for name, got, want in (("dx", dx, dx_ref), ("g", g, g_ref),
                                ("g alone", g_only, g_ref), ("dA", da, da_ref),
                                ("dB", db, db_ref)):
            compare_scaled(f"    {name} (R {r})", got, want, 1e-5, why)
    return rows


def check_recon_agg(torch, ops, recon_mod, gen) -> dict:
    """recon_agg at the server's shapes on RoBERTa-large (48 items: q and v
    x 24 layers, d 1024, r_max 8) with phase 6's cohort (Kc 4, the main
    path's shape, whose row this returns) and bench_server.py's (Kc 20);
    then ragged, in the single-item form and at rank 16. Every output is
    held to the plain version to 1e-5 of its largest value: float32 sums
    of Kc·R products in another order."""
    log("recon_agg (server Eq. 2: 48 items, d 1024, R 8):")
    why = "float32 sums of Kc*R products in another order"
    row = None

    def inputs(bt, kc, d_in, r, d_out):
        a = torch.randn(bt, kc, d_in, r, generator=gen,
                        device="cuda") / math.sqrt(d_in)
        b = 0.05 * torch.randn(bt, kc, r, d_out, generator=gen,
                               device="cuda")
        eta = torch.rand(bt, kc, generator=gen, device="cuda") + 0.5
        return a, b, eta

    for kc in (4, 20):
        a, b, eta = inputs(48, kc, 1024, 8, 1024)
        got = ops.recon_agg(a, b, eta)
        err = compare_scaled(f"batched (48, {kc}, 1024, 8) -> 1024", got,
                             recon_mod.recon_agg_plain(a, b, eta), 1e-5, why)
        if not torch.equal(ops.recon_agg(a, b, eta), got):
            raise AssertionError("recon_agg: the same inputs gave other bits")
        ms = time_ms(lambda: ops.recon_agg(a, b, eta))
        plain_ms = time_ms(lambda: recon_mod.recon_agg_plain(a, b, eta))
        # the library call: one torch.bmm on the factors pre-folded into
        # P (48, 1024, Kc*R) and Q (48, Kc*R, 1024)
        p = (a * eta[..., None, None]).permute(0, 2, 1, 3).reshape(
            48, 1024, kc * 8).contiguous()
        q = b.reshape(48, kc * 8, 1024).contiguous()
        library_ms = time_ms(lambda: torch.bmm(p, q))
        bd = bound(nbytes(a, b, eta, got), 2 * 48 * kc * 1024 * 1024 * 8,
                   torch.float32)
        log(f"    ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
            f"{library_ms:.4f} (torch.bmm of the pre-folded P, Q) bound_ms "
            f"{bd['bound_ms']:.5f} ({bd['bound_by']})")
        if kc == 4:
            row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "library_ms": library_ms, **bd}
    for label, shape in (("ragged", (3, 5, 1000, 6, 1000)),
                         ("ragged rank 16", (2, 3, 777, 16, 515)),
                         ("rank 16", (48, 4, 1024, 16, 1024))):
        a, b, eta = inputs(*shape)
        compare_scaled(f"{label} {shape[:4]} -> {shape[4]}",
                       ops.recon_agg(a, b, eta),
                       recon_mod.recon_agg_plain(a, b, eta), 1e-5, why)
    a, b, eta = inputs(1, 5, 1000, 6, 1000)
    single = ops.recon_agg(a[0], b[0], eta[0])
    if single.shape != (1000, 1000):
        raise AssertionError(f"single-item form gave {tuple(single.shape)}")
    compare_scaled("single item (5, 1000, 6) -> 1000", single,
                   recon_mod.recon_agg_plain(a, b, eta)[0], 1e-5, why)
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
              "paged_verify_attention": 0,     # plain decode: no verify
              # the engine's adapters go through BGMV, not apply_lora
              "lora_matmul": 0, "lora_matmul_dx": 0,
              "lora_matmul_grad_ab": 0,
              "recon_agg": 0}                  # server aggregation only
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

    ops.reset_launches()
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
        f"exact in {time.perf_counter() - t0:.1f} s; its zeroed live "
        f"adapters launched lora_matmul {ops.LAUNCHES['lora_matmul']} times "
        f"(M = 1, 4 per layer and token)")
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
    steps0, chunks0 = engine.steps, engine.prefill_calls
    events = profile_window(torch, "admission + prefill", engine.step_batch)
    chunks = engine.prefill_calls - chunks0
    flash = [(ms, n) for key, ms, n in events if "flash_" in key]
    flash_ms = sum(ms for ms, _ in flash)
    log(f"  flash kernels in that window: {flash_ms:.3f} ms of device time, "
        f"{sum(n for _, n in flash)} launches, over {chunks} prefill chunks: "
        f"{flash_ms / max(chunks, 1):.4f} ms per chunk")
    events = profile_window(torch, step, engine.run)
    n = max(engine.steps - steps0 - 1, 1)
    paged = [(ms, c) for key, ms, c in events if "paged_" in key]
    paged_ms = sum(ms for ms, _ in paged)
    log(f"  ({step} window: {engine.steps - steps0 - 1} steps; the paged "
        f"attention kernels {paged_ms:.3f} ms of device time, "
        f"{sum(c for _, c in paged)} launches: {paged_ms / n:.4f} ms per "
        f"step)")


SERVE_GROUPS = {"port kernels": ("bgmv_kernel", "paged_attn_kernel",
                                  "paged_attn_merge_kernel",
                                  "flash_split_kernel", "flash_merge_kernel",
                                  "paged_verify_kernel",
                                  "paged_verify_merge_kernel"),
                "GEMM/GEMV": ("gemm", "gemv", "Gemv", "Gemm")}


def serve_group(key: str) -> str:
    return next((g for g, keys in SERVE_GROUPS.items()
                 if any(k in key for k in keys)), "other")


TRAIN_GROUPS = {"lora_matmul": ("lora_xa_kernel", "lora_fwd_kernel",
                                "lora_fwd_merge_kernel"),
                "lora_matmul_dx": ("lora_g_kernel", "lora_dx_kernel",
                                   "lora_dx_merge_kernel"),
                "lora_matmul_grad_ab": ("lora_grad_ab_kernel",),
                "cuBLAS GEMM": ("gemm", "gemv", "Gemv", "Gemm")}


def train_group(key: str) -> str:
    """Device time groups of a training step: the three lora ops' kernels
    (by their entry names: each of the forward and dx runs its bottleneck
    kernel, its tile GEMM and, where the plan splits, its merge; at layer
    0 the dx op runs lora_g_kernel alone), cuBLAS, the rest."""
    return next((g for g, keys in TRAIN_GROUPS.items()
                 if any(k in key for k in keys)), "other")


def profile_window(torch, label, fn, group=serve_group) -> list:
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
    by_group = {}
    for e in events:
        g = group(e.key)
        by_group[g] = by_group.get(g, 0.0) + e.self_device_time_total / 1e3
    events.sort(key=lambda e: -e.self_device_time_total)
    log(f"  profiled {label}: wall {wall * 1e3:.1f} ms, device busy "
        f"{device_ms:.1f} ms ({100 * device_ms / (wall * 1e3):.1f}% of "
        f"wall); device ms by group: "
        + ", ".join(f"{g} {v:.2f}" for g, v in by_group.items()))
    for e in events[:10]:
        log(f"    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  "
            f"{e.key[:90]}")
    return [(e.key, e.self_device_time_total / 1e3, e.count) for e in events]


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
                  "flash_attention": layers * chunks, "lora_matmul": 0,
                  "lora_matmul_dx": 0, "lora_matmul_grad_ab": 0,
                  "recon_agg": 0}
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


# ---------------------------------------------------------------------------
# phase 6: client training on full-width RoBERTa-large
# ---------------------------------------------------------------------------

# Card against CPU after one step at full width and depth: float32 sums in
# another order (kernels against MKL, 24 layers deep), so every compared
# leaf is held normwise, ||card - cpu|| <= TRAIN_REL * ||cpu||, and the
# loss to TRAIN_LOSS_ATOL. One AdamW step moves an element by about
# lr * g / (|g| + eps) (the first step's bias-corrected moments), so the
# stepped factors and head are held, per client and leaf, to TRAIN_REL of
# the CPU side's change: ||card - cpu|| <= TRAIN_REL * ||cpu - before||.
# A rounding-size gradient difference dg moves an element by at most
# lr * |dg| / eps, and only where |g| is near eps, while a missed or wrong
# update is of the order of the change itself. Elements whose update
# changed sign are counted.
TRAIN_REL = 1e-3
TRAIN_LOSS_ATOL = 1e-4


def rel_err(got, want) -> float:
    import torch
    return float(torch.linalg.vector_norm(got.double().cpu() - want.double())
                 / torch.linalg.vector_norm(want.double()))


def run_training(torch, np) -> tuple:
    """Phase 6. Returns the lora kernels' launches in the cohort call and
    the trained cohort on the card (config, factors, masks, shard sizes),
    which phase 7 aggregates."""
    from repro_torch.configs import get_config
    from repro_torch.core.lora import make_rank_mask
    from repro_torch.data import dirichlet_partition, make_pair_classification
    from repro_torch.fed import (SimConfig, client_params, evaluate,
                                 loss_and_grads, make_cohort_train,
                                 make_local_train, split_adapters,
                                 split_head, stack_client_data)
    from repro_torch.kernels import ops
    from repro_torch.models import model as model_lib
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.optim import adamw, tree_map
    from repro_torch.optim.optimizers import tree_leaves

    cfg = get_config("roberta-large")
    sim = SimConfig()                 # mrpc; 8 steps x 16 x 32; AdamW 3e-4
    ranks = (2, 4, 6, 8)
    L, r_max = cfg.num_layers, cfg.lora.r_max
    t0 = time.perf_counter()
    cpu = model_lib.init_params(cfg, seed=0, device="cpu")
    gpu = cpu.to_device("cuda")
    sides = (("cpu", "cpu"), ("card", "cuda"))     # (name, device)
    frozen = {"cpu": split_head(cpu)[0], "card": split_head(gpu)[0]}
    factors, _ = split_adapters(cpu.lora)
    init = {"factors": factors, "head": dict(cpu.cls)}
    masks = [{t: make_rank_mask(r, r_max).expand(L, r_max).clone()
              for t in cfg.lora.targets} for r in ranks]
    tokens, labels = make_pair_classification(
        sim.task, sim.num_examples, seed=sim.seed, vocab_size=cfg.vocab_size)
    shards = dirichlet_partition(labels, len(ranks), sim.dirichlet_alpha,
                                 seed=sim.seed)
    data = stack_client_data(tokens, labels, shards, range(len(ranks)), sim,
                             rnd=0)
    log(f"  roberta-large full width and depth: {cfg.param_count() / 1e6:.1f}"
        f" M params float32, LoRA on {cfg.lora.targets} r_max {r_max}, "
        f"client ranks {ranks}, shards {[len(x) for x in shards]}; set-up "
        f"{time.perf_counter() - t0:.1f} s")

    # (a) one step, card against CPU. B made trained-looking (small,
    # masked) so that every product of the backward carries signal.
    gen = torch.Generator().manual_seed(1)
    live = tree_map(lambda t: t.clone(), init)
    for t in cfg.lora.targets:
        live["factors"][t]["B"] = 0.05 * torch.randn(
            live["factors"][t]["B"].shape, generator=gen)
    worst = {"loss": 0.0, "grad": 0.0, "step": 0.0}
    t0 = time.perf_counter()
    for c, m in enumerate(masks):
        batch = {k: v[c, 0] for k, v in data.items()}
        res = {}
        for side, dev in sides:
            t1 = time.perf_counter()
            res[side] = loss_and_grads(
                frozen[side], tree_map(lambda t: t.to(dev), live),
                tree_map(lambda t: t.to(dev), m),
                {k: v.to(dev) for k, v in batch.items()}, cfg)
            torch.cuda.synchronize()
            res[side + "_s"] = time.perf_counter() - t1
        dl = abs(float(res["card"][0]) - float(res["cpu"][0]))
        worst["loss"] = max(worst["loss"], dl)
        errs = []
        for path, gg, gc in zip(_paths(res["cpu"][1]),
                                tree_leaves(res["card"][1]),
                                tree_leaves(res["cpu"][1])):
            errs.append(rel_err(gg, gc))
            if path[0] == "factors":
                dead = m[path[1]][0] == 0
                side = gg[..., dead] if path[2] == "A" else gg[:, dead, :]
                if bool(side.any()):
                    raise AssertionError(f"client {c}: masked {path} got a "
                                         f"nonzero gradient on the card")
        worst["grad"] = max(worst["grad"], max(errs))
        log(f"  (a) client {c} rank {ranks[c]}: loss card "
            f"{float(res['card'][0]):.6f} cpu {float(res['cpu'][0]):.6f} "
            f"(|diff| {dl:.2e}); gradient rel err per leaf max "
            f"{max(errs):.2e} over {len(errs)} leaves; step card "
            f"{res['card_s'] * 1e3:.1f} ms, cpu {res['cpu_s'] * 1e3:.0f} ms")
    one = {k: v[:, :1] for k, v in data.items()}
    stacked_live = tree_map(lambda t: torch.stack([t] * len(ranks)), live)
    stacked_masks = {t: torch.stack([m[t] for m in masks])
                     for t in cfg.lora.targets}
    after = {}
    for side, dev in sides:
        after[side] = make_cohort_train(cfg, adamw(sim.lr), device=dev)(
            frozen[side], tree_map(lambda t: t.to(dev), stacked_live),
            tree_map(lambda t: t.to(dev), stacked_masks), one)[0]
    flips = 0
    for path, gg, gc, g0 in zip(_paths(after["cpu"]),
                                tree_leaves(after["card"]),
                                tree_leaves(after["cpu"]),
                                tree_leaves(stacked_live)):
        du_g, du_c = gg.cpu() - g0, gc - g0
        flips += int(((du_g * du_c) < 0).sum())
        for c in range(len(ranks)):
            change = float(torch.linalg.vector_norm(du_c[c].double()))
            if change == 0.0:
                raise AssertionError(f"client {c}: {path} did not move")
            worst["step"] = max(worst["step"], float(torch.linalg.vector_norm(
                (du_g[c] - du_c[c]).double())) / change)
    log(f"  (a) after one AdamW step (lr {sim.lr}): ||card - cpu|| / ||cpu "
        f"change|| max {worst['step']:.2e} over clients and leaves; "
        f"elements whose update changed sign {flips}; in "
        f"{time.perf_counter() - t0:.1f} s")
    ok = (worst["loss"] <= TRAIN_LOSS_ATOL and worst["grad"] <= TRAIN_REL
          and worst["step"] <= TRAIN_REL)
    log(f"  (a) card against CPU: loss |diff| <= {TRAIN_LOSS_ATOL:.0e}, "
        f"gradients rel err <= {TRAIN_REL:.0e} of their norm, stepped "
        f"factors and head <= {TRAIN_REL:.0e} of the CPU side's change "
        f"(float32 sums in another order, 24 layers): "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"training step: card and CPU disagree {worst}")
    del cpu, frozen["cpu"], after

    # (b) a cohort on the card, from the initial factors (B = 0)
    trainable = tree_map(lambda t: torch.stack([t] * len(ranks)).to("cuda"),
                         init)
    cmasks = tree_map(lambda t: t.to("cuda"), stacked_masks)
    metrics = MetricsRegistry()
    cohort = make_cohort_train(cfg, adamw(sim.lr), device="cuda",
                               metrics=metrics)
    warm = make_local_train(cfg, adamw(sim.lr), device="cuda")   # cuBLAS
    warm(frozen["card"], tree_map(lambda t: t[0], trainable),
         tree_map(lambda t: t[0], cmasks), {k: v[0, :1] for k, v in
                                           data.items()})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 2**30
    ops.reset_launches()
    t0 = time.perf_counter()
    trained, losses = cohort(frozen["card"], trainable, cmasks, data)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    n_steps = len(ranks) * sim.local_steps
    per_step = 2 * L                 # q and v in every layer
    expect = {name: 0 for name in launches}
    expect.update(lora_matmul=per_step * n_steps,
                  lora_matmul_dx=per_step * n_steps,
                  lora_matmul_grad_ab=per_step * n_steps)
    log(f"  (b) launches {launches} over {n_steps} steps (expect "
        f"{per_step} of each lora kernel per step: q and v in {L} layers; "
        f"the dx kernel computes g alone at layer 0, whose input needs no "
        f"gradient)")
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != {expect}")
    step_h, loss_h = metrics.histogram("train.step_s"), \
        metrics.histogram("train.loss")
    step_losses = loss_h.values()
    if len(step_losses) != n_steps or not all(
            math.isfinite(v) for v in step_losses):
        raise AssertionError(f"per-step losses {step_losses}")
    for c, r in enumerate(ranks):
        for t in cfg.lora.targets:
            a, b = trained["factors"][t]["A"][c], trained["factors"][t]["B"][c]
            if not (torch.equal(a[..., r:], trainable["factors"][t]["A"][c][
                    ..., r:]) and not bool(b[:, r:, :].any())):
                raise AssertionError(f"client {c}: masked directions of {t} "
                                     f"moved")
    tokens_n = n_steps * sim.local_batch * data["tokens"].shape[-1]
    log(f"  (b) cohort of {len(ranks)} clients x {sim.local_steps} steps x "
        f"{sim.local_batch} x {data['tokens'].shape[-1]} tokens in "
        f"{wall:.3f} s: {tokens_n / wall:.1f} training tok/s; step p50 "
        f"{step_h.percentile(50) * 1e3:.3f} ms (n={step_h.count}, min "
        f"{step_h.vmin * 1e3:.3f}, max {step_h.vmax * 1e3:.3f}); peak memory "
        f"{peak_gb:.2f} GiB ({held_gb:.2f} GiB held before the call); "
        f"per-client mean loss "
        f"{[round(float(x), 5) for x in losses]}; every per-step loss finite "
        f"(first {step_losses[0]:.5f}, last {step_losses[-1]:.5f}); masked "
        f"directions bit-unchanged")
    ev_tokens, ev_labels = make_pair_classification(
        sim.task, sim.eval_examples, seed=sim.seed + 10_000,
        vocab_size=cfg.vocab_size)
    t0 = time.perf_counter()
    ev = evaluate(client_params(frozen["card"],
                                tree_map(lambda t: t[3], trained),
                                tree_map(lambda t: t[3], cmasks)),
                  {"tokens": ev_tokens, "labels": ev_labels}, cfg,
                  device="cuda")
    log(f"  (b) evaluate (client 3, rank 8) on {sim.eval_examples} examples: "
        f"acc {float(ev['acc']):.4f}, loss {float(ev['loss']):.5f} in "
        f"{time.perf_counter() - t0:.2f} s (random backbone: ~0.5 expected)")
    local = make_local_train(cfg, adamw(sim.lr), device="cuda")
    events = profile_window(torch, "3 training steps (client 0)",
                            lambda: local(
        frozen["card"], tree_map(lambda t: t[0], trainable),
        tree_map(lambda t: t[0], cmasks),
        {k: v[0, :3] for k, v in data.items()}), group=train_group)
    per_step = {g: sum(ms for key, ms, _ in events if train_group(key) == g)
                / 3 for g in ("lora_matmul", "lora_matmul_dx",
                              "lora_matmul_grad_ab")}
    log("  lora device ms a step: " + ", ".join(
        f"{g} {v:.3f}" for g, v in per_step.items()))
    return launches, {"cfg": cfg, "factors": trained["factors"],
                      "masks": cmasks, "shards": [len(x) for x in shards]}


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _paths(v, prefix + (k,))]
    return [prefix]


# ---------------------------------------------------------------------------
# phase 7: server aggregation on full-width RoBERTa-large
# ---------------------------------------------------------------------------

# Phase 7's tolerances, fixed before the run; float32 throughout. Each limit
# scales with a size of the item it is applied to, none with a spectral gap.
# (a) the kernel's dW' against the plain version's on the CPU from the same
#     inputs, per element, of max|dW'|: float32 sums of Kc*R products in
#     another order.
AGG_DW_REL = 1e-5
# (b) two back-ends' spectra, per singular value, of the item's sigma_1: a
#     float32 SVD's backward error E moves every sigma by at most ||E||
#     (Weyl), of order 1e-6 sigma_1 here.
AGG_SPEC_REL = 1e-4
# (c) Eckart-Young: | ||dW' - eff_k||_F - sqrt(sum_{i>r_k} sigma_i^2) | of
#     the item's ||dW'||_F. eff_k is client k's effective update s'_k
#     (A'_k m_k)(B'_k m_k); this holds whatever the factors' signs and basis
#     and whatever the gap, and a missing or extra direction breaks it by
#     sigma_{r_k}^2-sized terms.
AGG_EY_REL = 1e-4
# (d) two back-ends' eff_k, normwise, held only where the rank-r_k
#     truncation is well separated, (sigma_{r_k} - sigma_{r_k+1}) / sigma_1
#     >= AGG_GAP_MIN: there E turns the truncation by at most ||E|| / gap
#     (Davis-Kahan), ~1e-4, while a wrong direction moves eff_k by at least
#     sigma_{r_k} >= 1e-2 sigma_1, over 3.5e-3 of ||eff_k|| (r_k <= 8).
AGG_UPD_REL = 1e-3
AGG_GAP_MIN = 1e-2
AGG_REPS = 3
# svd_randomized's contract: exact when rank(dW') <= r + oversample, which
# holds when the cohort's ranks sum to at most r_max + oversample
AGG_OVERSAMPLE = 8

def dense_inputs(torch, cohort, eta, alpha) -> tuple:
    """The dense reconstruction's inputs, built here independently of the
    engine, with its items in the engine's order (targets sorted, then
    layers): masked factors a (N, K, d_in, r) and b (N, K, r, d_out), and
    the coefficients eta_k / sum(eta) * alpha / r_k (N, K)."""
    etan = eta / eta.sum()
    a, b, coef = [], [], []
    for t in sorted(cohort):
        ad = cohort[t]                                  # (K, L, ...)
        m = ad["mask"]
        a.append((ad["A"] * m[..., None, :]).transpose(0, 1))
        b.append((ad["B"] * m[..., :, None]).transpose(0, 1))
        coef.append((etan[:, None] * alpha
                     / torch.clamp(m.sum(-1), min=1.0)).T)
    return tuple(torch.cat(x).contiguous() for x in (a, b, coef))


def item_updates(torch, out, alpha):
    """eff_k of every item and client of an aggregation's output, (N, K,
    d_in, d_out) float64, items in the engine's order."""
    from repro_torch.core.lora import delta_w
    return torch.cat([delta_w(out[t], alpha).transpose(0, 1).double()
                      for t in sorted(out)])


def item_spectra(torch, spectra):
    """An aggregation's spectra (N, r_max) float64 on the card."""
    return torch.cat([spectra[t] for t in sorted(spectra)]).to(
        "cuda").double()


def hold_spectra(label, got, want, sig) -> None:
    """(b): |got - want| <= AGG_SPEC_REL * sigma_1 per item."""
    err = float(((got - want).abs() / sig[:, :1]).max())
    ok = math.isfinite(err) and err <= AGG_SPEC_REL
    log(f"  {label}: spectra max |diff| / sigma_1 {err:.3e} (tolerance "
        f"{AGG_SPEC_REL:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: spectra disagree")


def hold_eckart_young(torch, label, dw, sig, upd, ranks) -> None:
    """(c) for every item and client: ||dW' - eff_k||_F equals the tail
    sqrt(sum_{i > r_k} sigma_i^2) to AGG_EY_REL * ||dW'||_F."""
    norm = torch.linalg.matrix_norm(dw)
    worst = 0.0
    for k, r in enumerate(ranks):
        tail = torch.sqrt((sig[:, r:] ** 2).sum(-1))
        dist = torch.linalg.matrix_norm(dw - upd[:, k])
        worst = max(worst, float(((dist - tail).abs() / norm).max()))
    ok = math.isfinite(worst) and worst <= AGG_EY_REL
    log(f"  {label}: Eckart-Young over {dw.shape[0]} items x {len(ranks)} "
        f"clients, | ||dW' - eff_k||_F - sqrt(sum_(i>r_k) sigma_i^2) | / "
        f"||dW'||_F max {worst:.3e} (tolerance {AGG_EY_REL:.0e}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: Eckart-Young does not hold")


def hold_updates(torch, label, got, want, sig, ranks) -> None:
    """(d): eff_k of two back-ends, normwise to AGG_UPD_REL, for the (item,
    client) pairs whose relative gap is at least AGG_GAP_MIN; fails when
    no pair qualifies, since then nothing was held."""
    held = skipped = 0
    worst = 0.0
    for k, r in enumerate(ranks):
        sel = (sig[:, r - 1] - sig[:, r]) / sig[:, 0] >= AGG_GAP_MIN
        n = int(sel.sum())
        held, skipped = held + n, skipped + sel.numel() - n
        if n:
            err = torch.linalg.matrix_norm(got[sel, k] - want[sel, k]) \
                / torch.linalg.matrix_norm(want[sel, k])
            worst = max(worst, float(err.max()))
    ok = held > 0 and math.isfinite(worst) and worst <= AGG_UPD_REL
    log(f"  {label}: eff_k held on {held} (item, client) pairs with relative "
        f"gap >= {AGG_GAP_MIN:.0e}, {skipped} skipped for a smaller gap; "
        f"normwise rel err max {worst:.3e} (tolerance {AGG_UPD_REL:.0e}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: client updates disagree")


def counted_call(torch, ops, label, want, fn) -> tuple:
    """(f): ``fn()`` with every launch count set to 0 just before and read
    just after. recon_agg must have launched ``want`` times, no other
    kernel at all, and every output must be finite. Returns (fn's result,
    recon_agg's launches)."""
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    out, spectra = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    expect = dict({name: 0 for name in launches}, recon_agg=want)
    finite = all(bool(torch.isfinite(v).all()) for ad in out.values()
                 for v in ad.values()) and all(
        bool(torch.isfinite(s).all()) for s in spectra.values())
    ok = launches == expect and finite
    log(f"  {label}: first call {wall:.3f} s; recon_agg launches "
        f"{launches['recon_agg']} (expect {want}), other kernels "
        f"{sum(launches.values()) - launches['recon_agg']} (expect 0); "
        f"outputs finite {finite} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: launches {launches}, finite {finite}")
    return (out, spectra), launches["recon_agg"]


def time_calls(torch, np, label, fn, reps) -> None:
    """Host time of ``reps`` synchronized calls after the checked (warm)
    call: p50, min, max."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    log(f"  {label}: p50 {np.median(times) * 1e3:.3f} ms over {reps} "
        f"synchronized call(s) after a warm call (min {min(times) * 1e3:.3f}, "
        f"max {max(times) * 1e3:.3f})")


@contextlib.contextmanager
def stage_events(torch, module, name, events):
    """Inside the block, ``module.<name>`` records a CUDA event pair on the
    current stream around each call, kept in ``events[name]`` (the last
    call's); the function is put back after the block."""
    fn = getattr(module, name)

    def timed(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kw)
        end.record()
        events[name] = (start, end)
        return out

    setattr(module, name, timed)
    try:
        yield
    finally:
        setattr(module, name, fn)


def hold_single_target_groups(torch, ops, engine, cohort, eta, alpha,
                              label) -> int:
    """``exact`` on a tree whose shape groups hold one target each over a
    layer stack: q at its first 3 layers, and v at those layers with B cut
    to 256 output columns (q and v of Gemma-2B differ so). Stacking such a
    group and moving its layer axis in front leaves a strided view, which
    the kernel does not take. Held: one launch per group, and the spectra
    against ``exact`` on the CPU to AGG_SPEC_REL * sigma_1. Returns
    recon_agg's launches."""
    tree = {"q": {k: v[:, :3] for k, v in cohort["q"].items()},
            "v": {"A": cohort["v"]["A"][:, :3],
                  "B": cohort["v"]["B"][:, :3, :, :256],
                  "mask": cohort["v"]["mask"][:, :3]}}
    (_, spec), n = counted_call(
        torch, ops, f"{label} (f) exact, two single-target groups", 2,
        lambda: engine(tree, eta, alpha, method="exact"))
    _, spec_cpu = engine({t: {k: v.cpu() for k, v in ad.items()}
                          for t, ad in tree.items()}, eta.cpu(), alpha,
                         method="exact")
    want = item_spectra(torch, spec_cpu)
    hold_spectra("(b) exact on single-target groups, card against CPU",
                 item_spectra(torch, spec), want, want)
    return n


def run_aggregation(torch, np, trained) -> int:
    """Phase 7: ``AggregationEngine`` on phase 6's trained cohort. Returns
    recon_agg's launches over the counted engine calls."""
    from repro_torch.core.agg_engine import AggregationEngine
    from repro_torch.core.aggregate import aggregation_bias
    from repro_torch.fed import join_adapters
    from repro_torch.kernels import ops

    t_start = time.perf_counter()

    def stamp() -> str:
        return f"[+{time.perf_counter() - t_start:.1f} s]"

    cfg = trained["cfg"]
    alpha, r_max = cfg.lora.alpha, cfg.lora.r_max
    cohort = join_adapters(trained["factors"], trained["masks"])
    eta = torch.tensor(trained["shards"], dtype=torch.float32, device="cuda")
    ranks = [int(x) for x in cohort[min(cohort)]["mask"][:, 0].sum(-1)]
    items = len(cohort) * cfg.num_layers
    log(f"  cohort A shapes "
        f"{ {t: tuple(ad['A'].shape) for t, ad in cohort.items()} }, ranks "
        f"{ranks}, eta = shard sizes {trained['shards']}, alpha {alpha}; "
        f"q and v form one shape group of {items} items")
    for t in sorted(cohort):
        bias = float(aggregation_bias(cohort[t], eta, alpha))
        log(f"  Eq. 1's bias (naive against exact FedAvg), {t}: {bias:.6f}")
        if not (math.isfinite(bias) and bias > 0):
            raise AssertionError(f"aggregation bias of {t}: {bias}")

    engine = AggregationEngine()
    methods = {"factored": dict(method="factored"),
               "exact": dict(method="exact"),
               "randomized": dict(method="randomized"),
               "naive": dict(strategy="naive")}
    runs, total = {}, 0
    for label, kw in methods.items():
        want = 1 if label in ("exact", "randomized") else 0
        runs[label], n = counted_call(
            torch, ops, f"{stamp()} (f) {label}", want,
            lambda: engine(cohort, eta, alpha, **kw))
        total += n

    # the kernel's dW' and its whole spectrum
    a, b, coef = dense_inputs(torch, cohort, eta, alpha)
    dw = ops.recon_agg(a, b, coef)
    compare_scaled("(a) recon_agg's dW' on the card against the plain "
                   "version's on the CPU", dw,
                   ops.recon_agg(a.cpu(), b.cpu(), coef.cpu()).to("cuda"),
                   AGG_DW_REL, "float32 sums of Kc*R products in another "
                   "order")
    sig = torch.linalg.svdvals(dw).double()
    gaps = torch.stack([(sig[:, r - 1] - sig[:, r]) / sig[:, 0]
                        for r in ranks])
    log(f"  {stamp()} svdvals of the kernel's dW' ({tuple(dw.shape)}): "
        f"relative gap (sigma_(r_k) - sigma_(r_k+1)) / sigma_1 over items "
        f"and clients min {float(gaps.min()):.3e}, median "
        f"{float(gaps.median()):.3e}")

    # (b) spectra: exact on the card against factored, and against the CPU
    spec = {k: item_spectra(torch, runs[k][1]) for k in ("factored",
                                                         "exact")}
    hold_spectra("(b) exact against factored, on the card", spec["exact"],
                 spec["factored"], sig)
    t0 = time.perf_counter()
    _, spec_cpu = engine({t: {k: v.cpu() for k, v in ad.items()}
                          for t, ad in cohort.items()}, eta.cpu(), alpha,
                         method="exact")
    hold_spectra(f"(b) exact, card against CPU ({time.perf_counter() - t0:.2f}"
                 f" s on the CPU)", spec["exact"],
                 item_spectra(torch, spec_cpu), sig)
    # and against float64: Householder QR of the float64 factors, whose
    # product is dW' (its sigmas exact to ~1e-15 sigma_1)
    from repro_torch.core.svd import svd_factored
    n_items, kc, d_in, rr = a.shape
    p64 = (a.double() * coef.double()[:, :, None, None]).permute(
        0, 2, 1, 3).reshape(n_items, d_in, kc * rr)
    _, truth, _ = svd_factored(p64, b.double().reshape(n_items, kc * rr, -1),
                               r_max)
    hold_spectra("(b) exact on the card against float64 (QR of the float64 "
                 "factors)", spec["exact"], truth, truth)
    log(f"  (svdvals of dW' with cuSOLVER's default driver, gesvdj, against "
        f"float64: max |diff| / sigma_1 "
        f"{float(((sig[:, :r_max] - truth).abs() / truth[:, :1]).max()):.3e})")
    del p64

    # (c) Eckart-Young and (d) client updates where they are unique
    dw64 = dw.double()
    upd = {k: item_updates(torch, runs[k][0], alpha)
           for k in ("factored", "exact")}
    for label in ("factored", "exact"):
        hold_eckart_young(torch, f"(c) {label}", dw64, sig, upd[label], ranks)
    hold_updates(torch, "(d) exact against factored, on the card",
                 upd["exact"], upd["factored"], sig, ranks)
    del upd, dw64

    # (e) randomized on a sub-cohort inside its contract
    sub_ranks = ranks[:2]
    if sum(sub_ranks) > r_max + AGG_OVERSAMPLE:
        raise AssertionError(f"sub-cohort ranks {sub_ranks} exceed the "
                             f"randomized contract")
    sub = {t: {k: v[:2] for k, v in ad.items()} for t, ad in cohort.items()}
    log(f"  (e) sub-cohort: clients 0 and 1, ranks {sub_ranks}, sum "
        f"{sum(sub_ranks)} <= r_max + oversample = {r_max + AGG_OVERSAMPLE}")
    sub_runs = {}
    for label in ("randomized", "exact"):
        sub_runs[label], n = counted_call(
            torch, ops, f"{stamp()} (f) sub-cohort {label}", 1,
            lambda: engine(sub, eta[:2], alpha, method=label))
        total += n
    a_s, b_s, coef_s = dense_inputs(torch, sub, eta[:2], alpha)
    dw_s = ops.recon_agg(a_s, b_s, coef_s)
    sig_s = torch.linalg.svdvals(dw_s).double()
    hold_spectra("(e) randomized against exact, sub-cohort",
                 item_spectra(torch, sub_runs["randomized"][1]),
                 item_spectra(torch, sub_runs["exact"][1]), sig_s)
    upd_s = {k: item_updates(torch, sub_runs[k][0], alpha)
             for k in ("randomized", "exact")}
    for label in ("randomized", "exact"):
        hold_eckart_young(torch, f"(e) sub-cohort {label}", dw_s.double(),
                          sig_s, upd_s[label], sub_ranks)
    hold_updates(torch, "(e) randomized against exact, sub-cohort",
                 upd_s["randomized"], upd_s["exact"], sig_s, sub_ranks)
    del upd_s, sub_runs, runs
    total += hold_single_target_groups(torch, ops, engine, cohort, eta,
                                       alpha, stamp())

    # times of the server's call, and where exact's time goes: CUDA events
    # around the kernel's op and svd_exact inside the one timed exact call
    from repro_torch.core import svd as svd_lib
    stages = {}
    for label, kw in methods.items():
        def call():
            return engine(cohort, eta, alpha, **kw)

        if label != "exact":
            time_calls(torch, np, f"{stamp()} {label}", call, AGG_REPS)
            continue
        with stage_events(torch, ops, "recon_agg", stages), \
                stage_events(torch, svd_lib, "svd_exact", stages):
            time_calls(torch, np, f"{stamp()} {label}", call, 1)
    kernel_ms, svd_ms = (stages[k][0].elapsed_time(stages[k][1])
                         for k in ("recon_agg", "svd_exact"))
    log(f"  {stamp()} exact's two stages on its {items} items, in the timed "
        f"call (CUDA events): recon_agg {kernel_ms:.4f} ms, svd_exact "
        f"(torch.linalg.svd) {svd_ms:.1f} ms: the kernel is "
        f"{100 * kernel_ms / (kernel_ms + svd_ms):.4f}% of the two")
    profile_window(torch, "one factored aggregation",
                   lambda: engine(cohort, eta, alpha))
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
    from repro_torch.kernels import lora_matmul as lora_mod
    from repro_torch.kernels import paged_attn as paged_mod
    from repro_torch.kernels import recon_agg as recon_mod
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
    for entry, line in ptxas_lines():
        log(f"    {entry}: {line}")

    log("[3] kernels against their plain versions")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {"bgmv": check_bgmv(torch, ops, bgmv_mod, gen),
            "paged_attention": check_paged(torch, ops, paged_mod, gen),
            "flash_attention": check_flash(torch, ops, flash_mod, gen),
            "paged_verify_attention": check_verify(torch, ops, verify_mod,
                                                   paged_mod, gen),
            **check_lora_matmul(torch, ops, lora_mod, gen),
            "recon_agg": check_recon_agg(torch, ops, recon_mod, gen)}
    log("[4] engine: full-width gemma-2b")
    ctx = run_engine(torch, np)
    log("[5] speculative decode: full-width gemma-2b, spec_k 4")
    spec_launches = run_spec(torch, ctx)
    # each kernel's launches on the path that exercises it: phase 4 for
    # plain serving, phase 5 for the verify step, phase 6 for training
    launches = dict(ctx["launches"], paged_verify_attention=spec_launches[
        "paged_verify_attention"])
    del ctx                           # Gemma-2B's weights: 10 GB
    gc.collect()                      # the engines hold reference cycles
    torch.cuda.empty_cache()
    log("[6] client training: full-width roberta-large, 4 clients")
    train_launches, trained = run_training(torch, np)
    for name in ("lora_matmul", "lora_matmul_dx", "lora_matmul_grad_ab"):
        launches[name] = train_launches[name]
    log("[7] server aggregation: full-width roberta-large, phase 6's cohort")
    t0 = time.perf_counter()
    launches["recon_agg"] = run_aggregation(torch, np, trained)
    log(f"  phase 7 took {time.perf_counter() - t0:.1f} s")

    meta = {"bgmv": ("src/repro_torch/kernels/csrc/bgmv.cu",
                     "src/repro/kernels/bgmv.py:43"),
            "paged_attention": ("src/repro_torch/kernels/csrc/paged_attn.cu",
                                "src/repro/kernels/paged_attn.py:103"),
            "flash_attention": ("src/repro_torch/kernels/csrc/flash_attn.cu",
                                "src/repro/kernels/flash_attn.py:75"),
            "paged_verify_attention": ("src/repro_torch/kernels/csrc/verify.cu",
                                       "src/repro/kernels/verify.py:103"),
            # the TPU kernel had no backward: dx and dA/dB replace the
            # autodiff of its math, so all three name it
            **{name: ("src/repro_torch/kernels/csrc/lora_matmul.cu",
                      "src/repro/kernels/lora_matmul.py:51")
               for name in ("lora_matmul", "lora_matmul_dx",
                            "lora_matmul_grad_ab")},
            "recon_agg": ("src/repro_torch/kernels/csrc/recon_agg.cu",
                          "src/repro/kernels/recon_agg.py:42")}
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
