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
   times; the verify kernel also against the decode kernel at one token
   per row; lora_matmul also at a ragged shape, its backward (dx, dA,
   dB; float32) against autograd through the plain version, and every
   other rank variant built (R 13, 29, 64) forward and backward;
4. engine: ``ServeEngine`` serving full-width Gemma-2B (float32, random
   weights from a seed) with four adapters of ranks 2/4/6/8 for 8 requests,
   every kernel's launch count above 0, and every request's tokens equal to
   the merged-weight oracle; then one more wave under ``torch.profiler``
   for the device-busy share of wall time and device time by kernel;
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
7. a ``{"kernels": [...]}`` summary line, then ``{"ok": true, ...}`` last.

It exits non-zero, printing no result, when CUDA is unavailable.
"""
from __future__ import annotations

import gc
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


def check_lora_matmul(torch, ops, lora_mod, gen) -> dict:
    """The three lora_matmul kernels at the training path's shape (16
    sequences x 32 tokens through a 1024 x 1024 q or v projection of
    RoBERTa-large, r_max 8, scale 16/8), the forward also ragged; the
    backward through ``apply_lora``'s autograd Function against autograd
    through the plain version; then every other rank variant, forward and
    backward, at a ragged shape. Returns the three kernels' rows."""
    from repro_torch.core import lora as lora_lib
    log("lora_matmul (training: x (512, 1024), W0 (1024, 1024), R 8, "
        "scale 2):")
    rows = {}

    def inputs(m, k, n, r, dtype):
        x = torch.randn(m, k, generator=gen, device="cuda")
        w0 = torch.randn(k, n, generator=gen, device="cuda") / math.sqrt(k)
        a = torch.randn(k, r, generator=gen, device="cuda") / math.sqrt(k)
        b = 0.05 * torch.randn(r, n, generator=gen, device="cuda")
        return [t.to(dtype).contiguous() for t in (x, w0, a, b)]

    scale = torch.tensor(2.0, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        for m, k, n, r in ((512, 1024, 1024, 8), (500, 1000, 1000, 6)):
            x, w0, a, b = inputs(m, k, n, r, dtype)
            want = lora_mod.lora_matmul_plain(x, w0, a, b, scale)
            got, xa = ops.lora_matmul(x, w0, a, b, scale, return_xa=True)
            err = compare(f"{dtype} forward ({m}, {k}) x ({k}, {n}) R {r}",
                          got, want)
            compare_scaled("    xa", xa, x.float() @ a.float(), 1e-5,
                           "float32 sums of K products in another order")
            if dtype != torch.float32 or m != 512:
                continue
            ms = time_ms(lambda: ops.lora_matmul(x, w0, a, b, scale,
                                                 return_xa=True))
            plain_ms = time_ms(lambda: lora_mod.lora_matmul_parts(
                x, w0, a, b, scale))
            cublas_ms = time_ms(lambda: x @ w0)
            ops_n = 2 * m * k * n + 2 * m * r * (k + n)
            bd = bound(nbytes(x, w0, a, b, got, xa), ops_n, dtype)
            log(f"    ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms null "
                f"(no single PyTorch call computes the fused function; "
                f"cuBLAS x @ W0 alone {cublas_ms:.4f} ms) bound_ms "
                f"{bd['bound_ms']:.5f} ({bd['bound_by']})")
            rows["lora_matmul"] = {"max_abs_err": err, "ms": ms,
                                   "plain_ms": plain_ms, "library_ms": None,
                                   **bd}

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
    why = "float32 sums of N (dx) or M (dA, dB) products in another order"
    errs = [compare_scaled(f"{name} (rank {rank} of 8)", g, p, 1e-5, why)
            for name, g, p in zip(("dx", "dA", "dB"), grads["kernel"],
                                  grads["plain"])]
    ga, gb = grads["kernel"][1], grads["kernel"][2]
    if bool(ga[:, rank:].any()) or bool(gb[rank:, :].any()):
        raise AssertionError("masked rank directions got a nonzero gradient")
    log(f"  masked directions (A columns, B rows {rank}..7): gradient "
        f"exactly 0")
    am, bm = a * mask, b * mask[:, None]
    _, g_only = ops.lora_matmul_dx(dy, w0, am, bm, scale, need_dx=False)
    _, g_ref = lora_mod.lora_matmul_dx_plain(dy, w0, am, bm, scale)
    compare_scaled("g alone (dx skipped)", g_only, g_ref, 1e-5, why)

    _, xa = ops.lora_matmul(x, w0, am, bm, scale, return_xa=True)
    dx, g = ops.lora_matmul_dx(dy, w0, am, bm, scale)
    r = 8
    for name, fn, plain, moved, ops_n, err in (
            ("lora_matmul_dx",
             lambda: ops.lora_matmul_dx(dy, w0, am, bm, scale),
             lambda: lora_mod.lora_matmul_dx_plain(dy, w0, am, bm, scale),
             nbytes(dy, w0, am, bm, dx, g),
             2 * m * n * k + 2 * m * r * (n + k), errs[0]),
            ("lora_matmul_grad_ab",
             lambda: ops.lora_matmul_grad_ab(x, xa, dy, g, scale),
             lambda: lora_mod.lora_matmul_grad_ab_plain(x, xa, dy, g, scale),
             nbytes(x, xa, dy, g) + (k * r + r * n) * 4,
             2 * m * r * (k + n), max(errs[1:]))):
        ms, plain_ms = time_ms(fn), time_ms(plain)
        bd = bound(moved, ops_n, torch.float32)
        log(f"  {name}: ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms null "
            f"(no single PyTorch call) bound_ms {bd['bound_ms']:.5f} "
            f"({bd['bound_by']})")
        rows[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "library_ms": None, **bd}

    # every other rank variant the source builds (RMAX 16, 32, 64; the
    # ranks are not multiples of 8, so the rank edge is masked too) at the
    # ragged shape: the forward in float32 and bf16, dx, g, g alone and
    # dA/dB (float32: the backward refuses bf16) against the plain versions
    m, k, n = 500, 1000, 1000
    for r in (13, 29, 64):
        x, w0, a, b = inputs(m, k, n, r, torch.float32)
        xb, w0b, ab, bb = (t.to(torch.bfloat16) for t in (x, w0, a, b))
        compare(f"torch.bfloat16 forward ({m}, {k}) x ({k}, {n}) R {r}",
                ops.lora_matmul(xb, w0b, ab, bb, scale),
                lora_mod.lora_matmul_plain(xb, w0b, ab, bb, scale))
        y, xa = ops.lora_matmul(x, w0, a, b, scale, return_xa=True)
        y_ref, xa_ref = lora_mod.lora_matmul_parts(x, w0, a, b, scale)
        compare(f"torch.float32 forward ({m}, {k}) x ({k}, {n}) R {r}", y,
                y_ref)
        compare_scaled("    xa", xa, xa_ref, 1e-5,
                       "float32 sums of K products in another order")
        dy = torch.randn(m, n, generator=gen, device="cuda")
        dx, g = ops.lora_matmul_dx(dy, w0, a, b, scale)
        dx_ref, g_ref = lora_mod.lora_matmul_dx_plain(dy, w0, a, b, scale)
        _, g_only = ops.lora_matmul_dx(dy, w0, a, b, scale, need_dx=False)
        da, db = ops.lora_matmul_grad_ab(x, xa_ref, dy, g_ref, scale)
        da_ref, db_ref = lora_mod.lora_matmul_grad_ab_plain(x, xa_ref, dy,
                                                            g_ref, scale)
        for name, got, want in (("dx", dx, dx_ref), ("g", g, g_ref),
                                ("g alone", g_only, g_ref), ("dA", da, da_ref),
                                ("dB", db, db_ref)):
            compare_scaled(f"    {name} (R {r})", got, want, 1e-5, why)
    return rows


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
              "lora_matmul_grad_ab": 0}
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
    steps0 = engine.steps
    profile_window(torch, "admission + prefill", engine.step_batch)
    profile_window(torch, step, engine.run)
    log(f"  ({step} window: {engine.steps - steps0 - 1} steps)")


SERVE_GROUPS = {"port kernels": ("bgmv_kernel", "paged_attn_kernel",
                                  "flash_attn_kernel", "paged_verify_kernel"),
                "GEMM/GEMV": ("gemm", "gemv", "Gemv", "Gemm")}


def serve_group(key: str) -> str:
    return next((g for g, keys in SERVE_GROUPS.items()
                 if any(k in key for k in keys)), "other")


TRAIN_GROUPS = {"lora_matmul": ("lora_fwd_kernel",),
                "lora_matmul_dx": ("lora_dx_kernel", "lora_g_kernel"),
                "lora_matmul_grad_ab": ("lora_grad_ab_kernel",),
                "cuBLAS GEMM": ("gemm", "gemv", "Gemv", "Gemm")}


def train_group(key: str) -> str:
    """Device time groups of a training step: the three lora ops' kernels
    (by their entry names; the dx op runs lora_g_kernel at layer 0),
    cuBLAS, the rest."""
    return next((g for g, keys in TRAIN_GROUPS.items()
                 if any(k in key for k in keys)), "other")


def profile_window(torch, label, fn, group=serve_group) -> None:
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
                  "lora_matmul_dx": 0, "lora_matmul_grad_ab": 0}
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


def run_training(torch, np) -> dict:
    """Phase 6. Returns the lora kernels' launches in the cohort call."""
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
    profile_window(torch, "3 training steps (client 0)", lambda: local(
        frozen["card"], tree_map(lambda t: t[0], trainable),
        tree_map(lambda t: t[0], cmasks),
        {k: v[0, :3] for k, v in data.items()}), group=train_group)
    return launches


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _paths(v, prefix + (k,))]
    return [prefix]


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
                                                   paged_mod, gen),
            **check_lora_matmul(torch, ops, lora_mod, gen)}
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
    train_launches = run_training(torch, np)
    for name in ("lora_matmul", "lora_matmul_dx", "lora_matmul_grad_ab"):
        launches[name] = train_launches[name]

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
                            "lora_matmul_grad_ab")}}
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
