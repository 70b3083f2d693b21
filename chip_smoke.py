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
   times; bgmv also at B 1, two ragged shapes and ranks 13, 29 and 64, on
   slots out of range (-1, S and -S-1, taken the reference's way), each
   with its plan, its registers and the same bits on a second call, and at
   another split count; flash_attention also with the same bits on a
   second call, at the last chunk of a 2k-token prompt, and in every other
   variant built; the four serving kernels timed in bf16 too at the engine's
   shapes
   (head dims 64 and 128, element-wise staging, one split without the
   merge), its library time the faster of two SDPA calls with the kernels
   each ran; the paged decode and verify kernels with the same bits on a
   second call at the engine's shape, minitron-4b's GQA heads, 2048
   positions and every other variant built, each with its split plan and
   registers, the verify kernel also against the decode kernel at one
   token per row; lora_matmul's forward, dx and dA/dB also at the LM
   training path's shapes (M 1024 and 2048 through Gemma-2B's 2048 -> 2048
   and 2048 -> 256 projections), at two ragged shapes (one taking the
   kernels with element loads), at M 8 through OLMoE-1B-7B's decode
   projections (2048 -> 2048, timed with its bound) and at M = 1 on
   Gemma-2B's widths, each
   at the other split count and with an operand off 16-byte alignment,
   with each plan and the kernels' registers, the same bits on
   a second call, and cuBLAS's base products timed beside them; its
   backward (dx, dA, dB; float32) through ``apply_lora`` against autograd
   through the plain version, and every other rank variant built (R 13,
   29, 64) forward and backward;
   recon_agg (float32) batched at the server's shapes on RoBERTa-large
   (48 items, Kc 2 (a two-edge root merge), 4, 5 (an async flush of 4
   updates and the global) and 20, d 1024, R 8), ragged, at rank 16 and in
   the single-item form, with the same bits on a second call;
4. engine: ``ServeEngine`` serving full-width Gemma-2B (float32, random
   weights from a seed) with four adapters of ranks 2/4/6/8 for 8 requests,
   every kernel's launch count above 0, and every request's tokens equal to
   the merged-weight oracle; the same 8 requests again through an engine
   with ``Recorder(annotate=True)``, a registry and two SLO classes: tokens
   and launches equal to the unrecorded wave's, TTFT, per-request tok/s,
   attainment, the events exported (Chrome trace, validated; JSONL, read
   back equal) and folded into series, SLOs and the HTML report under
   ``build/obs/``; four more waves, recorded, unrecorded, unrecorded,
   recorded, for the decode step recorded against unrecorded, and the
   recorder's own host time a step; then one more
   wave on that engine under ``torch.profiler`` for the device-busy share
   of wall time, device time by kernel, the flash kernels' device time per
   prefill chunk, and one ``serve.decode_step`` range a decode step;
5. speculative decode: the same 8 requests through ``ServeEngine(drafter=,
   spec_k=4)`` on phase 4's weights and registry, in four waves (scripted
   forced-accept and forced-reject, n-gram, self-draft), each wave's tokens
   equal to phase 4's plain tokens and the verify kernel launched, each
   engine recording into phase 4's recorder under its own name (a
   ``verify_step`` span a dispatch, the self drafter's ``draft`` spans);
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
8. the synchronous round: ``run_experiment`` (``FedSession`` +
   ``SyncRound``) on phase 6's base, 16 clients and 4 a round, for 3
   rounds of hlora ``factored`` with random ranks in [2, 8], then 2 rounds
   each of naive, flora, and hlora ``randomized`` under the spectrum
   policy with per-target ranks; every round checked on its way: (a) each
   message's measured bytes against its header and payload and the
   payload against the ranks, the history's byte columns against the
   messages'; (b) each message decoding bit for bit and unpacking to the
   slice sent; (c) after each hlora round, each client's effective update
   from its broadcast against the rank-r_k truncation of the global and of
   dW' in float64 (phase 7's limits); (d) the launch counts of every
   round (48 of each lora kernel a step, 48 forward for the eval,
   recon_agg once a randomized round); (e) finite losses and eval
   metrics; (f) the adapted ranks against the energy rule recomputed from
   the spectrum; each round's time split into broadcast, train, collect,
   aggregate and eval, one profiled round, peak memory; then the first
   run's first round again through ``FedSession(recorder=)``: the same
   cohort, ranks, bytes, losses and launches, the server's spans in order,
   the wire samples summing to the comm log, ``fed.round_s`` beside the
   synchronized timers;
9. backbone pretraining on full-width RoBERTa-large (every parameter, the
   LoRA masks included): (a) one step of 8 rows on the card against the
   CPU: loss, every leaf's gradient, every leaf's change after one AdamW
   step (phase 6's limits; the key bias, whose gradient is rounding noise,
   held to noise size on both sides); (b) ``pretrain_backbone`` at
   ``SimConfig``'s defaults, 150 steps of 64 x 32 tokens: every loss
   finite, 48 launches of each lora kernel a step and no other kernel of
   ours, step time, tokens/s, peak memory, and 3 profiled steps with the
   optimizer's device time apart; (c) 3 rounds of phase 8's hlora
   ``factored`` run through ``run_experiment(base_params=None)``, which
   must take (b)'s cached backbone, with phase 8's checks on every round;
10. the training driver and checkpoint / resume on full-width
   RoBERTa-large: (a) ``repro_torch.launch.train.main`` in process
   (``--full-config``, hlora ``factored``, random ranks, 16 clients, 4 a
   round, 2 rounds, ``--ckpt-dir``), which must take phase 9's cached
   backbone (no pretraining step) and launch exactly 48 of each lora kernel
   a local step and 48 forward an eval; its checkpoint and
   ``history.json``, read back through the port's store onto the card and
   the CPU, equal to what it returned and printed; (b) phase 8's hlora
   ``randomized`` run under the spectrum policy with per-target ranks on
   phase 9's backbone, 3 rounds straight against 2 rounds, ``save``,
   ``FedSession.restore`` into a fresh session and 1 more: cohorts, ranks,
   ``target_ranks``, bytes and launches (recon_agg once a round) equal,
   and the losses, eval metrics, global factors and head bit for bit
   (held otherwise to phase 6's loss and phase 7's update limits, naming
   what differs);
11. next-token LM training on full-width Gemma-2B (``examples/
   lm_pretrain_torch.py``'s ``train``: every parameter, the LoRA masks
   included, AdamW with a cosine schedule, ``remat``, queries in chunks;
   data from ``make_bigram_lm`` over a vocabulary of 4096, all 256000
   logits kept): (a) one step at 2 layers on the card against the CPU:
   loss, every leaf's gradient and change (phase 9 (a)'s limits), the
   card's launches; (b) the example's loop at full depth (2.51 B
   parameters), 100 steps of 16 x 64 tokens at lr 3e-3: every loss
   finite, the last 10 at least 1 nat below the first, the chain's own
   NLL beside them, exactly 144 lora forward launches a step (72 and 72
   run again by ``remat``), 72 dx and 72 dA/dB, step time, tokens/s, peak
   memory and 3 profiled steps with AdamW apart; (c) 2 x 1024 tokens
   without and with ``remat`` (q_chunk 256) and at one chunk of 1024:
   the same gradients (``REMAT_REL``, ``QCHUNK_REL``), 72 or 144
   forwards, each variant's peak memory and time;
12. the semi-synchronous and buffered asynchronous rounds on phase 6's
   base (rebuilt from its seed), 16 clients of speeds 0.5 to 2.0: (a)
   ``run_experiment(scheduler=SemiSync(speeds, deadline_quantile=0.75))``,
   hlora ``factored``, 4 clients a round, 3 rounds under phase 8's checks
   (a)-(e), the survivors, stragglers, round time and force-keep
   recomputed from the speeds, the uplink the survivors' messages alone,
   the whole cohort's launches; one round with an infinite deadline
   against one ``SyncRound`` round from the same state, bit for bit; (b)
   ``run_experiment(scheduler=BufferedAsync(speeds, buffer_size=4,
   acfg=AsyncConfig(base_weight=0.5)))``, 12 events: the event order and
   staleness against a heap simulated on the host, flushes [4, 4, 4] with
   one engine call each, version 12, every message and event's byte
   columns, 48 launches of each lora kernel a local step, after each
   flush the global adapter against float64 Eq. 2-3 of the stack (phase
   7's (c) and (d)) and the head against the float64 weighted mean; the
   last buffer again under ``randomized``: recon_agg once, at Kc 5, the
   card's flush against a CPU session's and float64; (c) a mid-flight
   checkpoint: 4 events, ``save``, ``FedSession.restore``, 3 events
   against 7 straight, integers equal and floats bit for bit; wall time,
   peak memory, p50 time a round and an event;
13. population-scale federation on phase 6's base (rebuilt from its seed):
   (a) ``examples/fed_finetune_torch.py``'s ``run_population``: 10,000
   synthetic clients, a cohort of 8 drawn by the rank-stratified sampler,
   2 edges in 'stack' mode, int8 on the wire, 2 rounds: at most the cohort
   resident, 16 shards built, every rank bucket in every cohort, finite
   losses, each edge's row the bytes of its ``EdgeAggregate`` (its header
   and its clients' int8 updates), 48 of each lora kernel a client step and
   nothing else; (b) one cohort of 8 trained once and merged on sessions of
   the same seed: 'stack' against the flat round bit for bit, 'engine'
   under naive against flat naive (the reference test's tolerance) with
   fewer edge-to-root bytes, 'engine' under hlora ``randomized`` with
   recon_agg at Kc 4 at each edge and Kc 2 at the root, each merge against
   float64 Eq. 2-3 (phase 7's (c) and (d)); (c) the cohort's updates and a
   round-0 broadcast under bf16, int8, topk:4 and topk:8, the same bytes on
   the card as on the CPU, decoded on the card within each codec's bound;
   each part's wall time, a round's p50, peak memory;
14. the rest of single-device serving on phase 4's full-width Gemma-2B
   weights and registry, run right after phase 5 (before those weights
   are freed): (a) phase 4's 8 requests through ``kv_mode="dense"`` (the
   ring cache, each prompt fed a token a step): the oracle's tokens under
   phase 4's near-tie rule, exactly 72 ``bgmv`` launches a step and no
   attention kernel, the dense cache's bytes against the page pool's, and a
   row driven past its ring raising; (b) the four adapters saved with the
   port's store under ``build/`` and served through
   ``AdapterRegistry.register_checkpoint`` from 2 slots: phase 4's tokens,
   the reference registry's counts on the same traffic
   (``CKPT_WAVE_COUNTS``), and an evicted adapter reloaded bit for bit
   (``slot_tree``); (c) the weights, registry and cache in bf16: each
   request's first-step logits within ``bf16_logit_rel`` of (b)'s float32
   engine's, the tokens held to phase 4's up to the first float32 near-tie
   under that bound, a forced-accept speculative wave held to the plain
   bf16 tokens the same way; a plain and a speculative wave teacher-forced
   along (b)'s float32 tokens, the logits of every position within the
   bound of (b)'s; two wrong engines (adapters rotated, LoRA B zeroed)
   outside it for every request; each serving kernel launched in bf16,
   and the decode step p50 and tok/s against phase 4's; (d)
   ``examples/serve_adapters_torch.py``'s four scenarios at full width
   (8/8 and 12/12 against the oracles, the hot-swap taken, the replay
   byte-identical to plain 8/8);
15. the mixture-of-experts family on full-width OLMoE-1B-7B (16 layers,
   64 experts of 1024, top-8, 6.92 B parameters; run after phase 13, with
   the earlier weights freed): (a) at 2 layers, one ``moe_ffn`` of 8 x 64
   tokens and one LM ``train`` step (phase 11 (a)'s
   ``lm_step_against_cpu``, its limits, 16/8/8 launches) on the card
   against the CPU, every routing call's top-k indices and keep masks
   equal but for named near-ties (``MOE_NEAR_TIE``); (b)
   ``make_cohort_train`` at full depth, backbone frozen, 4 clients (ranks
   2/4/6/8 on q, k, v, o) x 4 steps of 16 x 64 bigram tokens: finite
   losses, aux > 0, every client's factors moved and masked directions
   unchanged, 64 of each lora kernel a step, step p50, tok/s, dropped
   slots, peak memory, and 2 profiled steps with the MoE forward's device
   time apart; (c) decode through ``model.init_cache`` and
   ``decode_step``: 8 prompts of 32 tokens teacher-forced at capacity
   factor 8.0 against ``forward`` (``MOE_DECODE_REL``, routing held as in
   (a)), then 16 greedy steps at 1.25, twice for the same bits, 64
   ``lora_matmul`` a step, the dropped share at capacity 2; (d) the LM
   example's ``train`` at 4 layers (1.88 B parameters, every one trained),
   30 steps of 16 x 64: finite losses, aux > 0, the last 5 below the
   first, 32/16/16 launches a step, step p50 and peak memory;
16. a ``{"kernels": [...]}`` summary line, then ``{"ok": true, ...}`` last.

It exits non-zero, printing no result, when CUDA is unavailable.
"""
from __future__ import annotations

import contextlib
import copy
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

# bfloat16 serving against float32 serving, or two bfloat16 evaluations that
# round in different places (tests/test_torch_serve_bf16.py holds the port
# to the reference with the same bound). bf16 keeps 8 significant bits: a
# rounding moves a value by at most u = 2^-8 of itself, uniformly, so by
# u/sqrt(3) rms. A layer rounds, on its way from input to output, 31 values
# (the two norms; per projection q, k, v, o, w1, w3, w2 the base product,
# the LoRA delta and their sum; RoPE on q and k; the attention
# probabilities and output; GeGLU's activation and gate product; the two
# residual adds) and reads 7 weight matrices rounded from float32: 38 a
# layer, plus 4 outside the layers (the embedding, the final norm, the
# head's weights and its product). To first order each of these N = 38 L +
# 4 errors reaches the final hidden state h at its own relative size (the
# residual stream carries it, the pre-norms rescale the branches' inputs)
# and they are independent, so two evaluations that each round at N points
# differ in h by a relative rms of sqrt(2 N) u / sqrt(3), in a direction
# unrelated to the head's columns: each logit moves by that share of the
# row's rms. Six times it bounds the largest of the 8 x 256000 logits of a
# wave's first step (P(|N(0,1)| > 6) = 2e-9 a logit). Against float32 only
# one side rounds, so the bound holds with room to spare.
BF16_SIGMAS = 6.0


def bf16_logit_rel(num_layers: int) -> float:
    """|bf16 logit - reference logit| <= this * rms(reference logits of the
    row), per element (the derivation above). A greedy token can change
    only where the top-2 gap is below twice the bound: each of the two
    logits may move by it."""
    n = 38 * num_layers + 4
    return BF16_SIGMAS * math.sqrt(2 * n) * 2.0 ** -8 / math.sqrt(3)


# Phase 14 (b)'s registry counts: 8 requests of 32 new tokens, round-robin
# over 4 checkpoint-backed adapters, through a registry of 2 slots. Rows
# finish in pairs, so each pair loads its two adapters (evicting the last
# pair's) and the queue's head misses once a step while the pair decodes. The
# reference's registry and engine give these counts on the CPU
# (tests/test_torch_registry.py); they depend on neither width nor prompts.
CKPT_WAVE_COUNTS = {"loads": 8, "evictions": 6, "hits": 0, "misses": 101}


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

# Phase 3's bgmv cases: (label, B, d_in, d_out, R). Gemma-2B's decode
# projections (q/o 2048 -> 2048, k/v 2048 -> 256) at B 8 and B 1, two ragged
# shapes (the second takes element loads of x, B and y), and R 13, 29 and
# 64, so that every rank template runs (13 and 29 with element loads of A);
# the last puts a warp's 32 lanes on one column vector (element loads of B
# at R 64, a vector or two a block).
BGMV_CASES = [
    ("decode q/o", 8, 2048, 2048, 8),
    ("decode k/v", 8, 2048, 256, 8),
    ("B 1, q/o", 1, 2048, 2048, 8),
    ("B 1, k/v", 1, 2048, 256, 8),
    ("ragged", 8, 2000, 1000, 8),
    ("ragged, element loads", 8, 1999, 1001, 8),
    ("R 13", 8, 2048, 256, 13),
    ("R 29", 8, 2048, 256, 29),
    ("R 64, k/v", 8, 2048, 256, 64),
    ("R 64, q/o", 8, 2048, 2048, 64),
    ("R 64, 9 columns", 8, 2048, 9, 64),
]
# Row i's slot among S = 4: -1, S and -S-1 (taken the reference's way, as
# 3, 3 and 0) beside slots in range; a batch of one takes -1.
BGMV_IDX = (-1, 1, 4, 2, -5, 3, 3, 0)
# The engine's slots at the decode shapes (rows sorted by slot).
BGMV_ENGINE_IDX = (0, 0, 1, 1, 2, 2, 3, 3)


def bgmv_plan_line(bgmv_mod, plan, slots, esize, vec) -> str:
    """The plan of one bgmv call, its 16-byte loads (``vec``, the
    launcher's bits), the waves the card's cluster capacity gives it, and
    the ptxas registers and spills of the kernel instantiation it
    launches."""
    tname = "f" if esize == 4 else "13__nv_bfloat16"
    entry = f"bgmv_kernelI{tname}Li{bgmv_mod.rank_template(plan.r)}E"
    found = [ln.replace("ptxas info    : ", "") for e, ln in ptxas_lines()
             if e == entry]
    held = slots[plan.n_splits - 1]
    lanes = bgmv_mod.column_lanes(plan.cols_per_split, plan.r, esize,
                                  bool(vec & bgmv_mod.VEC_B))
    loads = ", ".join(f"{name} {'16-byte' if vec & bit else 'element'}"
                      for name, bit in (("x", bgmv_mod.VEC_X),
                                        ("A", bgmv_mod.VEC_A),
                                        ("B and y", bgmv_mod.VEC_B)))
    return (f"plan: {plan.n_splits} splits of {plan.rows_per_split} rows "
            f"(one cluster of {plan.n_splits} a row), {plan.cols_per_split} "
            f"columns a block ({lanes} lanes a column vector), "
            f"{plan.blocks} blocks (the card holds {held} in clusters of "
            f"{plan.n_splits}: {-(-plan.blocks // held)} wave(s)), "
            f"{bgmv_mod.bgmv_trips(plan, esize)} round trips after idx on "
            f"the 16-byte path; loads: {loads}; {entry}: "
            f"{' / '.join(found) or 'not in this build log'}")


def check_bgmv(torch, ops, bgmv_mod, gen) -> dict:
    """bgmv against its plain version at BGMV_CASES, float32 and bf16, on
    BGMV_IDX's slots, each the same bits twice and also at another split
    count (through ``launch(..., plan=)``, not counted); at the decode
    shapes also on the engine's slots, timed with the plain version."""
    from repro_torch.kernels import _build
    lib = _build.load()
    log("bgmv (decode LoRA gather, S = 4 slots; a cluster of plan_bgmv's "
        "splits a row):")
    for dtype in (torch.float32, torch.bfloat16):
        code = _build.DTYPE_CODES[dtype]
        log(f"  blocks the card holds in clusters of 1..8, {str(dtype)[6:]}: "
            + "; ".join(f"R {r}: {bgmv_mod.cluster_slots(lib, 0, r, code)}"
                        for r in (8, 16, 32, 64)))
    row, timed = None, []
    for label, bsz, d_in, d_out, r in BGMV_CASES:
        ranks = torch.tensor([max(1, r * q // 4) for q in (1, 2, 3, 4)],
                             device="cuda")
        mask = (torch.arange(r, device="cuda")[None, :]
                < ranks[:, None]).float()
        idx = torch.tensor(BGMV_IDX[:bsz], dtype=torch.int32, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(bsz, d_in, generator=gen, device="cuda").to(dtype)
            a = (torch.randn(4, d_in, r, generator=gen, device="cuda")
                 / math.sqrt(d_in) * mask[:, None, :]).to(dtype)
            b = (0.05 * torch.randn(4, r, d_out, generator=gen,
                                    device="cuda")).to(dtype)
            esize = x.element_size()
            slots = bgmv_mod.cluster_slots(lib, 0, r,
                                           _build.DTYPE_CODES[dtype])
            plan = bgmv_mod.plan_bgmv(bsz, d_in, r, d_out, slots, esize)
            name = f"{label} ({bsz}, {d_in}, {d_out}, R {r}) {str(dtype)[6:]}"
            want = bgmv_mod.bgmv_plain(x, a, b, idx)
            got = ops.bgmv(x, a, b, idx)
            vec = bgmv_mod.vector_flags(esize, d_in, r, d_out, (
                x.data_ptr(), a.data_ptr(), b.data_ptr(), got.data_ptr()))
            log(f"  {name}: "
                f"{bgmv_plan_line(bgmv_mod, plan, slots, esize, vec)}")
            compare(f"  slots {idx.tolist()}", got, want)
            same_bits(name, got, lambda: ops.bgmv(x, a, b, idx))
            other = bgmv_mod.bgmv_plan(bsz, d_in, r, d_out,
                                       1 if plan.n_splits > 1 else 4)
            if other != plan:
                call = lambda: bgmv_mod.launch(lib, x, a, b, idx, plan=other)
                got = call()
                compare(f"  {other.n_splits} splits of "
                        f"{other.rows_per_split}", got, want)
                same_bits(f"{name}, {other.n_splits} splits", got, call)
            if not label.startswith("decode"):
                continue
            eidx = torch.tensor(BGMV_ENGINE_IDX, dtype=torch.int32,
                                device="cuda")
            want = bgmv_mod.bgmv_plain(x, a, b, eidx)
            err = compare(f"  the engine's slots {eidx.tolist()}",
                          ops.bgmv(x, a, b, eidx), want)
            ms = time_ms(lambda: ops.bgmv(x, a, b, eidx))
            plain_ms = time_ms(lambda: bgmv_mod.bgmv_plain(x, a, b, eidx))
            moved = (nbytes(x, eidx) + bsz * d_out * esize
                     + len(set(BGMV_ENGINE_IDX)) * (d_in * r + r * d_out)
                     * esize)
            bd = bound(moved, 2 * bsz * (d_in * r + r * d_out), dtype)
            log(f"    ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms null "
                f"(no single PyTorch call) bound_ms {bd['bound_ms']:.6f} "
                f"({bd['bound_by']})")
            if dtype == torch.float32:
                timed.append(f"d_out {d_out}: ms {ms:.4f}, plain_ms "
                             f"{plain_ms:.4f}, bound_ms {bd['bound_ms']:.6f}")
                if d_out == 2048:
                    row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                           "library_ms": None, **bd}
    log(f"  bgmv row (float32, B 8, d_in 2048, R 8): {'; '.join(timed)}")
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
            if p < 13:
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
            if row is None and dtype == torch.float32:
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
            if label == cases[0][0]:
                timed = time_flash(torch, ops, flash_mod, q, k, v, kw, err)
                row = timed if dtype == torch.float32 else row
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
            if dtype == torch.float32:
                verify_sq1_equals_decode(torch, ops, q, kp, vp, tables, lens1,
                                         ps)
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
            if row is None and dtype == torch.float32:
                row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "library_ms": None, **bd}
    log("  the same bits on a second call: every case above")
    return row


def verify_sq1_equals_decode(torch, ops, q, kp, vp, tables, lens1, ps):
    """One token per row at q_offsets = lengths - 1 is decode attention:
    the verify kernel must give the decode kernel's output."""
    l1 = torch.tensor(lens1, dtype=torch.int32, device="cuda")
    o1 = torch.clamp(l1 - 1, min=0).to(torch.int32)
    ver = ops.paged_verify_attention(q[:, :1].contiguous(), kp, vp,
                                     tables, l1, o1, page_size=ps)[:, 0]
    dec = ops.paged_attention(q[:, 0].contiguous(), kp, vp, tables, l1,
                              page_size=ps)
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


# (label, M, K, N, R): the training, pretraining and LM training paths'
# shapes (OLMoE-1B-7B's q, k, v and o in training are Gemma-2B's q and o:
# 2048 -> 2048 at M 1024), two ragged ones (the second with K and N not
# multiples of 4: the kernels with element loads), OLMoE-1B-7B's decode
# step (M 8) and the merged-weight oracle's M = 1 on Gemma-2B's widths.
# The first is the kernels line's; every shape whose M is in TIMED_M is
# timed (dA/dB too, past the first), and the forward at every M in
# DECODE_M.
TIMED_M = (512, 1024, 2048)
DECODE_M = (1, 8)
LORA_SHAPES = [
    ("training: 16 x 32 tokens through a q or v projection of "
     "RoBERTa-large", 512, 1024, 1024, 8),
    ("pretraining: 64 x 32 tokens through a q or v projection of "
     "RoBERTa-large", 2048, 1024, 1024, 8),
    ("LM training: 16 x 64 tokens through a q or o projection of "
     "Gemma-2B", 1024, 2048, 2048, 8),
    ("LM training: 16 x 64 tokens through a k or v projection of "
     "Gemma-2B", 1024, 2048, 256, 8),
    ("LM training at length: 2 x 1024 tokens through a q or o projection "
     "of Gemma-2B", 2048, 2048, 2048, 8),
    ("LM training at length: 2 x 1024 tokens through a k or v projection "
     "of Gemma-2B", 2048, 2048, 256, 8),
    ("ragged", 500, 1000, 1000, 6),
    ("ragged, element loads", 37, 999, 1001, 5),
    ("decode: 8 rows through a q, k, v or o projection of OLMoE-1B-7B",
     8, 2048, 2048, 8),
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


def grad_ab_plan_line(lora_mod, plan, slots, vec) -> str:
    """The plan of one dA/dB call, the waves the card's cluster capacity
    gives it, and the ptxas registers and spills of the kernel
    instantiation it launches."""
    entry = f"lora_grad_ab_kernelILi{plan.rank_chunk}ELb{int(vec)}E"
    found = [ln.replace("ptxas info    : ", "") for e, ln in ptxas_lines()
             if e == entry]
    held = slots[plan.n_splits - 1]
    return (f"plan: {plan.n_splits} slabs of {plan.rows_per_split} rows "
            f"(one cluster of {plan.n_splits} a tile), {plan.blocks} blocks "
            f"({plan.tiles_a} + {plan.tiles_b} tiles of {lora_mod.AB_COLS} "
            f"columns x {plan.chunks} rank chunks of {plan.rank_chunk}; the "
            f"card holds {held} in clusters of {plan.n_splits}: "
            f"{-(-plan.blocks // held)} wave(s)), "
            f"{'16-byte' if vec else 'element'} loads; {entry}: "
            f"{' / '.join(found) or 'not in this build log'}")


def hold_grad_ab(torch, ops, lora_mod, lib, x, xa, dy, g, scale, why,
                 off16) -> float:
    """dA/dB through ops against the plain version and the split plain
    version of the plan, the same bits twice; then under another slab
    count (through ``launch_grad_ab(..., plan=)``, not counted) and with x
    one element off 16-byte alignment (element loads). Returns the largest
    error against the plain version."""
    m, k = x.shape
    n, r = dy.shape[1], xa.shape[1]
    slots = lora_mod.cluster_slots(lib, 0, lora_mod.rank_chunk(r))
    plan = lora_mod.plan_grad_ab(m, k, n, r, slots)
    vec = lora_mod.vector_loads(4, k, n, (x.data_ptr(), dy.data_ptr()))
    log(f"    dA/dB {grad_ab_plan_line(lora_mod, plan, slots, vec)}")
    want = lora_mod.lora_matmul_grad_ab_plain(x, xa, dy, g, scale)
    errs = []

    def hold(label, call, p, x_=x):
        got = call()
        split = lora_mod.lora_matmul_grad_ab_split_plain(x_, xa, dy, g,
                                                         scale, p)
        for name, a, b, c in zip(("dA", "dB"), got, want, split):
            errs.append(compare_scaled(f"    {name}{label}", a, b, 1e-5, why))
            compare_scaled(f"    {name}{label} against the split plain "
                           f"version", a, c, 1e-5, why)
        same_bits(f"lora_matmul_grad_ab{label}",
                  torch.cat([t.flatten() for t in got]),
                  lambda: torch.cat([t.flatten() for t in call()]))

    hold("", lambda: ops.lora_matmul_grad_ab(x, xa, dy, g, scale), plan)
    other = lora_mod.grad_ab_plan(m, k, n, r, 1 if plan.n_splits > 1
                                  else lora_mod.AB_MAX_SPLITS)
    if other != plan:
        hold(f", {other.n_splits} slabs of {other.rows_per_split}",
             lambda: lora_mod.launch_grad_ab(lib, x, xa, dy, g, scale,
                                             plan=other), other)
    xo = off16(x)
    hold(", x one element off 16-byte alignment (element loads)",
         lambda: ops.lora_matmul_grad_ab(xo, xa, dy, g, scale), plan, xo)
    return max(errs)


def check_lora_matmul(torch, ops, lora_mod, gen) -> dict:
    """The lora_matmul kernels: forward (float32 and bf16) and dx at
    LORA_SHAPES against their plain versions, each case twice for the same
    bits, with the plan and the kernels' registers; each shape also with
    the other split count (one split where the plan splits, two where it
    does not), and with x and dy one element off 16-byte alignment
    (element loads); times at the training and pretraining paths' shapes
    (``TIMED_M``; dA/dB also at M 1024 and 2048) and at M = 1; dA/dB
    at every shape and at M = 4096 against the plain and split plain
    versions (``hold_grad_ab``); the backward through ``apply_lora``'s
    autograd Function against autograd through the plain version; then
    every other rank variant built, forward and backward, at a ragged
    shape. Returns the three kernels' rows."""
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
    log("  dA/dB: blocks the card holds at once in clusters of 1..8 slabs "
        "(lora_grad_ab_slots): rank chunk 8 "
        f"{lora_mod.cluster_slots(lib, 0, 8)}, 16 "
        f"{lora_mod.cluster_slots(lib, 0, 16)}; two an SM would be "
        f"{lora_mod.BLOCKS_PER_SM * sms}")

    def time_grad_ab(x, xa, dy, g):
        """dA/dB's time, its plain version's, cuBLAS's two products (a
        pair of calls, not one) and its bound."""
        m, k = x.shape
        n, r = dy.shape[1], xa.shape[1]
        times = [time_ms(fn) for fn in (
            lambda: ops.lora_matmul_grad_ab(x, xa, dy, g, scale),
            lambda: lora_mod.lora_matmul_grad_ab_plain(x, xa, dy, g, scale),
            lambda: (x.T @ g, xa.T @ dy))]
        bd = bound(nbytes(x, xa, dy, g) + (k * r + r * n) * 4,
                   2 * m * r * (k + n), torch.float32)
        log(f"  lora_matmul_grad_ab ({m}, {k}, {n}, R {r}): ms "
            f"{times[0]:.4f} plain_ms {times[1]:.4f} library_ms null (no "
            f"single PyTorch call; the cuBLAS pair x^T @ g and xa^T @ dy, two "
            f"calls: {times[2]:.4f} ms) bound_ms {bd['bound_ms']:.5f} "
            f"({bd['bound_by']})")
        return times, bd

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
            if dtype == torch.float32 and m in TIMED_M:
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
                rows.setdefault("lora_matmul", {
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "library_ms": None, **bd})
            elif dtype == torch.float32 and m in DECODE_M:
                plain_ms = time_ms(lambda: lora_mod.lora_matmul_parts(
                    x, w0, a, b, scale))
                bd = bound(nbytes(x, w0, a, b, got, xa),
                           2 * m * k * n + 2 * m * r * (k + n), dtype)
                log(f"    ms {time_ms(call):.4f} plain_ms {plain_ms:.4f} "
                    f"cuBLAS x @ W0 alone {time_ms(lambda: x @ w0):.4f} "
                    f"bound_ms {bd['bound_ms']:.5f} ({bd['bound_by']})")
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
            if m in TIMED_M:
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
                rows.setdefault("lora_matmul_dx", {
                    "max_abs_err": dx_err, "ms": ms, "plain_ms": plain_ms,
                    "library_ms": None, **bd})
            elif m == 1:
                plain_ms = time_ms(lambda: lora_mod.lora_matmul_dx_plain(
                    dy, w0, a, b, scale))
                log(f"    dx: ms {time_ms(call):.4f} plain_ms "
                    f"{plain_ms:.4f} cuBLAS dy @ W0^T alone "
                    f"{time_ms(lambda: dy @ w0.T):.4f}")
            hold_grad_ab(torch, ops, lora_mod, lib, x, xa_ref, dy, g_ref,
                         scale, why, off16)
            if m in TIMED_M[1:]:
                time_grad_ab(x, xa_ref, dy, g_ref)
    log("  the same bits on a second call: every case above")

    # dA/dB at M = 4096 (slabs of hundreds of rows): held and timed
    m, k, n, r = 4096, 1024, 1024, 8
    log(f"  dA/dB at M = {m}: x ({m}, {k}), dy ({m}, {n}), R {r}")
    x, _, a, b = inputs(m, k, n, r, torch.float32)
    dy = torch.randn(m, n, generator=gen, device="cuda")
    xa, g = x @ a, dy @ b.T
    hold_grad_ab(torch, ops, lora_mod, lib, x, xa, dy, g, scale, why, off16)
    time_grad_ab(x, xa, dy, g)

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
    log(f"  dA/dB on the masked factors (rank {rank} of 8):")
    err = hold_grad_ab(torch, ops, lora_mod, lib, x, xa, dy, g, scale, why,
                       off16)
    da, db = ops.lora_matmul_grad_ab(x, xa, dy, g, scale)
    if bool(da[:, rank:].any()) or bool(db[rank:, :].any()):
        raise AssertionError("dA/dB: masked rank directions got a nonzero "
                             "gradient")
    (ms, plain_ms, _), bd = time_grad_ab(x, xa, dy, g)
    rows["lora_matmul_grad_ab"] = {"max_abs_err": max(errs[1:] + [err]),
                                   "ms": ms, "plain_ms": plain_ms,
                                   "library_ms": None, **bd}

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
        for name, got, want in (("dx", dx, dx_ref), ("g", g, g_ref),
                                ("g alone", g_only, g_ref)):
            compare_scaled(f"    {name} (R {r})", got, want, 1e-5, why)
        hold_grad_ab(torch, ops, lora_mod, lib, x, xa_ref, dy, g_ref, scale,
                     why, off16)
    return rows


def check_recon_agg(torch, ops, recon_mod, gen) -> dict:
    """recon_agg at the server's shapes on RoBERTa-large (48 items: q and v
    x 24 layers, d 1024, r_max 8) with phase 13's root merge of two edge
    aggregates (Kc 2), phase 6's cohort (Kc 4, the main path's shape, whose
    row this returns; phase 13's edge merges), phase 12's flush of 4
    updates into the global (Kc 5) and bench_server.py's (Kc 20);
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

    for kc in (4, 5, 20, 2):
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


# Phase 4's recorded wave: two SLO classes of TTFT targets (s), alternating
# over the 8 requests. Observed, not gated: a closed batch of 8 prefills
# before any decode is no arrival process.
SERVE_SLO_TTFT_S = {"interactive": 0.25, "batch": 2.0}
OBS_DIR = os.path.join(ROOT, "build", "obs")


def timed_steps(engine) -> list:
    """Time each ``engine.step_batch`` call on the host clock from outside
    the engine (a step ends with its tokens copied to the host, so the time
    holds its device work). Returns the list it fills with (seconds, prefill
    chunks run in the step); decode-only steps have 0 chunks."""
    rows = []
    step = engine.step_batch

    def timed():
        c0 = engine.prefill_calls
        t0 = time.perf_counter()
        step()
        rows.append((time.perf_counter() - t0, engine.prefill_calls - c0))

    engine.step_batch = timed
    return rows


def decode_p50_ms(np, rows) -> float:
    return float(np.median([dt for dt, c in rows if c == 0])) * 1e3


def export_events(rec, label) -> dict:
    """Write ``rec``'s events under ``build/obs/`` as a Chrome trace and as
    JSONL; the trace must validate (read back from the file) and the JSONL
    read back equal to ``rec.events()``. Returns the trace's counts."""
    from repro_torch.obs import (read_jsonl_with_meta, validate_chrome_trace,
                                 write_chrome_trace, write_jsonl)
    events = rec.events()
    trace = os.path.join(OBS_DIR, f"{label}.trace.json")
    jsonl = os.path.join(OBS_DIR, f"{label}.events.jsonl")
    write_chrome_trace(events, trace, process_name=f"chip_smoke {label}",
                       dropped=rec.dropped)
    with open(trace) as f:
        counts = validate_chrome_trace(json.load(f))
    n = write_jsonl(events, jsonl, meta={"dropped": rec.dropped})
    back, meta = read_jsonl_with_meta(jsonl)
    if n != len(events) or back != events or meta != {"dropped":
                                                      rec.dropped}:
        raise AssertionError(f"{jsonl} does not read back as the recorder's "
                             f"{len(events)} events")
    log(f"  {label}: {len(events)} events ({rec.dropped} dropped) -> "
        f"{os.path.relpath(trace, ROOT)} (valid: {counts['X']} spans, "
        f"{counts['i']} instants, {counts['C']} samples) and "
        f"{os.path.relpath(jsonl, ROOT)} (reads back equal)")
    return counts


def run_recorded_wave(torch, np, ops, params, cfg, registry, prompts,
                      adapters, kw, steps, plain, plain_rows) -> tuple:
    """Phase 4's recorded wave: the same 8 requests through an engine with
    ``Recorder(annotate=True)``, a registry and two SLO classes. Its tokens
    and launches must equal the unrecorded wave's; the events are exported
    and folded into a time-series store, an SLO monitor and the HTML report
    under ``build/obs/``. Returns (engine, recorder)."""
    from repro_torch.obs import (MetricsRegistry, Objective, Recorder,
                                 SeriesStore, SLOMonitor, snapshot_text,
                                 write_html)
    from repro_torch.serve import ServeEngine

    rec = Recorder(annotate=True)
    engine = ServeEngine(params, cfg, registry, recorder=rec,
                         metrics=MetricsRegistry(),
                         slo_ttft_s=SERVE_SLO_TTFT_S, device="cuda", **kw)
    classes = list(SERVE_SLO_TTFT_S)
    uids = [engine.submit(prompts[i], adapters[i], max_new_tokens=steps,
                          slo_class=classes[i % len(classes)])
            for i in range(8)]
    rows = timed_steps(engine)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    outs = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    if launches != plain["launches"]:
        raise AssertionError(f"recorded wave: launches {launches} != the "
                             f"unrecorded wave's {plain['launches']}")
    same = sum(bool(np.array_equal(outs[u], t))
               for u, t in zip(uids, plain["tokens"]))
    if same != 8 or engine.steps != plain["steps"]:
        raise AssertionError(f"recorded wave: {same}/8 requests equal the "
                             f"unrecorded wave's tokens, {engine.steps} "
                             f"steps against {plain['steps']}")
    m = engine.metrics
    ttft, tok_s = m.histogram("serve.ttft_s"), \
        m.histogram("serve.request_tok_s")
    dec, pre = m.histogram("serve.decode_step_s"), \
        m.histogram("serve.prefill_row_s")
    if ttft.count != 8 or m.histogram("serve.request_s").count != 8:
        raise AssertionError(f"recorded wave: {ttft.count} TTFTs and "
                             f"{m.histogram('serve.request_s').count} "
                             f"request times for 8 requests")
    if dec.count != engine.steps:
        raise AssertionError(f"{dec.count} decode step spans for "
                             f"{engine.steps} steps")
    log(f"  recorded wave (Recorder(annotate=True), SLO classes "
        f"{SERVE_SLO_TTFT_S} s): tokens equal to the unrecorded wave's 8/8, "
        f"launches equal; {8 * steps / wall:.1f} tok/s ({wall:.3f} s); TTFT "
        f"p50 {ttft.percentile(50) * 1e3:.3f} ms, p99 "
        f"{ttft.percentile(99) * 1e3:.3f} ms; per-request tok/s p50 "
        f"{tok_s.percentile(50):.2f} (min {tok_s.vmin:.2f}, max "
        f"{tok_s.vmax:.2f}); TTFT attainment {engine.slo_attainment()}; "
        f"prefill {pre.total / max(pre.count, 1) * 1e3:.3f} ms a row over "
        f"{pre.count} rows")
    log(f"  decode step p50: recorded span {dec.percentile(50) * 1e3:.3f} "
        f"ms (n={dec.count}); step_batch timed from outside, decode-only "
        f"steps: recorded {decode_p50_ms(np, rows):.3f} ms, unrecorded "
        f"{decode_p50_ms(np, plain_rows):.3f} ms")
    export_events(rec, "phase4")
    events = rec.events()
    store = SeriesStore(bucket_s=0.25)
    n_obs = store.fold(events)
    monitor = SLOMonitor(
        [Objective("ttft_interactive", "first_token.ttft_s",
                   SERVE_SLO_TTFT_S["interactive"], target=0.9),
         Objective("decode_step", "span.decode_step", 0.1, target=0.99)],
        recorder=rec, bucket_s=0.25, window_buckets=400)
    monitor.fold(events)
    report = write_html(os.path.join(OBS_DIR, "phase4.report.html"),
                        title="chip_smoke phase 4: recorded wave",
                        store=store, slo=monitor, metrics=m,
                        dropped=rec.dropped)
    log(f"  folded {n_obs} observations into {len(store.names())} series; "
        f"report -> {os.path.relpath(report, ROOT)}")
    for line in snapshot_text(slo=monitor).splitlines():
        log(f"    {line}")
    return engine, rec


RECORD_REPS = 20000


def recording_cost_us(recorded: bool) -> float:
    """Host microseconds of a decode step's recording calls, from a
    synthetic loop, not from the engine: the loop repeats, ``RECORD_REPS``
    times, a copy of what ``ServeEngine.step``'s decode step does for the
    recorder (two clock reads, the annotation, the span and the histogram;
    keep it in step with ``serve/engine.py``). Recorded: a fresh
    ``Recorder(annotate=True)`` and histogram; unrecorded,
    ``NULL_RECORDER`` (the ``if rec.enabled:`` guards and the shared null
    annotation). Recording does no device work, so this is its whole cost
    a step. The step times cannot resolve it: the host's spread between
    waves is far larger."""
    from repro_torch.obs import NULL_RECORDER, MetricsRegistry, Recorder
    rec = Recorder(capacity=RECORD_REPS, annotate=True) if recorded \
        else NULL_RECORDER
    hist = MetricsRegistry().histogram("serve.decode_step_s")
    t0 = time.perf_counter()
    for _ in range(RECORD_REPS):
        ts = rec.now() if rec.enabled else 0.0
        with rec.annotation("serve.decode_step"):
            pass
        if rec.enabled:
            t1 = rec.now()
            rec.complete("decode_step", "serve/engine", ts, t1, batch=8)
            hist.observe(t1 - ts)
    return (time.perf_counter() - t0) / RECORD_REPS * 1e6


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
    calls0, steps0 = engine.prefill_calls, engine.steps

    uids = [engine.submit(prompts[i], f"client{i % len(ranks)}",
                          max_new_tokens=steps) for i in range(8)]
    # unrecorded: the engine reads no clock, so its steps are timed here
    plain_rows = timed_steps(engine)
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
    tok_s = 8 * steps / wall
    prefill_s = sum(dt for dt, c in plain_rows if c)
    log(f"  served 8 requests x {steps} tokens (prompts {lens.tolist()}) in "
        f"{wall:.3f} s: {tok_s:.1f} tok/s; decode step p50 "
        f"{decode_p50_ms(np, plain_rows):.3f} ms (step_batch timed from "
        f"outside, {sum(c == 0 for _, c in plain_rows)} decode-only steps); "
        f"steps with prefill {prefill_s * 1e3:.1f} ms for {n_chunks} chunks "
        f"of {chunk} and one decode each; peak memory {peak_gb:.2f} GiB (KV "
        f"pool {engine.kv_cache_bytes() / 2**20:.1f} MiB)")

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
    kw = dict(max_batch=8, max_seq=max_seq, page_size=page_size,
              prefill_chunk=chunk)
    names = [f"client{i % len(ranks)}" for i in range(8)]
    want = {"launches": launches, "tokens": [outs[u] for u in uids],
            "steps": n_steps}
    rengine, rec = run_recorded_wave(
        torch, np, ops, params, cfg, registry, prompts, names, kw, steps,
        want, plain_rows)
    cost = {label: recording_cost_us(label == "recorded")
            for label in ("recorded", "unrecorded")}
    log(f"  the recorder's host time a decode step, from a synthetic loop "
        f"(a copy of the decode step's clock reads, annotation, span and "
        f"histogram, {RECORD_REPS} times; not the engine): recorded "
        f"{cost['recorded']:.3f} us, unrecorded {cost['unrecorded']:.3f} "
        f"us; {cost['recorded'] / 1e3 / decode_p50_ms(np, plain_rows):.2e} "
        f"of the unrecorded wave's decode step p50")
    # the profiled wave runs on the recorded engine: its annotations mark
    # each decode step in the profiler's trace
    profile_engine(torch, rengine, prompts, len(ranks))
    return {"launches": launches, "params": params, "cfg": cfg,
            "recorder": rec,
            "registry": registry, "prompts": prompts, "steps": steps,
            "plain": [outs[u] for u in uids], "oracle": oracle, "gaps": gaps,
            "plain_steps": n_steps, "plain_rows": plain_rows,
            "tok_s": tok_s, "kv_bytes": engine.kv_cache_bytes(),
            "engine_kw": kw, "adapters": names, "trees": adapters}


def profile_engine(torch, engine, prompts, n_adapters,
                   step: str = "decode") -> None:
    """One more wave (8 requests x 8 tokens) under torch.profiler, after
    the counted and checked wave, in two windows: the first engine step
    (admission and chunked prefill of every request, plus one decode or
    verify step) and the remaining steps. For each: the device-busy share
    of the wall time and device time by kernel. The engine records into a
    ``Recorder(annotate=True)``, so the trace must hold one
    ``serve.decode_step`` (or ``serve.verify_step``) range a step and one
    ``serve.prefill_chunk`` range a chunk."""
    for i, p in enumerate(prompts):
        engine.submit(p, f"client{i % n_adapters}", max_new_tokens=8)
    steps0, chunks0 = engine.steps, engine.prefill_calls
    ranges = {}
    events = profile_window(torch, "admission + prefill", engine.step_batch,
                            ranges=ranges)
    chunks = engine.prefill_calls - chunks0
    flash = [(ms, n) for key, ms, n in events if "flash_" in key]
    flash_ms = sum(ms for ms, _ in flash)
    log(f"  flash kernels in that window: {flash_ms:.3f} ms of device time, "
        f"{sum(n for _, n in flash)} launches, over {chunks} prefill chunks: "
        f"{flash_ms / max(chunks, 1):.4f} ms per chunk")
    events = profile_window(torch, step, engine.run, ranges=ranges)
    n = max(engine.steps - steps0 - 1, 1)
    paged = [(ms, c) for key, ms, c in events if "paged_" in key]
    paged_ms = sum(ms for ms, _ in paged)
    log(f"  ({step} window: {engine.steps - steps0 - 1} steps; the paged "
        f"attention kernels {paged_ms:.3f} ms of device time, "
        f"{sum(c for _, c in paged)} launches: {paged_ms / n:.4f} ms per "
        f"step)")
    want = {f"serve.{step}_step": engine.steps - steps0,
            "serve.prefill_chunk": engine.prefill_calls - chunks0}
    got = {k: ranges.get(k, 0) for k in want}
    log(f"  record_function ranges in the profiled wave: {got} (expect "
        f"{want}) {'ok' if got == want else 'FAIL'}")
    if got != want:
        raise AssertionError(f"annotation ranges {got} != {want}")


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
    0 the dx op runs lora_g_kernel alone; dA/dB is lora_grad_ab_kernel
    alone, its slabs meeting inside one cluster launch), cuBLAS, the
    rest."""
    return next((g for g, keys in TRAIN_GROUPS.items()
                 if any(k in key for k in keys)), "other")


def group_ms(events, group, annotation=None) -> dict:
    """Device ms by group of ``profile_window``'s events; a kernel launched
    inside the ``annotation`` range counts under the annotation's name."""
    by_group = {}
    for key, ms, _ in events:
        g = annotation if annotation is not None and key.startswith(
            f"{annotation}: ") else group(key)
        by_group[g] = by_group.get(g, 0.0) + ms
    return by_group


def profile_window(torch, label, fn, group=serve_group,
                   annotation=None, ranges=None) -> list:
    """``fn`` under torch.profiler: the device-busy share of its wall time
    (the sum of the traced kernels, copies and fills over the host time
    of the call) and device time by group and by kernel. The device events
    are read from the exported trace, which the profiler writes from its
    C++ side: ``key_averages`` builds a Python object an event and spent
    ~95 s on a federated round's events. With ``annotation``, the device
    events launched from inside a ``record_function(annotation)`` range
    (matched through the launch's correlation id) form a group of that
    name, keyed "annotation: kernel". Returns (name, ms, launches) per
    kernel, the largest first. ``ranges``, a dict, gains the count of each
    ``record_function`` range in the trace by name."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)["traceEvents"]
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in trace
             if e.get("cat") == "user_annotation"
             and e.get("name") == annotation]
    if ranges is not None:
        for e in trace:
            if e.get("cat") == "user_annotation":
                ranges[e["name"]] = ranges.get(e["name"], 0) + 1
    inside = {e["args"]["correlation"] for e in trace
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})
              and any(a <= e["ts"] <= b for a, b in spans)}
    by_kernel = {}
    for e in trace:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            key = e["name"]
            if e.get("args", {}).get("correlation") in inside:
                key = f"{annotation}: {key}"
            ms, n = by_kernel.get(key, (0.0, 0))
            by_kernel[key] = (ms + e["dur"] / 1e3, n + 1)
    if not by_kernel:
        raise AssertionError(f"profiled {label}: no device events traced")
    if annotation is not None and not inside:
        raise AssertionError(f"profiled {label}: no device event launched "
                             f"inside {annotation!r}")
    events = sorted(((k, ms, n) for k, (ms, n) in by_kernel.items()),
                    key=lambda e: -e[1])
    device_ms = sum(ms for _, ms, _ in events)
    by_group = group_ms(events, group, annotation)
    log(f"  profiled {label}: wall {wall * 1e3:.1f} ms, device busy "
        f"{device_ms:.1f} ms ({100 * device_ms / (wall * 1e3):.1f}% of "
        f"wall); device ms by group: "
        + ", ".join(f"{g} {v:.2f}" for g, v in by_group.items()))
    for key, ms, n in events[:10]:
        log(f"    {ms:9.3f} ms  {n:6d}x  {key[:90]}")
    return events


# ---------------------------------------------------------------------------
# phase 5: speculative decode on full-width Gemma-2B
# ---------------------------------------------------------------------------

def run_spec(torch, ctx) -> dict:
    """Four waves of phase 4's 8 requests with ``spec_k = 4`` on phase 4's
    weights and registry (no second copy), each on a fresh engine with the
    launch counts set to 0 just before and read just after. Each wave's
    engine records into phase 4's recorder under a name of its own; its
    track must hold a ``verify_step`` span a dispatch, and the self drafter's
    a ``draft`` span a dispatch that drafted. Returns the launches summed
    over the waves."""
    from repro_torch.kernels import ops
    from repro_torch.serve import (NGramDrafter, ScriptedDrafter,
                                   SelfDrafter, ServeEngine)

    cfg, steps, plain = ctx["cfg"], ctx["steps"], ctx["plain"]
    spec_k, layers, rec = 4, cfg.num_layers, ctx["recorder"]

    def engine_with(drafter, name=None):
        kw = {} if name is None else dict(recorder=rec, name=name)
        return ServeEngine(ctx["params"], cfg, ctx["registry"],
                           drafter=drafter, spec_k=spec_k, device="cuda",
                           **kw, **ctx["engine_kw"])

    # warm-up (first verify and draft calls): not counted, not recorded
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
    for j, (label, drafter, scripts) in enumerate(waves):
        engine = engine_with(drafter, f"spec{j}")
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
        ver = engine.metrics.histogram(f"{engine.name}.decode_step_s")
        pre = engine.metrics.histogram(f"{engine.name}.prefill_row_s")
        track = [e[1] for e in rec.events()
                 if e[0] == "X" and e[2] == f"{engine.name}/engine"]
        # the self drafter records a draft span a dispatch in which some
        # row could still take a draft; the other drafters record none
        drafts = sum(name == "draft" for name in track)
        drafts_ok = 0 < drafts <= st["dispatches"] if isinstance(
            drafter, SelfDrafter) else drafts == 0
        if track.count("verify_step") != st["dispatches"] or not drafts_ok:
            raise AssertionError(f"{label}: track {engine.name}/engine "
                                 f"holds {track.count('verify_step')} "
                                 f"verify_step and {drafts} draft spans for "
                                 f"{st['dispatches']} dispatches")
        log(f"  {label}: {8 * steps / wall:.1f} tok/s ({wall:.3f} s), "
            f"{st['dispatches']} dispatches (plain decode took "
            f"{ctx['plain_steps']} steps), acceptance "
            f"{st['acceptance_rate']:.3f} ({st['accepted']}/{st['drafted']}), "
            f"rollback pages {st['rollback_pages']}, verify step p50 "
            f"{ver.percentile(50) * 1e3:.3f} ms (n={ver.count}, total "
            f"{ver.total * 1e3:.1f} ms), prefill {pre.total * 1e3:.1f} ms "
            f"({engine.prefill_calls} chunks); launches {launches}; recorded "
            f"as {engine.name}: {track.count('verify_step')} verify_step, "
            f"{drafts} draft spans")
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
    export_events(rec, "phase4+5")
    profile_engine(torch, engine_with(NGramDrafter(2), "spec-profiled"),
                   ctx["prompts"], 4, step="verify")
    return total


# ---------------------------------------------------------------------------
# phase 14: the rest of single-device serving on full-width Gemma-2B
# ---------------------------------------------------------------------------

CKPT_DIR = os.path.join(ROOT, "build", "phase14_ckpt")
SERVE_EXAMPLE = os.path.join(ROOT, "examples", "serve_adapters_torch.py")
SERVING_KERNELS = ("bgmv", "paged_attention", "flash_attention",
                   "paged_verify_attention")


def _serve_example():
    """``examples/serve_adapters_torch.py`` as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("serve_adapters_torch",
                                                  SERVE_EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class KeptLogits:
    """The logits of every position ``engine`` samples, kept by request and
    output index (``kept[uid][j]`` scored ``out[j]``): the prefill's first
    token, each decode row, each verify window's rows. With ``scripts``
    (uid -> tokens) the engine is teacher-forced: the raw logits are kept,
    and the argmax is taken of a copy with the script's token raised to
    +inf, so the engine runs along another evaluation's tokens and every
    position's logits can be held against that evaluation's. Wraps the
    engine's own methods; the kernels and their launches are untouched."""

    def __init__(self, engine, scripts=None):
        self.kept, self.scripts = {}, scripts
        self._req = self._perm = None
        prefill_row, logits = engine._prefill_row, engine._logits
        slot_order = engine._slot_order
        decode, verify = engine._decode_step, engine._verify_step

        def prefill_row_kept(row, req):
            self._req = req
            prefill_row(row, req)
            self._req = None

        def logits_kept(x):
            z = logits(x)
            if x.dim() == 1 and self._req is not None:
                z = self._keep(z[None], [(0, self._req, 0)])[0]
            return z

        def slot_order_kept(idx, mask):
            self._perm, inv = slot_order(idx, mask)
            return self._perm, inv

        def decode_kept(tables, idx, tokens, pos, lens, layers=None):
            z = decode(tables, idx, tokens, pos, lens, layers)
            return self._keep(z, [(b, r, len(r["out"]))
                                  for b, r in self._rows(engine)])

        def verify_kept(tables, idx, tokens, pos0, nv):
            z = verify(tables, idx, tokens, pos0, nv)
            nv = nv.cpu().tolist()
            rows = [((b, s), r, len(r["out"]) + s)
                    for b, r in self._rows(engine) for s in range(nv[b])]
            return self._keep(z, rows)

        engine._prefill_row, engine._logits = prefill_row_kept, logits_kept
        engine._slot_order = slot_order_kept
        engine._decode_step, engine._verify_step = decode_kept, verify_kept

    def _rows(self, engine):
        """(batch index, request) of the live rows, in the step's order."""
        return [(b, engine._rows[i]) for b, i in enumerate(self._perm)
                if engine._rows[i] is not None]

    def _keep(self, z, rows):
        forced = z.clone() if self.scripts is not None else z
        for at, req, j in rows:
            self.kept.setdefault(req["uid"], {})[j] = z[at].clone()
            if self.scripts is not None:
                forced[at][int(self.scripts[req["uid"]][j])] = math.inf
        return forced

    def bind(self, uids) -> None:
        """The wave's requests, in submission order; a list of scripts is
        theirs in that order."""
        self.uids = list(uids)
        if self.scripts is not None:
            self.scripts = dict(zip(self.uids, self.scripts))

    def by_request(self) -> list:
        """Each request's kept rows in output order, (positions, V)."""
        import torch
        return [torch.stack([self.kept[u][j] for j in sorted(self.kept[u])])
                for u in self.uids]


def serve_wave(torch, ops, engine, ctx, scripts=None, kept=None,
               adapters=None, steps=None) -> tuple:
    """Phase 4's 8 requests through ``engine``, the launch counts set to 0
    just before and read just after; scripts (a list a request) go to the
    engine's drafter, ``kept`` (a ``KeptLogits``) is bound to the requests,
    ``adapters`` and ``steps`` replace phase 4's. Returns (tokens a request,
    launches, wall s, the timed steps)."""
    uids = [engine.submit(p, a, max_new_tokens=steps or ctx["steps"])
            for p, a in zip(ctx["prompts"], adapters or ctx["adapters"])]
    for uid, script in zip(uids, scripts or ()):
        engine.drafter.set(uid, script)
    if kept is not None:
        kept.bind(uids)
    rows = timed_steps(engine)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    outs = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return [outs[u] for u in uids], dict(ops.LAUNCHES), wall, rows


def hold_launches(label, launches, expect) -> None:
    """Exact launch counts: the kernels ``expect`` names, and 0 for every
    other kernel."""
    want = {name: expect.get(name, 0) for name in launches}
    ok = launches == want
    log(f"  {label}: launches {launches} (expect {want}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: launch counts {launches} != {want}")


def hold_oracle(np, label, outs, want, ctx) -> int:
    """Each request's tokens against ``want`` (phase 4's oracle or plain
    tokens) under phase 4's near-tie rule; returns the exact count."""
    exact = 0
    for i, out in enumerate(outs):
        msg = first_difference_ok(out, want[i], ctx["oracle"][i],
                                  ctx["gaps"][i])
        if msg:
            log(f"    {label} request {i}: {msg}")
        else:
            exact += 1
    return exact


def run_dense(torch, np, ops, ctx) -> dict:
    """(a) Phase 4's requests through ``kv_mode="dense"``: the oracle's
    tokens, 72 bgmv launches a step and no attention kernel (decode
    attention is plain PyTorch, as in the reference), and a row driven past
    its ring raising."""
    from repro_torch.serve import ServeEngine
    cfg, steps = ctx["cfg"], ctx["steps"]
    dev = ctx["params"].embed.device
    max_seq = ctx["engine_kw"]["max_seq"]
    engine = ServeEngine(ctx["params"], cfg, ctx["registry"], max_batch=8,
                         max_seq=max_seq, kv_mode="dense", device=dev)
    outs, launches, wall, rows = serve_wave(torch, ops, engine, ctx)
    per_step = 4 * cfg.num_layers
    hold_launches(f"(a) dense, {engine.steps} steps (each prompt fed a "
                  f"token a step): {per_step} bgmv a step, no attention "
                  f"kernel", launches, {"bgmv": per_step * engine.steps})
    exact = hold_oracle(np, "(a) dense", outs, ctx["oracle"], ctx)
    lens = [p.size for p in ctx["prompts"]]
    if engine.steps != max(lens) + steps - 1:
        raise AssertionError(f"dense took {engine.steps} steps, expected "
                             f"{max(lens) + steps - 1}")
    ps = ctx["engine_kw"]["page_size"]
    page_bytes = ctx["kv_bytes"] // (8 * -(-max_seq // ps) + 1)
    held = sum(-(-(n + steps) // ps) for n in lens) * page_bytes
    p50 = decode_p50_ms(np, rows)
    log(f"  (a) dense: {exact}/8 exact against the oracle (the near-tie "
        f"rule otherwise); {8 * steps / wall:.1f} tok/s ({wall:.3f} s), "
        f"decode step p50 {p50:.3f} ms over {len(rows)} steps (phase 4's "
        f"paged p50 {decode_p50_ms(np, ctx['plain_rows']):.3f} ms over its "
        f"decode-only steps); KV bytes: dense {engine.kv_cache_bytes()} "
        f"({engine.kv_cache_bytes() / 2**20:.1f} MiB, 8 rows x {max_seq}), "
        f"phase 4's page pool {ctx['kv_bytes']} (sized for the worst case, "
        f"{ctx['kv_bytes'] / 2**20:.1f} MiB), the pages this traffic holds "
        f"at once {held} ({held / 2**20:.1f} MiB)")
    ring = ServeEngine(ctx["params"], cfg, ctx["registry"], max_batch=1,
                       max_seq=8, kv_mode="dense", device=dev)
    ring.submit(ctx["prompts"][0][:4], ctx["adapters"][0], max_new_tokens=4)
    ring._queue[0]["max_new"] = 10        # past submit's guard
    try:
        ring.run()
    except RuntimeError as err:
        if "ring" not in str(err):
            raise
        log(f"  (a) a row driven past its ring of 8 raised after "
            f"{ring.steps} steps: {err}")
    else:
        raise AssertionError("a dense row past its ring did not raise")
    return {"launches": launches, "wall": wall, "p50": p50}


def run_checkpoint_adapters(torch, np, ops, ctx) -> dict:
    """(b) The four adapters saved with the port's store under build/,
    served through ``register_checkpoint`` from a registry of 2 slots:
    phase 4's tokens, the reference's counts (``CKPT_WAVE_COUNTS``), and a
    reloaded slot bit for bit its source. Returns the wave's launches, and
    its tokens and the logits of every position it sampled (float32, the
    bf16 waves' reference)."""
    import shutil
    from repro_torch.checkpoint import store
    from repro_torch.serve import AdapterRegistry, ServeEngine
    cfg, trees = ctx["cfg"], ctx["trees"]
    dev = ctx["params"].embed.device
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    registry = AdapterRegistry(cfg, capacity=2, device=dev)
    for aid, tree in trees.items():
        d = os.path.join(CKPT_DIR, aid)
        store.save(d, 0, tree, meta={"adapter": aid})
        registry.register_checkpoint(aid, d)
    save_s = time.perf_counter() - t0
    if registry.loads or registry.resident():
        raise AssertionError("register_checkpoint read a checkpoint")
    engine = ServeEngine(ctx["params"], cfg, registry, device=dev,
                         **ctx["engine_kw"])
    kept = KeptLogits(engine)
    outs, launches, wall, rows = serve_wave(torch, ops, engine, ctx,
                                            kept=kept)
    layers = cfg.num_layers
    hold_launches(f"(b) {engine.steps} steps, {engine.prefill_calls} "
                  f"prefill chunks", launches,
                  {"bgmv": 4 * layers * engine.steps,
                   "paged_attention": layers * engine.steps,
                   "flash_attention": layers * engine.prefill_calls})
    exact = hold_oracle(np, "(b)", outs, ctx["plain"], ctx)
    counts = {k: getattr(registry, k) for k in CKPT_WAVE_COUNTS}
    ok = counts == CKPT_WAVE_COUNTS
    log(f"  (b) 4 adapters saved under {os.path.relpath(CKPT_DIR, ROOT)} in "
        f"{save_s:.2f} s, registered lazily (nothing read), 8 requests "
        f"through 2 slots in {wall:.3f} s ({engine.steps} steps): {exact}/8 "
        f"equal to phase 4's tokens; registry {counts} (the reference's on "
        f"the CPU: {CKPT_WAVE_COUNTS}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"registry counts {counts} != "
                             f"{CKPT_WAVE_COUNTS}")
    victim = next(a for a in trees if registry.slot_of(a) is None)
    loads = registry.loads
    registry.acquire(victim)
    got = registry.slot_tree(victim)
    registry.release(victim)
    for t, ad in trees[victim].items():
        r = ad["A"].shape[-1]
        pads = (got[t]["A"][..., r:], got[t]["B"][:, r:], got[t]["mask"][:, r:])
        if not (torch.equal(got[t]["A"][..., :r], ad["A"])
                and torch.equal(got[t]["B"][:, :r], ad["B"])
                and torch.equal(got[t]["mask"][:, :r], ad["mask"])
                and not any(bool(p.any()) for p in pads)):
            raise AssertionError(f"reloaded {victim} {t}: slot_tree is not "
                                 f"its source bit for bit")
    if registry.loads != loads + 1:
        raise AssertionError("the reload did not read the checkpoint once")
    log(f"  (b) {victim}, evicted, reloaded from its checkpoint (loads "
        f"{loads} -> {registry.loads}): slot_tree equal to the source bit "
        f"for bit, padding past each rank exactly 0 ok")
    logits = kept.by_request()
    if [len(z) for z in logits] != [ctx["steps"]] * 8:
        raise AssertionError(f"kept {[len(z) for z in logits]} positions, "
                             f"expected {ctx['steps']} a request")
    return {"launches": launches, "f32": {"tokens": outs, "logits": logits}}


def positions_held(np, got, want, gaps, gap_tol) -> tuple:
    """Tokens equal up to the first position whose float32 top-2 gap is
    below ``gap_tol`` (past it a bf16 evaluation may take the other
    token). Returns (positions held, equal leading positions)."""
    small = np.nonzero(np.asarray(gaps) < gap_tol)[0]
    held = int(small[0]) if small.size else len(want)
    diff = np.nonzero(np.asarray(got) != np.asarray(want))[0]
    lead = int(diff[0]) if diff.size else len(want)
    if lead < held:
        raise AssertionError(f"token {lead} differs where the float32 gap "
                             f"{gaps[lead]:.4f} >= {gap_tol:.4f}")
    return held, lead


def bf16_worst(got, want, rel) -> list:
    """Each request's kept bf16 rows against the float32 rows of the same
    positions: the largest |bf16 - float32| / (rel * the float32 row's
    rms), by request (at most 1 holds the bound)."""
    worst = []
    for z16, z32 in zip(got, want):
        z32 = z32[:len(z16)]
        rms = z32.pow(2).mean(-1, keepdim=True).sqrt()
        worst.append(float(((z16.float() - z32).abs() / (rel * rms)).amax()))
    return worst


def hold_bf16(label, worst, rel) -> None:
    ok = all(math.isfinite(w) and w <= 1.0 for w in worst)
    log(f"  (c) {label}, per element within {rel:.4f} x the float32 row's "
        f"rms (derived beside GAP_TOL): worst err/limit by request "
        f"{[round(w, 4) for w in worst]} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: bf16 logits outside the bound: "
                             f"{worst}")


def run_bf16(torch, np, ops, ctx, f32) -> dict:
    """(c) bf16 weights, registry and cache. The plain wave: first-step
    logits within ``bf16_logit_rel`` of the float32 engine's ((b)'s wave),
    tokens held to the float32 wave's up to its first near-tie under that
    bound, and the forced-accept speculative wave to the plain bf16
    wave's. Random weights leave top-2 gaps of about a fifth of the
    logits' rms, under twice the bound, so those token holds end within a
    few positions; the numeric check of decode and verify is teacher
    forcing: a plain and a speculative wave driven along (b)'s float32
    tokens (``KeptLogits``), every position's logits held to the bound
    against (b)'s. Two controls show the bound rejects a wrong engine: the
    adapters rotated between requests, and every LoRA B zeroed, must each
    fall outside it for every request. Each serving kernel launches in
    bf16."""
    from repro_torch.models.transformer import Transformer
    from repro_torch.optim.optimizers import tree_map
    from repro_torch.serve import AdapterRegistry, ScriptedDrafter, \
        ServeEngine
    bf16 = torch.bfloat16
    cfg, layers, steps = ctx["cfg"], ctx["cfg"].num_layers, ctx["steps"]
    dev = ctx["params"].embed.device
    t0 = time.perf_counter()
    params = Transformer.from_tree(
        cfg, tree_map(lambda t: t.to(bf16), ctx["params"].tree()))

    def registry_of(trees):
        reg = AdapterRegistry(cfg, capacity=4, dtype=bf16, device=dev)
        for aid, tree in trees.items():
            reg.register(aid, tree)
        return reg

    registry = registry_of(ctx["trees"])
    torch.cuda.synchronize()
    log(f"  (c) weights cast to bf16 in {time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() * p.element_size() for p in params.parameters()) / 2**30:.2f} "
        f"GiB beside the float32 copy)")

    def engine(drafter=None, reg=registry):
        return ServeEngine(params, cfg, reg, cache_dtype=bf16,
                           drafter=drafter, spec_k=4, device=dev,
                           **ctx["engine_kw"])

    plain = engine()
    plain.submit(ctx["prompts"][0][:67], ctx["adapters"][0],
                 max_new_tokens=3)     # warm-up: bf16 GEMM handles
    plain.run()
    steps0, chunks0 = plain.steps, plain.prefill_calls
    kept = KeptLogits(plain)
    outs, launches, wall, rows = serve_wave(torch, ops, plain, ctx,
                                            kept=kept)
    n_steps, chunks = plain.steps - steps0, plain.prefill_calls - chunks0
    hold_launches(f"(c) bf16, {n_steps} steps, {chunks} chunks", launches,
                  {"bgmv": 4 * layers * n_steps,
                   "paged_attention": layers * n_steps,
                   "flash_attention": layers * chunks})
    rel = bf16_logit_rel(layers)
    hold_bf16("first-step logits against the float32 engine's ((b)'s wave)",
              bf16_worst([z[:1] for z in kept.by_request()], f32["logits"],
                         rel), rel)
    del kept
    rms = [float(z[0].pow(2).mean().sqrt()) for z in f32["logits"]]
    gap_tol = [2 * rel * r for r in rms]
    held = [positions_held(np, outs[i], ctx["plain"][i], ctx["gaps"][i],
                           gap_tol[i]) for i in range(8)]
    log(f"  (c) tokens against the float32 wave: (positions held, equal "
        f"leading positions) by request {held}, the hold ending at the "
        f"first float32 top-2 gap under 2 x the bound "
        f"({gap_tol[0]:.4f} for request 0)")
    spec = engine(ScriptedDrafter())
    souts, slaunches, swall, _ = serve_wave(torch, ops, spec, ctx,
                                            scripts=outs)
    st = spec.spec_stats()
    hold_launches(f"(c) bf16 speculative, forced-accept, {st['dispatches']} "
                  f"dispatches", slaunches,
                  {"paged_verify_attention": layers * st["dispatches"],
                   "flash_attention": layers * spec.prefill_calls})
    sheld = [positions_held(np, souts[i], outs[i], ctx["gaps"][i],
                            gap_tol[i]) for i in range(8)]
    same = sum(bool(np.array_equal(a, b)) for a, b in zip(souts, outs))
    log(f"  (c) speculative against plain bf16: {same}/8 equal, (held, "
        f"equal leading) {sheld}; acceptance {st['acceptance_rate']:.3f} "
        f"(a row whose verify takes another token at a near-tie leaves the "
        f"script's path, and the script's later drafts are rejected), "
        f"{8 * steps / swall:.1f} tok/s ({swall:.3f} s)")
    total = {k: launches[k] + slaunches[k] for k in launches}

    # teacher forcing: decode and verify along (b)'s float32 tokens
    f32_tokens = f32["tokens"]
    forced = engine()
    kept = KeptLogits(forced, f32_tokens)
    fouts, flaunches, _, _ = serve_wave(torch, ops, forced, ctx, kept=kept)
    hold_launches(f"(c) bf16 teacher-forced, {forced.steps} steps, "
                  f"{forced.prefill_calls} chunks", flaunches,
                  {"bgmv": 4 * layers * forced.steps,
                   "paged_attention": layers * forced.steps,
                   "flash_attention": layers * forced.prefill_calls})
    decode = kept.by_request()
    del kept
    fspec = engine(ScriptedDrafter())
    kept = KeptLogits(fspec, f32_tokens)
    fsouts, fslaunches, _, _ = serve_wave(torch, ops, fspec, ctx,
                                          scripts=f32_tokens, kept=kept)
    fst = fspec.spec_stats()
    hold_launches(f"(c) bf16 speculative teacher-forced, "
                  f"{fst['dispatches']} dispatches", fslaunches,
                  {"paged_verify_attention": layers * fst["dispatches"],
                   "flash_attention": layers * fspec.prefill_calls})
    verify = kept.by_request()
    del kept
    for label, got, z in (("decode", fouts, decode),
                          ("verify", fsouts, verify)):
        if not all(np.array_equal(a, b) for a, b in zip(got, f32_tokens)) \
                or [len(x) for x in z] != [steps] * 8:
            raise AssertionError(f"teacher-forced {label}: the tokens left "
                                 f"the script or positions were not kept")
    if fst["acceptance_rate"] != 1.0:
        raise AssertionError(f"teacher-forced verify accepted "
                             f"{fst['acceptance_rate']}")
    own = [int((z.argmax(-1).cpu().numpy() == toks).sum())
           for z, toks in zip(decode, f32_tokens)]
    hold_bf16(f"teacher-forced decode, all {8 * steps} positions (prefill "
              f"and {steps - 1} decode steps a request)",
              bf16_worst(decode, f32["logits"], rel), rel)
    hold_bf16(f"teacher-forced verify, all {8 * steps} positions (prefill "
              f"and {fst['dispatches']} verify windows, acceptance 1.0)",
              bf16_worst(verify, f32["logits"], rel), rel)
    log(f"  (c) along the float32 tokens, bf16 decode's own argmax is the "
        f"float32 token at {own} of {steps} positions by request "
        f"({sum(own)}/{8 * steps})")
    total = {k: total[k] + flaunches[k] + fslaunches[k] for k in total}
    del decode, verify

    # controls: wrong engines the bound must reject
    n = 4
    ids = sorted(ctx["trees"])
    rotated = [ids[(ids.index(a) + 1) % len(ids)] for a in ctx["adapters"]]
    zeroed = registry_of({aid: {t: dict(ad, B=torch.zeros_like(ad["B"]))
                                for t, ad in tree.items()}
                          for aid, tree in ctx["trees"].items()})
    for label, reg, adapters in (("adapters rotated", registry, rotated),
                                 ("every LoRA B zeroed", zeroed, None)):
        ctl = engine(reg=reg)
        kept = KeptLogits(ctl, [t[:n] for t in f32_tokens])
        serve_wave(torch, ops, ctl, ctx, kept=kept, adapters=adapters,
                   steps=n)
        worst = bf16_worst(kept.by_request(), f32["logits"], rel)
        ok = min(worst) > 1.0
        log(f"  (c) control, {label}, teacher-forced for {n} positions: "
            f"worst err/limit by request {[round(w, 3) for w in worst]}, "
            f"{'outside the bound for every request ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the bf16 bound did not reject the "
                                 f"control {label}: {worst}")
        del kept
    if any(total[k] <= 0 for k in SERVING_KERNELS):
        raise AssertionError(f"a serving kernel had no bf16 launch: {total}")
    p16, p32 = decode_p50_ms(np, rows), decode_p50_ms(np, ctx["plain_rows"])
    log(f"  (c) bf16 against float32 (phase 4's unrecorded wave): decode "
        f"step p50 {p16:.3f} ms against {p32:.3f} ms, "
        f"{8 * steps / wall:.1f} tok/s against {ctx['tok_s']:.1f}; "
        f"bf16 launches of the serving kernels (the controls' left out) "
        f"{total}")
    return {"launches": total, "p50": p16, "tok_s": 8 * steps / wall}


def run_example(torch, np, ops, ctx) -> dict:
    """(d) ``examples/serve_adapters_torch.py``'s four scenarios on phase
    4's full-width weights, registry and adapters: 8/8 and 12/12 against
    the oracles, the hot-swap taken, the speculative replay byte-identical
    to plain 8/8; its files under build/obs/results/. The example gets
    copies of the adapters in a registry of its own: its hot-swap scales
    one adapter in place."""
    from repro_torch.serve import AdapterRegistry
    example = _serve_example()
    dev = ctx["params"].embed.device
    trees = copy.deepcopy(ctx["trees"])
    registry = AdapterRegistry(ctx["cfg"], capacity=len(trees), device=dev)
    for aid, tree in trees.items():
        registry.register(aid, tree)
    fx = example.Fixture(ctx["cfg"], ctx["params"], registry, trees, dev)
    os.makedirs(OBS_DIR, exist_ok=True)
    ops.reset_launches()
    res, took = {}, {}
    with contextlib.chdir(OBS_DIR):
        for name, scenario in example.SCENARIOS.items():
            t0 = time.perf_counter()
            res[name] = scenario(fx)
            took[name] = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    main, over = res["main"], res["oversubscribed"]
    spec, obs = res["speculative"], res["observability"]
    checks = {"main 8/8": main["match"] == 8,
              "hot-swap taken": main["swap_loads"] == 1
              and main["swap_equal"],
              "oversubscribed 12/12": over["match"] == 12
              and over["deferrals"] > 0,
              "replay byte-identical 8/8": spec["exact"] == 8,
              "trace files": all(os.path.isfile(os.path.join(OBS_DIR, f))
                                 for f in obs["files"]),
              "every serving kernel": all(launches[k] > 0
                                          for k in SERVING_KERNELS)}
    log(f"  (d) the example at full width: "
        + ", ".join(f"{n} {took[n]:.1f} s" for n in took)
        + f"; checks {checks}; launches {launches}")
    if not all(checks.values()):
        raise AssertionError(f"the serving example at full width: {checks}")
    return {"launches": launches, "took": took}


def run_serving_rest(torch, np, ctx) -> dict:
    """Phase 14 on phase 4's weights and registry, after phase 5. Returns
    the serving kernels' launches over its four parts."""
    from repro_torch.kernels import ops
    parts = {}
    t0 = time.perf_counter()
    parts["a"] = run_dense(torch, np, ops, ctx)
    tb = time.perf_counter()
    parts["b"] = run_checkpoint_adapters(torch, np, ops, ctx)
    tc = time.perf_counter()
    parts["c"] = run_bf16(torch, np, ops, ctx, parts["b"].pop("f32"))
    gc.collect()                      # the bf16 copy: 5 GB
    torch.cuda.empty_cache()
    td = time.perf_counter()
    parts["d"] = run_example(torch, np, ops, ctx)
    te = time.perf_counter()
    total = {name: sum(p["launches"][name] for p in parts.values())
             for name in ops.LAUNCHES}
    for name in ("lora_matmul_dx", "lora_matmul_grad_ab", "recon_agg"):
        if total[name]:
            raise AssertionError(f"serving launched {name}")
    log(f"  phase 14 parts: (a) {tb - t0:.1f} s, (b) {tc - tb:.1f} s, (c) "
        f"{td - tc:.1f} s, (d) {te - td:.1f} s; launches {total}; "
        f"{device_line()}")
    return {name: total[name] for name in SERVING_KERNELS}


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
    which phase 7 aggregates, with the base on the card, on which phase 8
    runs its rounds."""
    from repro_torch.configs import get_config
    from repro_torch.core.lora import make_rank_mask
    from repro_torch.data import dirichlet_partition, make_pair_classification
    from repro_torch.fed import (SimConfig, client_params, evaluate,
                                 loss_and_grads, make_cohort_train,
                                 make_local_train, split_adapters,
                                 split_head, stack_client_data)
    from repro_torch.kernels import ops
    from repro_torch.models import model as model_lib
    from repro_torch.obs import MetricsRegistry, Recorder
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
    # the step times need the recorder's clock (and a synchronize a step)
    cohort = make_cohort_train(cfg, adamw(sim.lr), device="cuda",
                               metrics=metrics, recorder=Recorder())
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
                      "masks": cmasks, "shards": [len(x) for x in shards],
                      "base": gpu}


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


# ---------------------------------------------------------------------------
# phase 8: the synchronous round on full-width RoBERTa-large
# ---------------------------------------------------------------------------

# run_experiment on phase 6's base: 16 clients, 4 a round, ranks in [2, 8]
# (the paper's setting), then three shorter runs of the other strategies
# and of the spectrum policy, whose randomized SVD launches recon_agg.
ROUND_SERVER = dict(num_clients=16, clients_per_round=4, r_min=2, r_max=8,
                    seed=0)
ROUND_RUNS = (
    ("hlora factored, random ranks", 3,
     dict(strategy="hlora", svd_method="factored", rank_policy="random")),
    ("naive", 2, dict(strategy="naive")),
    ("flora", 2, dict(strategy="flora")),
    ("hlora randomized, spectrum ranks per target", 2,
     dict(strategy="hlora", svd_method="randomized", rank_policy="spectrum",
          per_target_ranks=True)),
)
ROUND_PARTS = ("broadcast", "train", "collect", "aggregate", "eval")
# svd_randomized is exact (to float precision) when rank(dW') <= r_max +
# its oversample of 8; a cohort whose ranks sum past 16 is outside that
# contract, and (c) is held there all the same, saying so
ROUND_OVERSAMPLE = 8


def _bits(torch, t):
    """A tensor's bit patterns on the host, as integers of its width."""
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.detach().cpu().contiguous().view(ints[t.element_size()])


def hold_message(torch, msg, full, ranks, specs, head_bytes, r_max, L):
    """(a) the measured size is 4 + header + payload, and the payload is
    sum_t L (d_in + d_out) r_t 4 bytes plus the head's; (b) decoding the
    bytes gives the packed tensors bit for bit, and unpacking gives the
    full-rank slice that was truncated (value equality: the padding is
    +0.0 where A m may hold -0.0) with the rank masks."""
    from repro_torch.fed.messages import _flatten_payload, payload_bytes
    raw = msg.to_bytes()
    hlen = int.from_bytes(raw[:4], "little")
    want = sum(L * (d_in + d_out) * ranks[t] * 4
               for t, (d_in, d_out) in specs.items()) + head_bytes
    if not (msg.num_bytes == len(raw) == 4 + hlen + payload_bytes(msg)
            and payload_bytes(msg) == want):
        raise AssertionError(f"(a) {type(msg).__name__} to client "
                             f"{msg.client_id}: {msg.num_bytes} bytes, "
                             f"header {hlen}, payload {payload_bytes(msg)} "
                             f"(expected {want})")
    back = type(msg).from_bytes(raw)
    sent = _flatten_payload(msg.adapter, msg.head)
    got = _flatten_payload(back.adapter, back.head)
    if sorted(got) != sorted(sent) or not all(
            torch.equal(_bits(torch, got[p]), _bits(torch, sent[p]))
            for p in sent):
        raise AssertionError(f"(b) {type(msg).__name__} to client "
                             f"{msg.client_id} does not decode bit for bit")
    tree, _ = back.unpack(r_max, "cuda")
    for t, ad in tree.items():
        mask = (torch.arange(r_max, device="cuda") < ranks[t]).float()
        if not (torch.equal(ad["A"], full[t]["A"])
                and torch.equal(ad["B"], full[t]["B"])
                and torch.equal(ad["mask"], mask.expand_as(ad["mask"]))):
            raise AssertionError(f"(b) {type(msg).__name__} to client "
                                 f"{msg.client_id}: unpacked {t} differs "
                                 f"from the slice sent")
    return len(raw)


def float64_truncations(torch, a, b, ranks):
    """Float64 SVD of the item stack p q (p (N, d_in, R), q (N, R, d_out),
    Householder QR of each factor, as phase 7's float64 truth): the dense
    product, the singular values padded with zeros past R, and each
    client's rank-r_k truncation (N, K, d_in, d_out)."""
    from repro_torch.core.svd import svd_factored
    u, s, vt = svd_factored(a, b, a.shape[-1])
    sig = torch.nn.functional.pad(s, (0, max(0, max(ranks) + 1 - s.shape[-1])))
    trunc = torch.stack([(u[..., :r] * s[..., None, :r]) @ vt[..., :r, :]
                         for r in ranks], 1)
    return a @ b, sig, trunc


def hold_scale_correction(torch, session, cohort, collected, label):
    """(c), after an hlora round: each cohort client's effective update
    s_k (A_k m_k)(B_k m_k), from its unpacked broadcast of the new global,
    (c1) against the rank-r_k truncation of the global adapter's own
    update (the scale correction alone), and (c2) against the rank-r_k
    truncation of dW' built in float64 from the collected factors, by
    phase 7's limits and gap rule (Eckart-Young for every item and client,
    updates where the truncation is well separated)."""
    from repro_torch.core.lora import delta_w
    from repro_torch.fed.messages import Broadcast
    from repro_torch.fed.session import FedSession
    cfg = session.cfg
    alpha, r_max = cfg.lora.alpha, cfg.lora.r_max
    stacked = session.redistribute(cohort)
    eff = {t: [] for t in stacked}
    for i, cid in enumerate(cohort):
        sl = {t: {"A": ad["A"][i], "B": ad["B"][i]}
              for t, ad in stacked.items()}
        msg = FedSession.make_broadcast(session, cid, sl)
        tree, _ = Broadcast.from_bytes(msg.to_bytes()).unpack(r_max, "cuda")
        for t, ad in tree.items():
            eff[t].append(delta_w({k: v.double() for k, v in ad.items()},
                                  alpha))
    eta = session.cohort_weights(cohort).double()
    etan = eta / eta.sum()
    method = session.strategy.method
    for t in sorted(collected):
        ranks = [session._client_ranks(int(c))[t] for c in cohort]
        upd = torch.stack(eff.pop(t), 1)                    # (L, K, d, d)
        g = session.global_lora[t]
        _, sig_g, trunc_g = float64_truncations(
            torch, g["A"].double() * (alpha / r_max), g["B"].double(), ranks)
        dw_g = (alpha / r_max) * (g["A"].double() @ g["B"].double())
        hold_eckart_young(torch, f"{label} (c1) {t}, global", dw_g, sig_g,
                          upd, ranks)
        hold_updates(torch, f"{label} (c1) {t}, global", upd, trunc_g,
                     sig_g, ranks)
        del dw_g, trunc_g
        ad = collected[t]
        m = ad["mask"].double()                             # (K, L, r)
        coef = etan[:, None] * alpha / torch.clamp(m.sum(-1), min=1.0)
        k, n_l, d_in, r = ad["A"].shape
        a = (ad["A"].double() * (m * coef[..., None])[..., None, :]).permute(
            1, 2, 0, 3).reshape(n_l, d_in, k * r)
        b = (ad["B"].double() * m[..., :, None]).permute(1, 0, 2, 3).reshape(
            n_l, k * r, -1)
        where, total = f"{label} (c2) {t}, dW'", int(m[:, 0].sum())
        if method == "randomized" and total > r_max + ROUND_OVERSAMPLE:
            where += (f" (ranks summing to {total} > r_max + oversample: "
                      f"outside svd_randomized's contract)")
        dw, sig, trunc = float64_truncations(torch, a, b, ranks)
        hold_eckart_young(torch, where, dw, sig, upd, ranks)
        hold_updates(torch, where, upd, trunc, sig, ranks)
        del upd, dw, trunc


def hold_rank_adaptation(np, session, label):
    """(f): ``session.ranks`` and ``target_ranks`` against the energy rule
    recomputed here from ``last_spectrum``: per target the mean spectrum
    over layers, the smallest rank whose leading sigma^2 reach
    ``spectrum_energy`` of the total, clamped to [r_min, r_max]; every
    client gets the rank of the targets' mean sigma^2."""
    scfg = session.scfg

    def energy_rank(s2):
        cum = np.cumsum(s2) / max(float(s2.sum()), 1e-30)
        return int(np.clip(np.searchsorted(cum, scfg.spectrum_energy) + 1,
                           scfg.r_min, scfg.r_max))

    spectra = {t: s.double().cpu().numpy().reshape(-1, s.shape[-1]).mean(0)
               for t, s in session.last_spectrum.items()}
    pooled = energy_rank(np.mean([s ** 2 for s in spectra.values()], 0))
    per_target = {t: energy_rank(s ** 2) for t, s in spectra.items()}
    ok = (bool((session.ranks == pooled).all())
          and session.target_ranks == per_target)
    log(f"  {label} (f) ranks after adaptation: every client "
        f"{sorted(set(session.ranks.tolist()))}, per target "
        f"{session.target_ranks}; recomputed from last_spectrum: {pooled}, "
        f"{per_target} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: rank adaptation disagrees")


def round_scheduler(torch, np, label, expect, profile, base=None,
                    **fields):
    """A ``SyncRound`` (or another cohort scheduler, ``base``, built with
    ``fields``: phase 12's ``SemiSync``) that runs each round with the
    checks of phase 8 on its way: every part (broadcast, train, collect,
    aggregate, eval) timed between device synchronizations, every message
    held by (a) and (b) against its client's ranks, the launch counts
    reset when the round starts and read when it ends (d), (c) and (f)
    after each merge (their time left out of the round's), and, with
    ``profile``, one more round under torch.profiler. ``expect(session)``
    gives the launches a round must make. Each round's record keeps the
    cohort sampled and the clients collected."""
    from repro_torch.fed import SyncRound
    from repro_torch.fed.session import FedSession
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import lora_specs

    base = SyncRound if base is None else base

    class ChipRound(base):
        def run(self, session, train, data_fn, num_rounds, eval_fn=None,
                eval_every=1):
            cfg = session.cfg
            specs, r_max, L = lora_specs(cfg), cfg.lora.r_max, cfg.num_layers
            head_bytes = sum(v.numel() * v.element_size()
                             for v in session.global_head.values())
            self.rounds, self.launches = [], {}
            cur = {}

            def timed(part, fn):
                def call(*args, **kw):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = fn(*args, **kw)
                    torch.cuda.synchronize()
                    cur[part] = time.perf_counter() - t0
                    return out
                return call

            def sample():
                torch.cuda.synchronize()
                ops.reset_launches()
                cur.clear()
                cur.update(start=time.perf_counter(), msgs=[], checks=0.0)
                cohort = FedSession.sample_cohort(session)
                cur["cohort"] = [int(c) for c in cohort]
                cur["ranks"] = [session._client_ranks(c) for c in cohort]
                return cohort

            def make_broadcast(cid, sl):
                msg = FedSession.make_broadcast(session, cid, sl)
                cur["msgs"].append(("down", sl, msg))
                return msg

            def make_update(cid, sl, start_version, head=None, log=True):
                msg = FedSession.make_update(session, cid, sl, start_version,
                                             head, log)
                cur["msgs"].append(("up", sl, msg))
                return msg

            aggregate = timed("aggregate",
                              lambda *a, **kw: FedSession.aggregate_round(
                                  session, *a, **kw))

            def aggregate_checked(tree, cohort, **kw):
                aggregate(tree, cohort, **kw)
                t0 = time.perf_counter()
                rnd = f"{label} round {session.rounds_done - 1}"
                nbytes = {"down": 0, "up": 0}
                rank_of = dict(zip(cur["cohort"], cur["ranks"]))
                for way, full, msg in cur["msgs"]:
                    nbytes[way] += hold_message(
                        torch, msg, full, rank_of[msg.client_id], specs,
                        head_bytes, r_max, L)
                cur["bytes"] = nbytes
                if session.strategy.scale_correction:
                    hold_scale_correction(torch, session, cohort, tree, rnd)
                if session.scfg.rank_policy == "spectrum":
                    hold_rank_adaptation(np, session, rnd)
                torch.cuda.synchronize()
                cur["checks"] = time.perf_counter() - t0

            def evaluate(lora, head):
                m = timed("eval", eval_fn)(lora, head)
                torch.cuda.synchronize()
                wall = time.perf_counter() - cur["start"] - cur["checks"]
                got = dict(ops.LAUNCHES)
                want = dict({k: 0 for k in got}, **expect(session))
                rnd = session.rounds_done - 1
                shown = {k: v for k, v in got.items() if v or want[k]}
                log(f"  {label} round {rnd}: cohort {cur['cohort']}, ranks "
                    f"{cur['ranks']}; wall {wall:.3f} s ("
                    + ", ".join(f"{p} {cur[p]:.3f}" for p in ROUND_PARTS)
                    + f"); (a) (b) {len(cur['msgs'])} messages held; (d) "
                    f"launches {shown}, every other kernel 0 (expect "
                    f"{ {k: want[k] for k in shown} }) "
                    f"{'ok' if got == want else 'FAIL'}")
                if got != want:
                    raise AssertionError(f"{label} round {rnd}: launches "
                                         f"{got} != {want}")
                for k, v in got.items():
                    self.launches[k] = self.launches.get(k, 0) + v
                self.rounds.append(dict(
                    cur, wall=wall, launches=got,
                    post_ranks=session.ranks.tolist(),
                    target_ranks=session.target_ranks))
                return m

            session.sample_cohort = sample
            session.make_broadcast = make_broadcast
            session.make_update = make_update
            session.broadcast_cohort = timed(
                "broadcast", lambda c: FedSession.broadcast_cohort(session, c))
            def collect(cohort, *a):
                cur["collected"] = [int(c) for c in cohort]
                return FedSession.collect_updates(session, cohort, *a)

            session.collect_updates = timed("collect", collect)
            session.aggregate_round = aggregate_checked
            hist = super().run(session, timed("train", train), data_fn,
                               num_rounds, evaluate, eval_every)
            for i, r in enumerate(self.rounds):
                if (hist["downlink_bytes"][i], hist["uplink_bytes"][i]) != (
                        r["bytes"]["down"], r["bytes"]["up"]):
                    raise AssertionError(f"(a) {label} round {i}: history "
                                         f"bytes differ from the messages'")
            for name in ("sample_cohort", "make_broadcast", "make_update",
                         "broadcast_cohort", "collect_updates",
                         "aggregate_round"):
                delattr(session, name)
            if profile:
                profile_window(torch, f"{label}: one more round (round "
                               f"{num_rounds})", lambda: base.run(
                                   self, session, train, data_fn, 1, eval_fn,
                                   eval_every), group=train_group)
            return hist

    return ChipRound(**fields)


def round_expect(cfg, scfg):
    """(d): the launches a round of ``scfg`` makes, as ``expect(session)``
    for ``round_scheduler``: 48 of each lora kernel a local step (q and v
    in every layer), 48 forward for the eval, recon_agg once a round of
    hlora under ``exact`` or ``randomized``."""
    from repro_torch.fed import SimConfig
    per_step = 2 * cfg.num_layers
    steps = scfg.clients_per_round * SimConfig().local_steps
    recon = int(scfg.strategy == "hlora"
                and scfg.svd_method in ("exact", "randomized"))

    def expect(session):
        return {"lora_matmul": per_step * (steps + 1),   # + eval's
                "lora_matmul_dx": per_step * steps,
                "lora_matmul_grad_ab": per_step * steps,
                "recon_agg": recon}
    return expect


def hold_history(label, rounds, hist, t0) -> None:
    """(e): every round ran, with finite losses and eval metrics."""
    values = hist["train_loss"] + hist["eval_acc"] + hist["eval_loss"]
    ok = len(hist["round"]) == rounds and all(
        math.isfinite(v) for v in values)
    log(f"  {label}: {rounds} rounds in {time.perf_counter() - t0:.1f} "
        f"s; train loss {[round(v, 5) for v in hist['train_loss']]}, "
        f"eval acc {[round(v, 4) for v in hist['eval_acc']]}, eval loss "
        f"{[round(v, 5) for v in hist['eval_loss']]}, downlink bytes "
        f"{hist['downlink_bytes']}, uplink bytes {hist['uplink_bytes']}; "
        f"(e) finite {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: history {hist}")


def recorded_round(torch, np, cfg, base, want, want_hist) -> dict:
    """Phase 8's recorded round: the first run's configuration for one
    round through ``FedSession(recorder=)`` and ``round_scheduler``, which
    must give round 0 of that run (``want``, ``want_hist``): the same
    cohort, ranks, bytes, launches, losses and eval metrics, bit for bit.
    The server's spans come as broadcast, collect, aggregate; the wire
    samples sum to the comm log; the trace is exported under
    ``build/obs/``. Returns the round's launches."""
    from repro_torch.fed import (FedSession, ServerConfig, SimConfig,
                                 make_experiment_setup)
    from repro_torch.obs import Recorder

    label, _, kw = ROUND_RUNS[0]
    scfg = ServerConfig(**ROUND_SERVER, **kw)
    rec = Recorder()
    session_kwargs, cohort_train, _, data_fn, _, eval_fn = \
        make_experiment_setup(cfg, SimConfig(rounds=1), scfg, base)
    session = FedSession(cfg, scfg, recorder=rec, **session_kwargs)
    sched = round_scheduler(torch, np, f"{label}, recorded",
                            round_expect(cfg, scfg), profile=False)
    hist = sched.run(session, cohort_train, data_fn, 1, eval_fn=eval_fn)
    got = sched.rounds[0]
    diff = [k for k in ("cohort", "ranks", "bytes", "launches")
            if got[k] != want[k]]
    diff += [k for k in ("train_loss", "eval_acc", "eval_loss",
                         "downlink_bytes", "uplink_bytes")
             if hist[k][0] != want_hist[k][0]]
    events = rec.events()
    server = [e[1] for e in events if e[0] == "X" and e[2] == "fed.server"]
    wire = {}
    for e in events:
        if e[0] == "C" and e[2] == "fed.wire":
            wire[e[1]] = wire.get(e[1], 0) + e[5][e[1]]
    comm = {f"fed.{d}_bytes": sum(v) for d, v in session.comm_log.items()}
    round_s = session.metrics.histogram("fed.round_s")
    spans = {e[1]: e[4] for e in events if e[0] == "X"}
    log(f"  recorded round (FedSession(recorder=)): against round 0 of "
        f"'{label}': cohort, ranks, bytes, launches, losses and eval "
        f"{'equal' if not diff else f'DIFFER in {diff}'}; fed.server spans "
        f"{server}; fed.wire samples {wire} against the comm log {comm}; "
        f"fed.round_s {round_s.total:.3f} s (n={round_s.count}; sample to "
        f"aggregate, with the checks) beside the synchronized timers: wall "
        f"{got['wall']:.3f} s without the checks ("
        + ", ".join(f"{p} {got[p]:.3f}" for p in ROUND_PARTS)
        + "); spans " + ", ".join(f"{k} {v:.3f}" for k, v in spans.items()))
    if diff:
        raise AssertionError(f"recorded round differs from the unrecorded "
                             f"in {diff}")
    if server != ["broadcast", "collect", "aggregate"] or wire != comm or \
            round_s.count != 1 or "train" not in spans:
        raise AssertionError(f"recorded round: server spans {server}, wire "
                             f"{wire} against {comm}, {round_s.count} "
                             f"round times, spans {sorted(spans)}")
    export_events(rec, "phase8")
    return got["launches"]


def run_rounds(torch, np, base) -> dict:
    """Phase 8: ``run_experiment`` on phase 6's full-width base, each run
    driven by ``round_scheduler``, then the first run's first round again
    with a recorder (``recorded_round``). Returns the lora and recon_agg
    launches over every checked round."""
    from repro_torch.configs import get_config
    from repro_torch.fed import ServerConfig, SimConfig, run_experiment

    cfg = get_config("roberta-large")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    totals, walls, parts = {}, [], {p: [] for p in ROUND_PARTS}
    for i, (label, rounds, kw) in enumerate(ROUND_RUNS):
        scfg = ServerConfig(**ROUND_SERVER, **kw)
        sched = round_scheduler(torch, np, label, round_expect(cfg, scfg),
                                profile=i == 0)
        t0 = time.perf_counter()
        hist = run_experiment(cfg, SimConfig(rounds=rounds), scfg,
                              base_params=base, scheduler=sched)
        hold_history(label, rounds, hist, t0)
        if i == 0:
            first = (sched.rounds[0], hist)
        for k, v in sched.launches.items():
            totals[k] = totals.get(k, 0) + v
        walls += [r["wall"] for r in sched.rounds]
        for p in ROUND_PARTS:
            parts[p] += [r[p] for r in sched.rounds]
    for k, v in recorded_round(torch, np, cfg, base, *first).items():
        totals[k] = totals.get(k, 0) + v
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  round wall time p50 {np.median(walls):.3f} s over {len(walls)} "
        f"rounds (min {min(walls):.3f}, max {max(walls):.3f}); parts p50: "
        + ", ".join(f"{p} {np.median(v):.3f} s" for p, v in parts.items())
        + f"; peak memory {peak:.2f} GiB; {device_line()}")
    return totals


# ---------------------------------------------------------------------------
# phase 9: backbone pretraining on full-width RoBERTa-large
# ---------------------------------------------------------------------------

# (a)'s rows: the first 8 of the first pretraining batch, on both sides.
# Its limits are phase 6's (TRAIN_REL, TRAIN_LOSS_ATOL) for the same
# reason: float32 sums in another order through 24 layers. One leaf is
# held otherwise: the key bias bk adds q.bk to every score of a query's
# row, which the softmax cancels, so its gradient is zero in exact
# arithmetic and rounding noise on either side; each side's is held to
# NOISE_REL of the largest entry of bq's gradient, and its stepped change
# (lr times the sign of that noise) is not compared.
PRETRAIN_ROWS = 8
NOISE_REL = 1e-5
NOISE_LEAF, NOISE_REF = ("layers", "attn", "bk"), ("layers", "attn", "bq")
PRETRAIN_PROFILED = 3
# (c): the paper's setting, as phase 8's first run, from the trained
# backbone (base_params=None)
PRETRAIN_ROUNDS = ("hlora factored, random ranks, pretrained backbone", 3,
                   dict(strategy="hlora", svd_method="factored",
                        rank_policy="random"))


def _leaf_paths(tree) -> dict:
    """{path: leaf} of a nested dict of tensors."""
    from repro_torch.optim.optimizers import tree_leaves
    return dict(zip(_paths(tree), tree_leaves(tree)))


def _max_abs(t) -> float:
    return float(t.detach().abs().max())


def pretrain_step_against_cpu(torch, cfg, sim) -> None:
    """(a) one pretraining step on the card against the CPU (plain
    versions), the same weights on both sides (seed 0 on the CPU, copied to
    the card) with trained-looking adapters (B small and random, so that
    A's and the mask's gradients carry signal; at B = 0 both are exactly
    0), the same rows: the loss, every leaf's gradient, and every leaf's
    change after one AdamW step against the CPU side's."""
    from repro_torch.fed import simulation
    from repro_torch.models import model as model_lib
    from repro_torch.optim import adamw, apply_updates

    t0 = time.perf_counter()
    cpu = model_lib.init_params(cfg, seed=sim.seed, device="cpu")
    gen = torch.Generator().manual_seed(1)
    for ad in cpu.lora.values():
        ad["B"] = 0.05 * torch.randn(ad["B"].shape, generator=gen)
    batch = next(simulation.pretrain_batches(cfg, sim))
    batch = {k: torch.from_numpy(v[:PRETRAIN_ROWS]) for k, v in batch.items()}
    res = {}
    for side, dev in (("cpu", "cpu"), ("card", "cuda")):
        params = cpu if dev == "cpu" else cpu.to_device(dev)
        t1 = time.perf_counter()
        loss, grads = simulation.pretrain_loss_and_grads(
            params.tree(), {k: v.to(dev) for k, v in batch.items()}, cfg)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        tree = params.tree()
        opt = adamw(sim.pretrain_lr)
        upd, _ = opt.update(grads, opt.init(tree), tree)
        after = apply_updates(tree, upd)
        res[side] = dict(loss=float(loss), secs=secs,
                         grads=_leaf_paths(grads), before=_leaf_paths(tree),
                         after=_leaf_paths(after))
        del params, grads, upd, after, tree
    dl = abs(res["card"]["loss"] - res["cpu"]["loss"])
    worst_g = worst_c = 0.0
    flips = 0
    for path, gc in res["cpu"]["grads"].items():
        gg = res["card"]["grads"][path]
        before = res["cpu"]["before"][path]
        du_c = res["cpu"]["after"][path] - before
        du_g = res["card"]["after"][path].cpu() - before
        if path == NOISE_LEAF:
            for side in ("cpu", "card"):
                g, ref = (res[side]["grads"][p] for p in (path,
                                                            NOISE_REF))
                if _max_abs(g) > NOISE_REL * _max_abs(ref):
                    raise AssertionError(
                        f"pretraining step: {side} gradient of {path} "
                        f"{_max_abs(g):.3e} is not rounding noise against "
                        f"bq's {_max_abs(ref):.3e}")
            continue
        worst_g = max(worst_g, rel_err(gg, gc))
        change = float(torch.linalg.vector_norm(du_c.double()))
        if change == 0.0:
            raise AssertionError(f"pretraining step: {path} did not move")
        worst_c = max(worst_c, float(torch.linalg.vector_norm(
            (du_g - du_c).double())) / change)
        flips += int(((du_g * du_c) < 0).sum())
    n = len(res["cpu"]["grads"])
    ok = (dl <= TRAIN_LOSS_ATOL and worst_g <= TRAIN_REL
          and worst_c <= TRAIN_REL)
    log(f"  (a) one step of {PRETRAIN_ROWS} x {batch['tokens'].shape[1]} "
        f"tokens: loss card {res['card']['loss']:.6f} cpu "
        f"{res['cpu']['loss']:.6f} (|diff| {dl:.2e} <= "
        f"{TRAIN_LOSS_ATOL:.0e}); gradient rel err per leaf max "
        f"{worst_g:.2e} over {n - 1} leaves (<= {TRAIN_REL:.0e} of the "
        f"norm); after one AdamW step (lr {sim.pretrain_lr}) ||card - cpu|| "
        f"/ ||cpu change|| max {worst_c:.2e} (<= {TRAIN_REL:.0e}); elements "
        f"whose update changed sign {flips}; bk's gradient rounding noise "
        f"on both sides (<= {NOISE_REL:.0e} of bq's); step card "
        f"{res['card']['secs'] * 1e3:.1f} ms, cpu "
        f"{res['cpu']['secs'] * 1e3:.0f} ms; in "
        f"{time.perf_counter() - t0:.1f} s {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"pretraining step: card and CPU disagree "
                             f"(loss {dl}, gradients {worst_g}, step "
                             f"{worst_c})")


def _first_nonfinite(tree) -> str:
    for path, t in _leaf_paths(tree).items():
        if not bool(t.isfinite().all()):
            return "/".join(path)
    return "none"


def run_pretraining(torch, np) -> dict:
    """Phase 9. Returns the lora kernels' launches over (b)'s 150 steps
    and (c)'s checked rounds."""
    from repro_torch.configs import get_config
    from repro_torch.fed import (ServerConfig, SimConfig, run_experiment,
                                 simulation)
    from repro_torch.kernels import ops
    from repro_torch.optim import adamw, apply_updates

    cfg = get_config("roberta-large")
    sim = SimConfig()                 # 150 steps of 64 x 32, AdamW 1e-3
    per_step = 2 * cfg.num_layers     # q and v in every layer
    pretrain_step_against_cpu(torch, cfg, sim)
    gc.collect()

    # (b) pretrain_backbone at SimConfig's defaults, every step's loss,
    # wall time and launches read through a hook on its gradient step
    grad_step = simulation.pretrain_loss_and_grads
    steps = []

    def hooked(tree, batch, cfg_):
        torch.cuda.synchronize()
        start = time.perf_counter()
        ops.reset_launches()
        loss, grads = grad_step(tree, batch, cfg_)
        launches = dict(ops.LAUNCHES)
        value = float(loss)
        if not math.isfinite(value):
            raise AssertionError(
                f"pretraining step {len(steps)}: loss {value}; first "
                f"non-finite leaf of the weights "
                f"{_first_nonfinite(tree)}, of the gradients "
                f"{_first_nonfinite(grads)}")
        steps.append(dict(start=start, loss=value, launches=launches))
        return loss, grads

    simulation.pretrain_loss_and_grads = hooked
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        base = simulation.pretrain_backbone(cfg, sim, device="cuda")
        torch.cuda.synchronize()
    finally:
        simulation.pretrain_loss_and_grads = grad_step
    end = time.perf_counter()
    wall = end - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    expect = {name: 0 for name in ops.LAUNCHES}
    expect.update(lora_matmul=per_step, lora_matmul_dx=per_step,
                  lora_matmul_grad_ab=per_step)
    bad = [i for i, st in enumerate(steps) if st["launches"] != expect]
    walls = [b["start"] - a["start"] for a, b in zip(steps, steps[1:])]
    walls.append(end - steps[-1]["start"])
    seq = next(simulation.pretrain_batches(cfg, sim))["tokens"].shape[1]
    tokens = sim.pretrain_steps * simulation.PRETRAIN_BATCH * seq
    shown = [(i, round(st["loss"], 5)) for i, st in enumerate(steps)
             if i % 10 == 0 or i == len(steps) - 1]
    log(f"  (b) pretrain_backbone: {len(steps)} steps of "
        f"{simulation.PRETRAIN_BATCH} x {seq} tokens, AdamW lr "
        f"{sim.pretrain_lr}, every parameter ({cfg.param_count() / 1e6:.1f} M)"
        f" in {wall:.3f} s: {tokens / wall:.1f} tok/s; step p50 "
        f"{np.median(walls) * 1e3:.3f} ms (min {min(walls) * 1e3:.3f}, max "
        f"{max(walls) * 1e3:.3f}; synchronized at each step); peak memory "
        f"{peak:.2f} GiB; losses (step, loss) {shown}; every loss finite")
    log(f"  (b) launches a step: {steps[0]['launches']} (expect "
        f"{per_step} of each lora kernel: q and v in {cfg.num_layers} "
        f"layers, layer 0's dx with its GEMM; no other kernel of ours) "
        f"{'ok' if not bad and len(steps) == sim.pretrain_steps else 'FAIL'}")
    if bad or len(steps) != sim.pretrain_steps:
        raise AssertionError(f"pretraining launches differ at steps {bad}: "
                             f"{[steps[i]['launches'] for i in bad[:3]]}")
    launches = {name: sum(st["launches"][name] for st in steps) for name in
                ("lora_matmul", "lora_matmul_dx", "lora_matmul_grad_ab")}

    # 3 more steps from the trained weights under the profiler, the
    # optimizer's kernels apart (record_function)
    from torch.profiler import record_function
    tree = base.tree()
    opt = adamw(sim.pretrain_lr)
    state = opt.init(tree)
    batches = [{k: torch.from_numpy(v).to("cuda") for k, v in b.items()}
               for _, b in zip(range(PRETRAIN_PROFILED),
                               simulation.pretrain_batches(cfg, sim))]

    def three_steps():
        nonlocal tree, state
        for batch in batches:
            _, grads = simulation.pretrain_loss_and_grads(tree, batch, cfg)
            with record_function("adamw"):
                upd, state = opt.update(grads, state, tree)
                tree = apply_updates(tree, upd)

    events = profile_window(torch, f"{PRETRAIN_PROFILED} pretraining steps",
                            three_steps, group=train_group,
                            annotation="adamw")
    groups = group_ms(events, train_group, "adamw")
    log("  (b) device ms a step: " + ", ".join(
        f"{g} {v / PRETRAIN_PROFILED:.3f}" for g, v in sorted(groups.items())))
    del tree, state, batches
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the paper's round from the trained backbone: base_params=None
    # must hit (b)'s cache, so no pretraining step runs again
    label, rounds, kw = PRETRAIN_ROUNDS
    scfg = ServerConfig(**ROUND_SERVER, **kw)
    sched = round_scheduler(torch, np, label, round_expect(cfg, scfg),
                            profile=False)
    calls = []

    def counted(*args):
        calls.append(1)
        return grad_step(*args)

    simulation.pretrain_loss_and_grads = counted
    t0 = time.perf_counter()
    try:
        hist = run_experiment(cfg, SimConfig(rounds=rounds), scfg,
                              scheduler=sched)
    finally:
        simulation.pretrain_loss_and_grads = grad_step
    hold_history(label, rounds, hist, t0)
    log(f"  (c) base_params=None took the cached backbone: pretraining "
        f"steps run again {len(calls)} "
        f"{'ok' if not calls else 'FAIL'}")
    if calls:
        raise AssertionError("run_experiment(base_params=None) pretrained "
                             "again")
    for k in launches:
        launches[k] += sched.launches[k]
    return launches



# ---------------------------------------------------------------------------
# phase 10: the training driver, and checkpoint / resume, on full-width
# RoBERTa-large
# ---------------------------------------------------------------------------

# (a) the driver in process, the paper's setting on phase 9's backbone (its
# --pretrain-steps and --seed give phase 9's cache key; the driver's other
# defaults: 8 local steps of 16 rows, Dirichlet alpha 0.3, 4096 examples)
DRIVER_ARGS = ["--full-config", "--strategy", "hlora", "--svd-method",
               "factored", "--rank-policy", "random", "--clients", "16",
               "--cohort", "4", "--rounds", "2", "--pretrain-steps", "150",
               "--seed", "0"]
DRIVER_CKPT = os.path.join(ROOT, "build", "phase10", "driver")
# (b) phase 8's hlora randomized run under the spectrum policy with
# per-target ranks, 3 rounds straight against 2 + save + restore + 1
RESUME_RUN = ("hlora randomized, spectrum ranks per target", 3,
              dict(strategy="hlora", svd_method="randomized",
                   rank_policy="spectrum", per_target_ranks=True))
RESUME_SPLIT = 2
RESUME_CKPT = os.path.join(ROOT, "build", "phase10", "resume")
ROUND_LINE = re.compile(
    r"^  round +(\d+): train_loss=([0-9.]+) eval_acc=([0-9.]+)$", re.M)


def _dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def hold_saved_history(torch, store, hist, printed, ckpt, step, args):
    """The driver's checkpoint and ``history.json`` against the history
    ``main`` returned and the round lines it printed: read through the
    port's store onto the card and onto the CPU, every numeric column a
    float64 tensor of its values, ``health`` one a key, the meta's step and
    arguments."""
    lines = [(int(r), float(l), float(a))
             for r, l, a in ROUND_LINE.findall(printed)]
    want_lines = [(r, float(f"{l:.4f}"), float(f"{a:.4f}")) for r, (l, a) in
                  enumerate(zip(hist["train_loss"], hist["eval_acc"]))]
    if lines != want_lines:
        raise AssertionError(f"(a) printed round lines {lines} != the "
                             f"returned history's {want_lines}")
    for dev in ("cuda", "cpu"):
        tree, meta = store.restore(ckpt, device=dev)
        cols = tree["history"]
        if sorted(cols) != sorted(hist):
            raise AssertionError(f"(a) saved columns {sorted(cols)}")
        for col, values in hist.items():
            pairs = ([(f"health/{k}", cols[col][k],
                       [row[k] for row in values]) for k in values[0]]
                     if col == "health" else [(col, cols[col], values)])
            for name, got, want in pairs:
                want = torch.tensor(want, dtype=torch.float64, device=dev)
                if got.device.type != dev or not torch.equal(got, want):
                    raise AssertionError(f"(a) saved {name} on {dev}: "
                                         f"{got} != {want}")
        if meta != {"step": step, "args": args}:
            raise AssertionError(f"(a) saved meta {meta}")
    with open(os.path.join(ckpt, "history.json")) as f:
        if json.load(f) != json.loads(json.dumps(hist)):
            raise AssertionError("(a) history.json differs from the history")


def run_driver(torch, np) -> dict:
    """(a) ``repro_torch.launch.train.main`` in process: it must take phase
    9's cached backbone (no pretraining step runs) and launch exactly 48 of
    each lora kernel a local step and 48 forward an eval, and nothing
    else of ours; what it saved, read back, must equal what it returned
    and printed. Returns its launches."""
    import io
    import shutil
    from repro_torch.checkpoint import store
    from repro_torch.configs import get_config
    from repro_torch.fed import simulation
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    shutil.rmtree(DRIVER_CKPT, ignore_errors=True)
    argv = DRIVER_ARGS + ["--ckpt-dir", DRIVER_CKPT]
    args = train.parse_args(argv)
    grad_step, calls = simulation.pretrain_loss_and_grads, []
    cached = len(simulation._PRETRAIN_STORE)

    def counted(*a):
        calls.append(1)
        return grad_step(*a)

    out = io.StringIO()
    simulation.pretrain_loss_and_grads = counted
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            hist = train.main(argv)
        torch.cuda.synchronize()
    finally:
        simulation.pretrain_loss_and_grads = grad_step
    wall = time.perf_counter() - t0
    got = dict(ops.LAUNCHES)
    for line in out.getvalue().splitlines():
        log(f"  (a) | {line}")
    per_step = 2 * get_config("roberta-large").num_layers   # q and v
    steps = args.cohort * args.local_steps
    want = dict({k: 0 for k in got},
                lora_matmul=per_step * (steps + 1) * args.rounds,
                lora_matmul_dx=per_step * steps * args.rounds,
                lora_matmul_grad_ab=per_step * steps * args.rounds)
    ok = (got == want and not calls
          and len(simulation._PRETRAIN_STORE) == cached)
    hold_history("(a) the driver", args.rounds, hist, t0)
    log(f"  (a) train.main({' '.join(DRIVER_ARGS)}) in {wall:.3f} s: "
        f"pretraining steps run {len(calls)} (phase 9's cached backbone); "
        f"launches {got} (expect {per_step} of each lora kernel a local "
        f"step, {steps} steps a round, and {per_step} forward an eval, "
        f"{args.rounds} rounds) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"(a) the driver: launches {got} != {want}, "
                             f"pretraining steps {len(calls)}")
    step = args.rounds
    hold_saved_history(torch, store, hist, out.getvalue(), DRIVER_CKPT,
                       step, vars(args))
    arrays = os.path.join(DRIVER_CKPT, f"step_{step:08d}", "arrays.npz")
    log(f"  (a) checkpoint step {step}: {_dir_bytes(DRIVER_CKPT)} bytes "
        f"(arrays.npz {os.path.getsize(arrays)}, history.json "
        f"{os.path.getsize(os.path.join(DRIVER_CKPT, 'history.json'))}); "
        f"read back onto the card and the CPU, equal to the returned "
        f"history and the printed lines ok")
    return {k: v for k, v in got.items() if v}


def _factor_bits_equal(torch, got, want) -> list:
    """The leaves of two ``{target: {leaf: tensor}}`` (or head) trees whose
    bits differ."""
    bad = []
    for t, v in want.items():
        pairs = v.items() if isinstance(v, dict) else [(None, v)]
        for leaf, w in pairs:
            g = got[t] if leaf is None else got[t][leaf]
            if not torch.equal(_bits(torch, g), _bits(torch, w)):
                bad.append(t if leaf is None else f"{t}/{leaf}")
    return bad


def run_resume(torch, np) -> dict:
    """(b) phase 8's hlora randomized run with the spectrum policy and
    per-target ranks on phase 9's backbone: 3 rounds straight, against 2
    rounds, ``save``, ``FedSession.restore`` into a fresh session, and 1
    more, each run driven by ``round_scheduler`` so that every round gets
    phase 8's checks (a)-(d) and (f). Integers (cohorts, ranks, ``target_ranks``, bytes, launches: 48
    of each lora kernel a step, 48 forward an eval, recon_agg once a round)
    must be equal; the losses, eval metrics and global factors and head
    should have the same bits, and are otherwise held to phase 6's loss
    limit and phase 7's update limit, saying so. Returns the launches over
    the 6 rounds."""
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.fed import (FedSession, ServerConfig, SimConfig,
                                 make_experiment_setup, simulation)

    cfg = get_config("roberta-large")
    label, rounds, kw = RESUME_RUN
    scfg = ServerConfig(**ROUND_SERVER, **kw)
    sim = SimConfig(rounds=rounds)
    cached = len(simulation._PRETRAIN_STORE)
    base = simulation.pretrain_backbone(cfg, SimConfig(), device="cuda")
    if len(simulation._PRETRAIN_STORE) != cached:
        raise AssertionError("(b) phase 9's backbone was not cached")
    (session_kw, train, _, data_fn, _, eval_fn) = make_experiment_setup(
        cfg, sim, scfg, base, device="cuda")
    expect = round_expect(cfg, scfg)
    shutil.rmtree(RESUME_CKPT, ignore_errors=True)

    def fresh():
        return FedSession(cfg, scfg, device="cuda", **session_kw)

    def scheduler(part):
        return round_scheduler(torch, np, f"{label}, {part}", expect,
                               profile=False)

    t0 = time.perf_counter()
    straight, s_sched = fresh(), scheduler("straight")
    h_full = s_sched.run(straight, train, data_fn, rounds, eval_fn=eval_fn)
    t_straight = time.perf_counter() - t0
    t0 = time.perf_counter()
    first, a_sched = fresh(), scheduler("first")
    h_a = a_sched.run(first, train, data_fn, RESUME_SPLIT, eval_fn=eval_fn)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    path = first.save(RESUME_CKPT)
    t2 = time.perf_counter()
    resumed = FedSession.restore(RESUME_CKPT, cfg, scfg, device="cuda",
                                 **session_kw)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    b_sched = scheduler("resumed")
    h_b = b_sched.run(resumed, train, data_fn, rounds - RESUME_SPLIT,
                      eval_fn=eval_fn)
    t_split = time.perf_counter() - t0
    size = os.path.getsize(os.path.join(path, "arrays.npz"))
    meta = os.path.getsize(os.path.join(path, "meta.json"))

    logs = a_sched.rounds + b_sched.rounds
    ints = ("cohort", "ranks", "post_ranks", "target_ranks", "launches")
    same_ints = (len(logs) == len(s_sched.rounds) == rounds and all(
        got[k] == want[k] for want, got in zip(s_sched.rounds, logs)
        for k in ints))
    for k in ("round", "downlink_bytes", "uplink_bytes"):
        same_ints = same_ints and h_a[k] + h_b[k] == h_full[k]
    floats = {k: (h_a[k] + h_b[k], h_full[k])
              for k in ("train_loss", "eval_acc", "eval_loss")}
    differ = [k for k, (g, w) in floats.items() if g != w]
    differ += _factor_bits_equal(torch, resumed.global_lora,
                                 straight.global_lora)
    differ += [f"head {k}" for k in _factor_bits_equal(
        torch, resumed.global_head, straight.global_head)]
    log(f"  (b) {label}: {rounds} rounds straight in {t_straight:.3f} s; "
        f"{RESUME_SPLIT} rounds, save ({(t2 - t1) * 1e3:.1f} ms, arrays.npz "
        f"{size} bytes, meta.json {meta} bytes), restore "
        f"({(t3 - t2) * 1e3:.1f} ms) and {rounds - RESUME_SPLIT} more in "
        f"{t_split:.3f} s; cohorts, ranks, target_ranks, bytes and launches "
        f"equal {'ok' if same_ints else 'FAIL'}; train loss "
        f"{floats['train_loss'][0]}, eval acc {floats['eval_acc'][0]}, eval "
        f"loss {floats['eval_loss'][0]}; bits equal to the straight run: "
        + ("all (losses, eval metrics, global factors, head)" if not differ
           else f"not for {differ}"))
    if not same_ints:
        raise AssertionError("(b) the resumed run's integers differ")
    if differ:
        # not bit for bit: the losses to phase 6's card-vs-CPU limit, the
        # accuracy exactly, the global update normwise to phase 7's limit
        worst = max(abs(a - b) for k in ("train_loss", "eval_loss")
                    for a, b in zip(*floats[k]))
        alpha, r_max = cfg.lora.alpha, cfg.lora.r_max
        upd = max(rel_err(*(
            ((alpha / r_max) * s.global_lora[t]["A"].double()
             @ s.global_lora[t]["B"].double()).cpu()
            for s in (resumed, straight))) for t in straight.global_lora)
        ok = (worst <= TRAIN_LOSS_ATOL and upd <= AGG_UPD_REL
              and floats["eval_acc"][0] == floats["eval_acc"][1])
        log(f"  (b) held instead: losses |diff| max {worst:.3e} (<= "
            f"{TRAIN_LOSS_ATOL:.0e}), global update rel err {upd:.3e} (<= "
            f"{AGG_UPD_REL:.0e}), eval acc equal "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("(b) the resumed run differs")
    launches = {}
    for sched in (s_sched, a_sched, b_sched):
        for k, v in sched.launches.items():
            launches[k] = launches.get(k, 0) + v
    return {k: v for k, v in launches.items() if v}


# ---------------------------------------------------------------------------
# phase 11: next-token LM training on full-width Gemma-2B
# ---------------------------------------------------------------------------

# The data's vocabulary: make_bigram_lm holds its chain as a (V, V) float64
# table on the host, 524 GB at Gemma-2B's 256000; the model keeps all
# 256000 logits, so the loss still spans the whole vocabulary.
LM_DATA_VOCAB = 4096
LM_EXAMPLE = os.path.join(ROOT, "examples", "lm_pretrain_torch.py")
# (a) one train step at full width, depth cut to 2 layers so that the CPU
# side is quick; held to phase 9 (a)'s limits (TRAIN_LOSS_ATOL, TRAIN_REL)
LM_STEP = dict(layers=2, batch=4, seq=32, q_chunk=8, lr=3e-3)
# (b) the example's loop at full width and depth (the reference example's
# settings, its 200 steps cut to 100)
LM_LOOP = dict(steps=100, batch=16, seq=64, lr=3e-3, q_chunk=64)
LM_DROP_NATS = 1.0       # the last 10 losses' mean this far below the first
LM_PROFILED = 3
# (c) remat and q_chunk at length, from (b)'s trained weights: per-layer
# recomputation runs the same operations on the same inputs again, so the
# gradients are predicted bit for bit and held to REMAT_REL of each leaf's
# norm; query chunks of 256 against one chunk of 1024 sum the same
# products per score, in other GEMM shapes, held to QCHUNK_REL
LM_LONG = dict(batch=2, seq=1024, q_chunk=256)
REMAT_REL = 1e-6
QCHUNK_REL = 1e-5
ADAM_EPS = 1e-8          # adamw's default, which the example's train takes


def _lm_example():
    """``examples/lm_pretrain_torch.py`` as a module (``examples/`` is not
    a package)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("lm_pretrain_torch",
                                                  LM_EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lm_expect(ops, layers: int, remat: bool) -> dict:
    """Launches of one LM step: q, k, v and o in every layer, the forward
    twice under remat (the backward runs each layer again)."""
    per = 4 * layers
    expect = {name: 0 for name in ops.LAUNCHES}
    expect.update(lora_matmul=per * (2 if remat else 1),
                  lora_matmul_dx=per, lora_matmul_grad_ab=per)
    return expect


def _norm_rel(torch, got, want) -> float:
    """||got - want|| / ||want|| in float64, on want's device."""
    want = want.double()
    den = float(torch.linalg.vector_norm(want))
    num = float(torch.linalg.vector_norm(got.to(want.device).double() - want))
    return num / den if den else (0.0 if num == 0 else math.inf)


def lm_step_against_cpu(torch, example, cfg_full) -> None:
    """(a) one ``train`` step of the example on the card against the CPU
    (plain versions): Gemma-2B's full width at 2 layers, the same weights
    (seed 0 on the CPU, copied to the card) with live adapters (B small
    and random, so that A's and the mask's gradients carry signal), the
    same rows: the loss, every leaf's gradient, every leaf's change after
    the step, and the card's launches."""
    from repro_torch.data import make_bigram_lm
    from repro_torch.fed import simulation
    from repro_torch.kernels import ops
    from repro_torch.models import model as model_lib

    t0 = time.perf_counter()
    cfg = cfg_full.with_(num_layers=LM_STEP["layers"])
    cpu = model_lib.init_params(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(1)
    for ad in cpu.lora.values():
        ad["B"] = 0.05 * torch.randn(ad["B"].shape, generator=gen)
    data = make_bigram_lm(64, LM_STEP["seq"], LM_DATA_VOCAB, seed=0)
    grad_step = simulation.pretrain_loss_and_grads
    res = {}
    for side, dev in (("cpu", "cpu"), ("card", "cuda")):
        params = cpu if dev == "cpu" else cpu.to_device(dev)
        seen = {}

        def hooked(tree, batch, cfg_, **kw):
            ops.reset_launches()
            loss, grads = grad_step(tree, batch, cfg_, **kw)
            seen.update(loss=float(loss), grads=_leaf_paths(grads),
                        launches=dict(ops.LAUNCHES))
            return loss, grads

        before = _leaf_paths(params.tree())
        simulation.pretrain_loss_and_grads = hooked
        t1 = time.perf_counter()
        try:
            trained, losses = example.train(
                cfg, params, data, steps=1, batch=LM_STEP["batch"],
                lr=LM_STEP["lr"], remat=True, q_chunk=LM_STEP["q_chunk"],
                device=dev)
            torch.cuda.synchronize()
        finally:
            simulation.pretrain_loss_and_grads = grad_step
        res[side] = dict(seen, secs=time.perf_counter() - t1, before=before,
                         after=_leaf_paths(trained.tree()), loss=losses[0])
        del params, trained
    dl = abs(res["card"]["loss"] - res["cpu"]["loss"])
    worst = dict(g=(0.0, ""), c=(0.0, ""), all=(0.0, ""))
    skipped, wrong = {}, 0
    for path, g_cpu in res["cpu"]["grads"].items():
        name = "/".join(path)
        g_card = res["card"]["grads"][path].cpu()
        before = res["cpu"]["before"][path]
        du_c = res["cpu"]["after"][path] - before
        du_g = res["card"]["after"][path].cpu() - before
        change = float(torch.linalg.vector_norm(du_c.double()))
        if change == 0.0:
            raise AssertionError(f"LM step: {path} did not move")
        # AdamW's first step moves an element by lr g / (|g| + eps): about
        # lr against g's sign, but in proportion to g where |g| is within a
        # few eps of zero. There the elements' own gradient difference dg
        # moves the update by about eps dg / (|g| + eps)^2 of lr, and where
        # the two gradients differ in sign (|g| within dg of zero) by up to
        # 2 lr. Such elements are counted and must each have moved against
        # the card's own gradient (or not at all); the rest are held to the
        # CPU side's change
        dg = (g_card - g_cpu).abs()
        skip = ((torch.sign(g_card) != torch.sign(g_cpu))
                | (ADAM_EPS * dg / (g_cpu.abs() + ADAM_EPS) ** 2 > TRAIN_REL))
        if bool(skip.any()):
            skipped[name] = int(skip.sum())
            wrong += int((du_g[skip] * g_card[skip] > 0).sum())
        diff = (du_g - du_c).double()
        for key, err in (
                ("g", rel_err(g_card, g_cpu)),
                ("c", float(torch.linalg.vector_norm(diff[~skip])) / change),
                ("all", float(torch.linalg.vector_norm(diff)) / change)):
            worst[key] = max(worst[key], (err, name))
    expect = _lm_expect(ops, cfg.num_layers, remat=True)
    got = res["card"]["launches"]
    ok = (dl <= TRAIN_LOSS_ATOL and worst["g"][0] <= TRAIN_REL
          and worst["c"][0] <= TRAIN_REL and not wrong and got == expect)
    log(f"  (a) one train step, {LM_STEP['batch']} x {LM_STEP['seq']} tokens,"
        f" remat, q_chunk {LM_STEP['q_chunk']}, {cfg.num_layers} layers at "
        f"full width ({cfg.param_count() / 1e6:.1f} M): loss card "
        f"{res['card']['loss']:.6f} cpu {res['cpu']['loss']:.6f} (|diff| "
        f"{dl:.2e} <= {TRAIN_LOSS_ATOL:.0e}); gradient rel err per leaf max "
        f"{worst['g'][0]:.2e} ({worst['g'][1]}) over "
        f"{len(res['cpu']['grads'])} leaves (<= {TRAIN_REL:.0e} of the "
        f"norm); card launches {got} (expect {expect['lora_matmul']} "
        f"forward, {expect['lora_matmul_dx']} dx, "
        f"{expect['lora_matmul_grad_ab']} dA/dB); step card "
        f"{res['card']['secs'] * 1e3:.1f} ms, cpu "
        f"{res['cpu']['secs'] * 1e3:.0f} ms")
    log(f"  (a) after the step: ||card - cpu|| / ||cpu change|| over every "
        f"element max {worst['all'][0]:.2e} ({worst['all'][1]}; not held); "
        f"elements whose update the gradients' own difference moves past "
        f"{TRAIN_REL:.0e} of lr through AdamW's eps, or whose gradients "
        f"differ in sign, by leaf {skipped or 'none'}, of which moved along "
        f"the card's own gradient {wrong} (must be 0); over the other "
        f"elements max {worst['c'][0]:.2e} ({worst['c'][1]}; <= "
        f"{TRAIN_REL:.0e}); in {time.perf_counter() - t0:.1f} s "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"LM step: card and CPU disagree (loss {dl}, "
                             f"{worst}, {wrong} moved the wrong way) or "
                             f"launches {got} != {expect}")


def lm_loop(torch, np, example, cfg) -> tuple:
    """(b) the example's ``train`` at full width and depth: every step's
    loss (finite), wall time between synchronizations and launches; the
    drop over the run against the chain's own NLL; then 3 profiled steps
    with AdamW's kernels apart. Returns (the trained weights, launches)."""
    from repro_torch.data import bigram_nll, make_bigram_lm
    from repro_torch.fed import simulation
    from repro_torch.kernels import ops
    from repro_torch.models import model as model_lib

    data = make_bigram_lm(4096, LM_LOOP["seq"], LM_DATA_VOCAB, seed=0)
    floor = bigram_nll(data, LM_DATA_VOCAB, seed=0)
    grad_step = simulation.pretrain_loss_and_grads
    steps = []

    def hooked(tree, batch, cfg_, **kw):
        torch.cuda.synchronize()
        start = time.perf_counter()
        ops.reset_launches()
        loss, grads = grad_step(tree, batch, cfg_, **kw)
        launches = dict(ops.LAUNCHES)
        value = float(loss)
        if not math.isfinite(value):
            raise AssertionError(
                f"LM step {len(steps)}: loss {value}; first non-finite leaf "
                f"of the weights {_first_nonfinite(tree)}, of the gradients "
                f"{_first_nonfinite(grads)}")
        steps.append(dict(start=start, loss=value, launches=launches))
        return loss, grads

    kw = dict(steps=LM_LOOP["steps"], batch=LM_LOOP["batch"],
              lr=LM_LOOP["lr"], remat=True, q_chunk=LM_LOOP["q_chunk"],
              device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    simulation.pretrain_loss_and_grads = hooked
    t0 = time.perf_counter()
    try:
        # the initial weights go in without a name here, so that train
        # lets them go after the first step
        trained, losses = example.train(
            cfg, model_lib.init_params(cfg, seed=0, device="cuda"), data,
            **kw)
        torch.cuda.synchronize()
    finally:
        simulation.pretrain_loss_and_grads = grad_step
    end = time.perf_counter()
    wall = end - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    expect = _lm_expect(ops, cfg.num_layers, remat=True)
    bad = [i for i, st in enumerate(steps) if st["launches"] != expect]
    walls = [b["start"] - a["start"] for a, b in zip(steps, steps[1:])]
    walls.append(end - steps[-1]["start"])
    tokens = kw["steps"] * kw["batch"] * LM_LOOP["seq"]
    last = float(np.mean(losses[-10:]))
    drop = losses[0] - last
    shown = [(i, round(v, 4)) for i, v in enumerate(losses)
             if i % 10 == 0 or i == len(losses) - 1]
    ok = (not bad and len(steps) == kw["steps"] and drop >= LM_DROP_NATS
          and [st["loss"] for st in steps] == losses)
    log(f"  (b) the example's train: {len(steps)} steps of {kw['batch']} x "
        f"{LM_LOOP['seq']} tokens, remat, q_chunk {kw['q_chunk']}, AdamW lr "
        f"{kw['lr']} (cosine, {example.WARMUP_STEPS} warmup steps), every "
        f"parameter ({cfg.param_count() / 1e9:.3f} B) in {wall:.3f} s: "
        f"{tokens / wall:.1f} tok/s; step p50 {np.median(walls) * 1e3:.3f} "
        f"ms (min {min(walls) * 1e3:.3f}, max {max(walls) * 1e3:.3f}; "
        f"synchronized at each step); peak memory {peak:.2f} GiB")
    log(f"  (b) losses (step, loss) {shown}; every loss finite; first "
        f"{losses[0]:.4f}, mean of the last 10 {last:.4f}: down {drop:.4f} "
        f"nats (>= {LM_DROP_NATS}); the chain's own NLL on the data "
        f"{floor:.4f} (a perfect model's floor), ln {LM_DATA_VOCAB} = "
        f"{math.log(LM_DATA_VOCAB):.4f}, ln {cfg.vocab_size} = "
        f"{math.log(cfg.vocab_size):.4f}")
    log(f"  (b) launches a step: {steps[0]['launches']} (expect "
        f"{expect['lora_matmul']} forward: q, k, v and o in "
        f"{cfg.num_layers} layers, run again by remat; "
        f"{expect['lora_matmul_dx']} dx and {expect['lora_matmul_grad_ab']} "
        f"dA/dB; no other kernel of ours) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(
            f"LM loop: launches differ at steps {bad[:5]}, {len(steps)} "
            f"steps, or the loss fell {drop} < {LM_DROP_NATS} nats")
    launches = {name: sum(st["launches"][name] for st in steps) for name in
                ("lora_matmul", "lora_matmul_dx", "lora_matmul_grad_ab")}

    # 3 more steps from the trained weights under the profiler; the
    # example runs its update inside record_function("adamw")
    def three_steps():
        example.train(cfg, trained, data, **dict(kw, steps=LM_PROFILED))

    events = profile_window(torch, f"{LM_PROFILED} LM steps", three_steps,
                            group=train_group, annotation="adamw")
    groups = group_ms(events, train_group, "adamw")
    log("  (b) device ms a step: " + ", ".join(
        f"{g} {v / LM_PROFILED:.3f}" for g, v in sorted(groups.items())))
    return trained, launches


def lm_long(torch, cfg, trained) -> dict:
    """(c) one gradient step at batch 2 x 1024 from (b)'s trained weights:
    without remat and with it (q_chunk 256), and with it at one chunk of
    1024; each variant's loss, gradients, launches, peak memory and time
    (after one unmeasured warm-up step). Returns the measured variants'
    launches."""
    from repro_torch.data import make_bigram_lm
    from repro_torch.fed import simulation
    from repro_torch.kernels import ops

    data = make_bigram_lm(LM_LONG["batch"], LM_LONG["seq"], LM_DATA_VOCAB,
                          seed=1)
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in data.items()}
    tree = trained.tree()
    variants = (("no remat", False, LM_LONG["q_chunk"]),
                ("remat", True, LM_LONG["q_chunk"]),
                ("remat, one chunk", True, LM_LONG["seq"]))
    simulation.pretrain_loss_and_grads(tree, batch, cfg, remat=True,
                                       q_chunk=LM_LONG["q_chunk"])
    gc.collect()
    out, launches = {}, {}
    for label, remat, q_chunk in variants:
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        loss, grads = simulation.pretrain_loss_and_grads(
            tree, batch, cfg, remat=remat, q_chunk=q_chunk)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        got = dict(ops.LAUNCHES)
        expect = _lm_expect(ops, cfg.num_layers, remat)
        log(f"  (c) {label} (q_chunk {q_chunk}), {LM_LONG['batch']} x "
            f"{LM_LONG['seq']} tokens: loss {float(loss):.6f}; step "
            f"{secs * 1e3:.1f} ms; peak {peak / 2**30:.2f} GiB, "
            f"{(peak - resident) / 2**30:.2f} GiB above the "
            f"{resident / 2**30:.2f} GiB resident; launches {got} "
            f"{'ok' if got == expect else 'FAIL'}")
        if got != expect:
            raise AssertionError(f"(c) {label}: launches {got} != {expect}")
        for name in ("lora_matmul", "lora_matmul_dx", "lora_matmul_grad_ab"):
            launches[name] = launches.get(name, 0) + got[name]
        out[label] = (float(loss), _leaf_paths(grads))
        del loss, grads

    def hold(label, ref, limit, why):
        (la, ga), (lb, gb) = out[label], out[ref]
        errs = {p: _norm_rel(torch, ga[p], gb[p]) for p in gb}
        same = [p for p in gb if torch.equal(ga[p], gb[p])]
        over = ["/".join(p) for p, e in errs.items() if e > limit]
        dl = abs(la - lb) / abs(lb)
        ok = not over and dl <= limit
        differ = ["/".join(p) for p in gb if p not in same]
        log(f"  (c) {label} against {ref}: loss rel diff {dl:.2e}; "
            f"gradients bit for bit in {len(same)} of {len(gb)} leaves "
            f"(not: {', '.join(differ[:6]) or 'none'}"
            f"{', ...' if len(differ) > 6 else ''}), "
            f"rel err max {max(errs.values()):.2e} (<= {limit:.0e} of the "
            f"norm: {why}); leaves over the limit {over or 'none'} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"(c) {label} against {ref}: loss {dl}, "
                                 f"leaves {over}")

    hold("remat", "no remat", REMAT_REL, "the same operations run again")
    hold("remat, one chunk", "remat", QCHUNK_REL,
         "the same products per score in other GEMM shapes")
    return launches


def run_lm_training(torch, np) -> dict:
    """Phase 11. Returns the lora kernels' launches over (b)'s steps and
    (c)'s measured variants."""
    from repro_torch.configs import get_config

    cfg = get_config("gemma-2b")
    example = _lm_example()
    lm_step_against_cpu(torch, example, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    trained, launches = lm_loop(torch, np, example, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    for name, n in lm_long(torch, cfg, trained).items():
        launches[name] += n
    return launches


# ---------------------------------------------------------------------------
# phase 12: the semi-synchronous and buffered asynchronous rounds on
# full-width RoBERTa-large
# ---------------------------------------------------------------------------

# Phase 6's base (the same seed, built on the CPU and moved), phase 8's 16
# clients with ranks in [2, 8], each client's relative speed from the
# reference's example (fed_finetune.py): 0.5 to 2.0.
ASYNC_SPEEDS = (0.5, 2.0)
# (a) SemiSync: the deadline is the 0.75 quantile of 1 / speed, hlora
#     factored, 4 clients a round, 3 rounds
SEMI_ROUNDS = 3
SEMI_QUANTILE = 0.75
# (b) BufferedAsync: 12 events (3 rounds x 4 clients), merged 4 at a time
ASYNC_BUFFER = 4
ASYNC_BASE_WEIGHT = 0.5
# the head after a flush, normwise against the float64 weighted mean of the
# global head and the buffer's heads: float32 products of K + 1 terms
ASYNC_HEAD_REL = 1e-5
# (c) mid-flight: buffer 3, no drain, 4 events + save + restore + 3 events
# against 7 straight
MIDFLIGHT_BUFFER = 3
MIDFLIGHT_SPLIT = (4, 3)


def semisync_keep(np, speeds, cohort, deadline):
    """The reference's survivors, stragglers and simulated round time,
    recomputed here: a client survives when 1 / speed <= the deadline; when
    none does, the fastest is kept; the round closes at the slowest
    duration if nobody was cut, else at the deadline or the kept fastest's
    duration, whichever is later."""
    dur = 1.0 / speeds[np.asarray(cohort)]
    keep = dur <= deadline
    forced = not keep.any()
    if forced:
        keep[np.argmin(dur)] = True
    rt = float(dur.max()) if keep.all() else float(
        max(deadline, dur[keep].max()))
    return [c for c, k in zip(cohort, keep) if k], int((~keep).sum()), rt, \
        forced


def run_semisync(torch, np, cfg, base, speeds) -> dict:
    """(a) ``run_experiment(scheduler=SemiSync(speeds, deadline_quantile=
    0.75))``, every round under phase 8's checks (a), (b), (c), (d), and
    (e), the survivors, stragglers, round time and force-keep recomputed
    here, the uplink the survivors' messages alone; then one round with an
    infinite deadline against one ``SyncRound`` round from the same
    session state, bit for bit. Returns the launches and the rounds' wall
    times."""
    from repro_torch.fed import (FedSession, SemiSync, ServerConfig,
                                 SimConfig, SyncRound, make_experiment_setup,
                                 run_experiment)

    scfg = ServerConfig(**ROUND_SERVER, strategy="hlora",
                        svd_method="factored", rank_policy="random")
    expect = round_expect(cfg, scfg)
    label = "(a) SemiSync, hlora factored"
    sched = round_scheduler(torch, np, label, expect, profile=False,
                            base=SemiSync, speeds=speeds,
                            deadline_quantile=SEMI_QUANTILE)
    deadline = sched.resolved_deadline()
    if deadline != float(np.quantile(1.0 / speeds, SEMI_QUANTILE)):
        raise AssertionError(f"(a) deadline {deadline}")
    t0 = time.perf_counter()
    hist = run_experiment(cfg, SimConfig(rounds=SEMI_ROUNDS), scfg,
                          base_params=base, scheduler=sched)
    hold_history(label, SEMI_ROUNDS, hist, t0)
    forced_rounds = []
    for i, r in enumerate(sched.rounds):
        kept, cut, rt, forced = semisync_keep(np, speeds, r["cohort"],
                                              deadline)
        ups = [m.client_id for way, _, m in r["msgs"] if way == "up"]
        ok = (r["collected"] == kept == ups and hist["stragglers"][i] == cut
              and hist["round_time"][i] == rt)
        forced_rounds += [i] if forced else []
        log(f"  {label} round {i}: durations "
            f"{[round(float(1.0 / speeds[c]), 4) for c in r['cohort']]} "
            f"against "
            f"the deadline {deadline:.4f}: kept {r['collected']}, "
            f"stragglers {hist['stragglers'][i]}, round time "
            f"{hist['round_time'][i]:.4f} (recomputed: kept {kept}, {cut}, "
            f"{rt:.4f}{', force-kept' if forced else ''}); uplink "
            f"{hist['uplink_bytes'][i]} bytes in {len(ups)} messages, the "
            f"survivors' {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label} round {i}: survivors differ")
    log(f"  {label}: force-keep fired in rounds {forced_rounds} (none "
        f"expected unless every client of a cohort is slower than the "
        f"deadline)")
    launches = dict(sched.launches)
    walls = [r["wall"] for r in sched.rounds]

    # one round with an infinite deadline against one SyncRound round, each
    # from a fresh session of the same configuration (the same state)
    (session_kw, train, _, data_fn, _, eval_fn) = make_experiment_setup(
        cfg, SimConfig(rounds=1), scfg, base, device="cuda")
    sessions, hists = {}, {}
    for name, sch in (
            ("SyncRound", round_scheduler(torch, np, "(a) SyncRound", expect,
                                          profile=False)),
            ("SemiSync(deadline=inf)", round_scheduler(
                torch, np, "(a) SemiSync(deadline=inf)", expect,
                profile=False, base=SemiSync, speeds=speeds,
                deadline=float("inf")))):
        sessions[name] = FedSession(cfg, scfg, device="cuda", **session_kw)
        hists[name] = sch.run(sessions[name], train, data_fn, 1,
                              eval_fn=eval_fn)
        for k, v in sch.launches.items():
            launches[k] = launches.get(k, 0) + v
        walls += [r["wall"] for r in sch.rounds]
    (ss, sh), (ms, mh) = ((sessions[n], hists[n]) for n in sessions)
    differ = [k for k in sh if mh[k] != sh[k]]
    differ += _factor_bits_equal(torch, ms.global_lora, ss.global_lora)
    differ += [f"head {k}" for k in _factor_bits_equal(
        torch, ms.global_head, ss.global_head)]
    ok = not differ and mh["stragglers"] == [0]
    log(f"  (a) SemiSync(deadline=inf) against SyncRound, one round from the "
        f"same state: history, global factors and head "
        f"{'bit for bit ok' if ok else f'DIFFER in {differ} FAIL'}")
    if not ok:
        raise AssertionError(f"(a) deadline=inf differs from SyncRound in "
                             f"{differ}")
    return {"launches": launches, "walls": walls}


def host_heap(speeds, events, buffer, max_staleness):
    """The reference's event loop simulated on the host from the speeds
    alone: each event's (time, client, start version) and the staleness of
    every update at its flush."""
    import heapq
    heap = [(1.0 / speeds[c], c, 0) for c in range(len(speeds))]
    heapq.heapify(heap)
    version, buf, order, stale = 0, [], [], []
    for _ in range(events):
        t, c, v = heapq.heappop(heap)
        order.append((t, c, v))
        buf.append(v)
        if len(buf) == buffer:
            taus = [version - x for x in buf]
            stale += taus
            version += sum(tau <= max_staleness for tau in taus)
            buf = []
        heapq.heappush(heap, (t + 1.0 / speeds[c], c, version))
    return order, stale


def flush_truth(torch, alpha, stack, etan, ranks=None):
    """Eq. 2-3 of a flush in float64, target by target: ``stack`` is
    {target: [(A, B, mask) of the global, then of each update]}, ``etan``
    the normalized float64 weights. Returns {target: (dW' (L, d, d), its
    singular values, its rank-r truncation (L, len(ranks), d, d) at each of
    ``ranks``, r_max alone by default)}."""
    out = {}
    for t, items in stack.items():
        a = torch.stack([x[0] for x in items]).double()      # (K, L, d, r)
        b = torch.stack([x[1] for x in items]).double()
        m = torch.stack([x[2] for x in items]).double()      # (K, L, r)
        r = m.shape[-1]
        coef = etan[:, None] * alpha / torch.clamp(m.sum(-1), min=1.0)
        k, n_l, d_in, _ = a.shape
        a = (a * (m * coef[..., None])[..., None, :]).permute(
            1, 2, 0, 3).reshape(n_l, d_in, k * r)
        b = (b * m[..., :, None]).permute(1, 0, 2, 3).reshape(n_l, k * r, -1)
        out[t] = float64_truncations(torch, a, b, ranks or [r])
    return out


def hold_flush(torch, label, truth, lora, alpha):
    """A flush's new global adapter (its effective update, at rank r_max)
    against the float64 truth by phase 7's (c) and (d) limits."""
    from repro_torch.core.lora import delta_w
    r_max = next(iter(lora.values()))["mask"].shape[-1]
    for t, (dw, sig, trunc) in sorted(truth.items()):
        upd = delta_w({k: v.double() for k, v in lora[t].items()},
                      alpha)[:, None]
        hold_eckart_young(torch, f"{label} {t}", dw, sig, upd, [r_max])
        hold_updates(torch, f"{label} {t}", upd, trunc, sig, [r_max])


def async_weights(np, acfg, version, updates):
    """The reference's flush weights in float64 on the host, normalized:
    the global's residual, then each kept update's."""
    taus = [version - int(u.start_version) for u in updates]
    keep = [i for i, tau in enumerate(taus) if tau <= acfg.max_staleness]
    n = np.asarray([max(int(updates[i].num_examples), 1) for i in keep],
                   np.float64)
    ws = [acfg.base_weight * (1.0 + taus[i]) ** (-acfg.staleness_exp)
          * (n[j] / n.mean()) for j, i in enumerate(keep)]
    eta = np.asarray([max(1.0 - sum(ws), 0.0)] + ws, np.float64)
    return eta / eta.sum(), keep


def async_scheduler(torch, np, cfg, label, speeds):
    """A ``BufferedAsync`` that checks each event and flush on its way:
    every message by phase 8's (a) and (b), each event's byte columns
    against its two messages, each local step's launches (48 of each lora
    kernel), each eval's (48 forward), none in a flush (``factored``) or a
    re-broadcast; after each flush, the new global adapter against the
    float64 Eq. 2-3 of the stack (``flush_truth``, ``hold_flush``) and the
    head against the float64 weighted mean. Each event is timed from its
    batch to its re-broadcast, between device synchronizations, the
    checks left out. Keeps the last flush's inputs for the randomized
    flush."""
    from repro_torch.fed import BufferedAsync
    from repro_torch.fed.session import FedSession
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import lora_specs

    specs, r_max, L = lora_specs(cfg), cfg.lora.r_max, cfg.num_layers
    alpha = cfg.lora.alpha
    per_step = {"lora_matmul": 2 * L, "lora_matmul_dx": 2 * L,
                "lora_matmul_grad_ab": 2 * L}

    def delta(before):
        return {k: v - before[k] for k, v in ops.LAUNCHES.items()
                if v != before[k]}

    class ChipAsync(BufferedAsync):
        def run(self, session, local_train, data_fn, num_events,
                eval_fn=None, eval_every=None):
            head_bytes = sum(v.numel() * v.element_size()
                             for v in session.global_head.values())
            self.events, self.msgs, self.flushes = [], [], []
            self.engine_calls = 0
            self.launches, self.cids = {}, []
            cur = {"event": -1, "checks": 0.0}

            def count(d):
                for k, v in d.items():
                    self.launches[k] = self.launches.get(k, 0) + v

            def data(cid):
                torch.cuda.synchronize()
                cur.update(event=len(self.events), start=time.perf_counter(),
                           checks=0.0)
                self.cids.append(int(cid))
                return data_fn(cid)

            def train(base, trainable, masks, batch):
                before = dict(ops.LAUNCHES)
                out = local_train(base, trainable, masks, batch)
                got = delta(before)
                steps = int(batch["tokens"].shape[0])
                want = {k: v * steps for k, v in per_step.items()}
                if got != want:
                    raise AssertionError(f"{label} event {cur['event']}: "
                                         f"launches {got} != {want}")
                count(got)
                return out

            def evaluate(lora, head):
                before = dict(ops.LAUNCHES)
                m = eval_fn(lora, head)
                got = delta(before)
                if got != {"lora_matmul": 2 * L}:
                    raise AssertionError(f"{label}: eval launches {got}")
                count(got)
                return m

            def make_broadcast(cid, sl):
                msg = FedSession.make_broadcast(session, cid, sl)
                self.msgs.append((cur["event"], "down", sl, msg))
                return msg

            def make_update(cid, tree, start_version, head=None, log=True):
                msg = FedSession.make_update(session, cid, tree,
                                             start_version, head, log)
                self.msgs.append((cur["event"], "up", tree, msg))
                return msg

            def flush_async(updates):
                g = session.global_lora
                head0 = session.global_head
                version = session.version
                etan, keep = async_weights(np, session.acfg, version,
                                           updates)
                adapters = [session._unpack_update_adapter(updates[i])
                            for i in keep]
                before = dict(ops.LAUNCHES)
                calls = self.engine_calls
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                flags = FedSession.flush_async(session, updates)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                if delta(before) or self.engine_calls != calls + 1 or \
                        not all(flags):
                    raise AssertionError(f"{label}: flush launches "
                                         f"{delta(before)}, engine calls "
                                         f"{self.engine_calls - calls}, "
                                         f"flags {flags}")
                t1 = time.perf_counter()
                n = len(self.flushes)
                etan_t = torch.tensor(etan, dtype=torch.float64,
                                      device="cuda")
                stack = {t: [(g[t]["A"], g[t]["B"], g[t]["mask"])]
                         + [(ad[t]["A"], ad[t]["B"], ad[t]["mask"])
                            for ad in adapters] for t in g}
                hold_flush(torch, f"{label} flush {n} (K {len(keep)})",
                           flush_truth(torch, alpha, stack, etan_t),
                           session.global_lora, alpha)
                heads = [head0] + [updates[i].head for i in keep]
                worst = 0.0
                for k, v in session.global_head.items():
                    want = sum(w * h[k].double() for w, h in
                               zip(etan_t, heads))
                    worst = max(worst, rel_err(v, want.cpu()))
                if not worst <= ASYNC_HEAD_REL:
                    raise AssertionError(f"{label} flush {n}: head rel err "
                                         f"{worst}")
                self.flushes.append(dict(
                    ms=ms, version=version, head_rel=worst,
                    staleness=[version - int(u.start_version)
                               for u in updates],
                    inputs=(g, head0, list(updates), version)))
                log(f"  {label} flush {n}: {len(updates)} updates at version"
                    f" {version}, staleness {self.flushes[-1]['staleness']},"
                    f" weights {[round(float(w), 6) for w in etan]}; "
                    f"{ms:.3f} ms; one engine call, no kernel of ours; head "
                    f"rel err {worst:.2e} (<= {ASYNC_HEAD_REL:.0e}) ok")
                torch.cuda.synchronize()
                cur["checks"] += time.perf_counter() - t1
                return flags

            def adapter_for(cid):
                before = dict(ops.LAUNCHES)
                out = FedSession.adapter_for(session, cid)
                if delta(before):
                    raise AssertionError(f"{label}: adapter_for launched "
                                         f"{delta(before)}")
                if cur["event"] >= 0:
                    torch.cuda.synchronize()
                    self.events.append(time.perf_counter() - cur["start"]
                                       - cur["checks"])
                return out

            engine = session.engine
            sched = self

            class Counting:
                def __call__(self_, *a, **kw):
                    sched.engine_calls += 1
                    return engine(*a, **kw)

            session.engine = Counting()
            session.make_broadcast = make_broadcast
            session.make_update = make_update
            session.flush_async = flush_async
            session.adapter_for = adapter_for
            try:
                hist = super().run(session, train, data, num_events,
                                   evaluate if eval_fn else None, eval_every)
            finally:
                for name in ("make_broadcast", "make_update", "flush_async",
                             "adapter_for"):
                    delattr(session, name)
                session.engine = engine
            self.session = session
            # (a) (b) every message; each event's columns against its own
            t1 = time.perf_counter()
            per_event = {}
            for event, way, full, msg in self.msgs:
                n = hold_message(torch, msg, full,
                                 session._client_ranks(msg.client_id), specs,
                                 head_bytes, r_max, L)
                key = "downlink_bytes" if way == "down" else "uplink_bytes"
                per_event.setdefault((event, key), []).append(n)
            for e in range(num_events):
                for key in ("downlink_bytes", "uplink_bytes"):
                    got = per_event.get((e, key), [])
                    if len(got) != 1 or hist[key][e] != got[0]:
                        raise AssertionError(f"{label} event {e}: {key} "
                                             f"{hist[key][e]} against the "
                                             f"messages' {got}")
            cold = len(per_event.get((-1, "downlink_bytes"), []))
            log(f"  {label}: (a) (b) {len(self.msgs)} messages held ({cold} "
                f"cold broadcasts); every event's byte columns equal to its "
                f"update and its re-broadcast ok ({time.perf_counter() - t1:.1f}"
                f" s of checks)")
            return hist

    return ChipAsync


def run_buffered_async(torch, np, cfg, base, cpu_base, speeds) -> dict:
    """(b) ``run_experiment(scheduler=BufferedAsync(speeds, buffer_size=4,
    acfg=AsyncConfig(base_weight=0.5)))``: 12 events under
    ``async_scheduler``'s checks, the event order and staleness against
    ``host_heap``, flushes [4, 4, 4] with one engine call each, version 12;
    then the last flush's buffer flushed again under ``randomized``:
    recon_agg launched once, at Kc 5, and the card's flush against the same
    buffer flushed by a CPU session (phase 7's (b) and (d) limits) and
    against float64 Eq. 2-3 (phase 7's (c) and (d)). Returns the launches
    and the events' wall times."""
    from repro_torch.core import agg_engine
    from repro_torch.fed import (AsyncConfig, FedSession, ServerConfig,
                                 SimConfig, run_experiment)
    from repro_torch.kernels import ops

    scfg = ServerConfig(**ROUND_SERVER, strategy="hlora",
                        svd_method="factored", rank_policy="random")
    acfg = AsyncConfig(base_weight=ASYNC_BASE_WEIGHT)
    label = "(b) BufferedAsync, hlora factored"
    sim = SimConfig(rounds=SEMI_ROUNDS)
    events = sim.rounds * scfg.clients_per_round
    sched = async_scheduler(torch, np, cfg, label, speeds)(
        speeds=speeds, buffer_size=ASYNC_BUFFER, acfg=acfg)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    hist = run_experiment(cfg, sim, scfg, base_params=base, scheduler=sched)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    session = sched.session
    # the run's launches, read once after it, are the events' and evals'
    run_launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    if run_launches != sched.launches:
        raise AssertionError(f"{label}: launches {run_launches} against "
                             f"the events' and evals' {sched.launches}")
    order, stale = host_heap(speeds, events, ASYNC_BUFFER,
                             acfg.max_staleness)
    versions = [int(m.start_version) for _, way, _, m in sched.msgs
                if way == "up"]
    got_order = list(zip(hist["time"], sched.cids, versions))
    values = hist["eval_acc"] + hist["eval_loss"]
    ok = (got_order == order and session.staleness_log == stale
          == hist["staleness"] and hist["flush_events"] == [ASYNC_BUFFER] * 3
          and all(hist["accepted"]) and sched.engine_calls == 3
          and session.version == events and len(hist["eval_acc"]) == 4
          and all(math.isfinite(v) for v in values))
    log(f"  {label}: {events} events in {wall:.1f} s; clients "
        f"{sched.cids}, times {[round(float(t), 4) for t in hist['time']]}"
        f", start "
        f"versions {versions}; staleness {session.staleness_log} (host heap: "
        f"{stale}); flush_events {hist['flush_events']}, engine calls "
        f"{sched.engine_calls}, version {session.version}; eval acc "
        f"{[round(v, 4) for v in hist['eval_acc']]}, eval loss "
        f"{[round(v, 5) for v in hist['eval_loss']]} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: events {got_order} against {order}, "
                             f"history {hist}")
    launches = dict(sched.launches)

    # the last flush's buffer again, under randomized, on the card and on
    # the CPU, from the global adapter and head it met
    g, head0, updates, version = sched.flushes[-1]["inputs"]
    rcfg = ServerConfig(**ROUND_SERVER, strategy="hlora",
                        svd_method="randomized", rank_policy="random")
    sides = {}
    for side, dev, params in (("card", "cuda", base), ("host", "cpu",
                                                        cpu_base)):
        s = FedSession(cfg, rcfg, params, client_sizes=session.client_sizes,
                       acfg=acfg, device=dev)
        s.global_lora = {t: {k: v.to(dev) for k, v in ad.items()}
                         for t, ad in g.items()}
        s.global_head = {k: v.to(dev) for k, v in head0.items()}
        s.version = version
        sides[side] = s
    shapes = []
    launch = ops.recon_agg

    def recorded(a, b, eta):
        shapes.append(tuple(a.shape))
        return launch(a, b, eta)

    agg_engine.ops.recon_agg = recorded
    try:
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        sides["card"].flush_async(updates)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = {k: v for k, v in ops.LAUNCHES.items() if v}
    finally:
        agg_engine.ops.recon_agg = launch
    t0 = time.perf_counter()
    sides["host"].flush_async(updates)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    kc = len(updates) + 1
    want_shape = (2 * cfg.num_layers, kc, cfg.d_model, cfg.lora.r_max)
    ok = got == {"recon_agg": 1} and shapes[:1] == [want_shape]
    log(f"  (b) the last buffer again under randomized: {ms:.3f} ms on the "
        f"card, {cpu_ms:.1f} ms on the CPU; launches {got}, recon_agg at "
        f"{shapes} (expect one, at {want_shape}: Kc {kc}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"(b) randomized flush: launches {got}, "
                             f"shapes {shapes}")
    launches["recon_agg"] = launches.get("recon_agg", 0) + 1
    etan, keep = async_weights(np, acfg, version, updates)
    adapters = [sides["card"]._unpack_update_adapter(updates[i])
                for i in keep]
    stack = {t: [(g[t]["A"], g[t]["B"], g[t]["mask"])]
             + [(ad[t]["A"], ad[t]["B"], ad[t]["mask"]) for ad in adapters]
             for t in g}
    truth = flush_truth(torch, cfg.lora.alpha, stack, torch.tensor(
        etan, dtype=torch.float64, device="cuda"))
    ranks = sum(int(ad[t]["mask"][0].sum()) for ad in adapters
                for t in list(ad)[:1])
    where = "(b) randomized flush"
    if ranks + cfg.lora.r_max > cfg.lora.r_max + AGG_OVERSAMPLE:
        where += (f" (ranks summing to {ranks} + the global's "
                  f"{cfg.lora.r_max} > r_max + oversample: outside "
                  f"svd_randomized's contract)")
    hold_flush(torch, f"{where}, card against float64", truth,
               sides["card"].global_lora, cfg.lora.alpha)
    from repro_torch.core.lora import delta_w
    for t, (dw, sig, _) in sorted(truth.items()):
        card, cpu = (delta_w({k: v.double().cuda() for k, v in
                              sides[d].global_lora[t].items()},
                             cfg.lora.alpha)[:, None] for d in ("card", "host"))
        hold_spectra(f"(b) randomized flush {t}, card against CPU",
                     sides["card"].last_spectrum[t].double(),
                     sides["host"].last_spectrum[t].double().cuda(), sig)
        hold_updates(torch, f"(b) randomized flush {t}, card against CPU",
                     card, cpu, sig, [cfg.lora.r_max])
    return {"launches": launches, "walls": sched.events}


def run_midflight(torch, np, cfg, base, speeds) -> dict:
    """(c) ``BufferedAsync(buffer_size=3, drain=False)`` on the card with
    batches that depend on the client and its call count alone: 4 events,
    ``save``, ``FedSession.restore``, 3 events, against 7 straight. The
    heap, staleness, versions, comm logs and the buffer's bytes equal; the
    global factors and head bit for bit. Returns the launches."""
    import shutil
    from repro_torch.data import (client_batches, dirichlet_partition,
                                  make_pair_classification)
    from repro_torch.fed import (AsyncConfig, BufferedAsync, FedSession,
                                 ServerConfig, SimConfig,
                                 make_experiment_setup)
    from repro_torch.kernels import ops

    scfg = ServerConfig(**ROUND_SERVER, strategy="hlora",
                        svd_method="factored", rank_policy="random")
    sim = SimConfig()
    (session_kw, _, local_train, _, _, _) = make_experiment_setup(
        cfg, sim, scfg, base, device="cuda")
    tokens, labels = make_pair_classification(
        sim.task, sim.num_examples, seed=sim.seed, vocab_size=cfg.vocab_size)
    shards = dirichlet_partition(labels, scfg.num_clients,
                                 sim.dirichlet_alpha, seed=sim.seed)

    def stateless():
        calls = {}

        def data(cid):
            n = calls[cid] = calls.get(cid, 0) + 1
            return client_batches(tokens, labels, shards[cid],
                                  sim.local_steps, sim.local_batch,
                                  seed=1000 * n + int(cid))
        return data

    def sched():
        return BufferedAsync(speeds=speeds, buffer_size=MIDFLIGHT_BUFFER,
                             acfg=AsyncConfig(max_staleness=50), drain=False)

    ckpt = os.path.join(ROOT, "build", "phase12", "midflight")
    shutil.rmtree(ckpt, ignore_errors=True)
    first, second = MIDFLIGHT_SPLIT
    launches = {}

    def counted(fn):
        torch.cuda.synchronize()
        ops.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        for k, v in ops.LAUNCHES.items():
            launches[k] = launches.get(k, 0) + v
        return out

    t0 = time.perf_counter()
    full = FedSession(cfg, scfg, device="cuda", **session_kw)
    counted(lambda: sched().run(full, local_train, stateless(),
                                first + second))
    t_full = time.perf_counter() - t0
    t0 = time.perf_counter()
    a = FedSession(cfg, scfg, device="cuda", **session_kw)
    data = stateless()
    counted(lambda: sched().run(a, local_train, data, first))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    path = a.save(ckpt)
    t2 = time.perf_counter()
    b = FedSession.restore(ckpt, cfg, scfg, device="cuda", **session_kw)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    restored = (b.async_state["heap"] == a.async_state["heap"]
                and [u.to_bytes() for u in b.async_state["buffer"]]
                == [u.to_bytes() for u in a.async_state["buffer"]]
                and sorted(b.async_state["pending"])
                == list(range(scfg.num_clients)))
    counted(lambda: sched().run(b, local_train, data, second))
    t_split = time.perf_counter() - t0
    size = os.path.getsize(os.path.join(path, "arrays.npz"))
    ints = (restored and b.version == full.version
            and b.staleness_log == full.staleness_log
            and b.async_state["heap"] == full.async_state["heap"]
            and b.comm_log == full.comm_log
            and [u.to_bytes() for u in b.async_state["buffer"]]
            == [u.to_bytes() for u in full.async_state["buffer"]])
    differ = _factor_bits_equal(torch, b.global_lora, full.global_lora)
    differ += [f"head {k}" for k in _factor_bits_equal(
        torch, b.global_head, full.global_head)]
    per_step = 2 * cfg.num_layers * sim.local_steps * 2 * (first + second)
    want = {"lora_matmul": per_step, "lora_matmul_dx": per_step,
            "lora_matmul_grad_ab": per_step}
    got = {k: v for k, v in launches.items() if v}
    log(f"  (c) mid-flight: {first + second} events straight in "
        f"{t_full:.1f} s; {first} events, save ({(t2 - t1) * 1e3:.1f} ms, "
        f"arrays.npz {size} bytes, {len(a.async_state['buffer'])} update(s) "
        f"buffered, version {a.version}), restore ({(t3 - t2) * 1e3:.1f} "
        f"ms) and {second} more in {t_split:.1f} s: heap, staleness "
        f"{b.staleness_log}, version {b.version}, comm logs and buffer bytes "
        f"{'equal ok' if ints else 'DIFFER FAIL'}; global factors and head "
        + ("bit for bit ok" if not differ else f"DIFFER in {differ} FAIL")
        + f"; launches {got} (expect {want}) "
        f"{'ok' if got == want else 'FAIL'}")
    if not ints or differ or got != want:
        raise AssertionError("(c) the mid-flight resume differs")
    return got


def run_async_rounds(torch, np) -> dict:
    """Phase 12 on phase 6's base (the same seed): (a) ``run_semisync``,
    (b) ``run_buffered_async``, (c) ``run_midflight``; the wall time, peak
    memory and each scheduler's p50 time a round or an event. Returns the
    launches of all three."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib

    cfg = get_config("roberta-large")
    t0 = time.perf_counter()
    cpu = model_lib.init_params(cfg, seed=0, device="cpu")
    base = cpu.to_device("cuda")
    speeds = np.linspace(*ASYNC_SPEEDS, ROUND_SERVER["num_clients"])
    log(f"  phase 6's base rebuilt from its seed in "
        f"{time.perf_counter() - t0:.1f} s; 16 clients, speeds "
        f"{[round(float(v), 3) for v in speeds]}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches = {}
    semi = run_semisync(torch, np, cfg, base, speeds)
    buffered = run_buffered_async(torch, np, cfg, base, cpu, speeds)
    for part in (semi["launches"], buffered["launches"],
                 run_midflight(torch, np, cfg, base, speeds)):
        for k, v in part.items():
            launches[k] = launches.get(k, 0) + v
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  SemiSync round wall p50 {np.median(semi['walls']):.3f} s over "
        f"{len(semi['walls'])} rounds (min {min(semi['walls']):.3f}, max "
        f"{max(semi['walls']):.3f}); BufferedAsync event wall p50 "
        f"{np.median(buffered['walls']):.3f} s over "
        f"{len(buffered['walls'])} events (min "
        f"{min(buffered['walls']):.3f}, max {max(buffered['walls']):.3f}); "
        f"peak memory {peak:.2f} GiB; {device_line()}")
    return launches


# ---------------------------------------------------------------------------
# phase 13: population-scale federation on full-width RoBERTa-large
# ---------------------------------------------------------------------------

FED_EXAMPLE = os.path.join(ROOT, "examples", "fed_finetune_torch.py")
# (a) the example's population path: 10,000 synthetic clients, a cohort of 8
#     (sample rate 0.0008, so that each of the 7 rank buckets 2..8 has a
#     member), the rank-stratified sampler, 2 edges in 'stack' mode, int8 on
#     the wire, 2 sync rounds at the example's settings (8 local steps of
#     16 x 32 tokens, lr 1e-3), on phase 6's base (no pretraining step)
POP_ARGS = ["--population", "10000", "--sample-rate", "0.0008", "--edges",
            "2", "--codec", "int8", "--rounds", "2", "--task", "mrpc"]
# (b) one cohort of 8 of phase 8's 16 clients trained once, its stack merged
#     through the three paths on sessions of the same seed. 'engine' mode
#     under naive against the flat naive round at the reference test's
#     tolerance (tests/test_population.py: the nested weighted mean is the
#     flat one up to float32 rounding): dW' per element rtol 1e-4, atol 1e-5;
#     heads rtol 1e-5, atol 1e-6
POP_COHORT = 8
POP_DW_TOL = (1e-4, 1e-5)
POP_HEAD_TOL = (1e-5, 1e-6)
# (c) each codec on the card against the CPU, from the same tensors
POP_CODECS = ("bf16", "int8", "topk:4", "topk:8")


def _fed_example():
    """``examples/fed_finetune_torch.py`` as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("fed_finetune_torch",
                                                  FED_EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lora_launches(cfg, steps: int) -> dict:
    per_step = 2 * cfg.num_layers
    return {"lora_matmul": per_step * steps,
            "lora_matmul_dx": per_step * steps,
            "lora_matmul_grad_ab": per_step * steps}


def _counted(torch, ops) -> dict:
    torch.cuda.synchronize()
    return {k: v for k, v in ops.LAUNCHES.items() if v}


def population_path(torch, np, cfg, base) -> dict:
    """(a) ``run_population`` of the example, its ``FedSession`` and
    ``EdgeAggregate`` recorded: the residency counters, every cohort over
    every rank bucket, finite losses, each ``edge<i>_uplink`` row the bytes
    of its ``EdgeAggregate`` (4 + its header + its clients' int8 update
    bytes), the history's uplink the clients' bytes, the launches (48 of
    each lora kernel a client step, nothing else). Returns the launches and
    the rounds' wall times."""
    from repro_torch.fed import FedSession
    from repro_torch.fed import messages as msg_lib
    from repro_torch.kernels import ops

    example = _fed_example()
    args = example.parse_args(POP_ARGS)
    sim = example.sim_config(args)
    rounds, sent = [], []

    class Session(FedSession):
        def sample_cohort(self):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cohort = super().sample_cohort()
            rounds.append({"t0": t0, "cohort": [int(c) for c in cohort]})
            return cohort

        def aggregate_round(self, *a, **kw):
            super().aggregate_round(*a, **kw)
            torch.cuda.synchronize()
            rounds[-1]["wall"] = time.perf_counter() - rounds[-1]["t0"]

    class Edge(msg_lib.EdgeAggregate):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            if self._raw is None:             # the sender's, not a decode
                sent.append((len(rounds) - 1, self))

    example.FedSession = Session
    edge_cls = msg_lib.EdgeAggregate
    msg_lib.EdgeAggregate = Edge
    try:
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        hist, session = example.run_population(cfg, sim, args,
                                               base_params=base)
        got = _counted(torch, ops)
        wall = time.perf_counter() - t0
    finally:
        msg_lib.EdgeAggregate = edge_cls
    pop = session.population
    cohort = session.scfg.clients_per_round
    want = _lora_launches(cfg, args.rounds * cohort * sim.local_steps)
    buckets = set(range(2, 9))
    covered = all(set(int(r) for r in pop.ranks[np.asarray(r["cohort"])])
                  == buckets for r in rounds)
    ok = (cohort == POP_COHORT and pop.max_resident == cohort
          and pop.materialized_total == args.rounds * cohort
          and pop.resident() == 0 and session.metrics.counter(
              "fed.population.materialized").value == 2 * cohort
          and covered and len(rounds) == args.rounds
          and all(math.isfinite(v) for v in hist["train_loss"])
          and got == want)
    log(f"  (a) run_population: {pop.size} clients, cohort {cohort}, "
        f"{args.rounds} rounds in {wall:.1f} s; cohorts "
        f"{[r['cohort'] for r in rounds]} (ranks "
        f"{[[int(pop.ranks[c]) for c in r['cohort']] for r in rounds]}, "
        f"every bucket 2..8 {covered}); train loss "
        f"{[round(v, 5) for v in hist['train_loss']]}; materialized "
        f"{pop.materialized_total}, max resident {pop.max_resident}; "
        f"launches {got} (expect {want}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"(a) run_population: launches {got}, history "
                             f"{hist}")
    # each edge message: its row, its header and its clients' bytes
    lines = []
    for i in range(args.rounds):
        mine = [agg for rnd, agg in sent if rnd == i]
        clients = 0
        for agg in mine:
            raw = agg.to_bytes()
            hlen = int.from_bytes(raw[:4], "little")
            ups = [u.num_bytes for u in agg.updates]
            codecs = {msg_lib.unpack_wire(u.to_bytes())[1].get("codec")
                      for u in agg.updates}
            row = session.comm_log[f"edge{agg.edge_id}_uplink"][i]
            clients += sum(ups)
            if not (row == agg.num_bytes == len(raw) == 4 + hlen + sum(ups)
                    and codecs == {"int8"}):
                raise AssertionError(
                    f"(a) round {i} edge {agg.edge_id}: row {row}, message "
                    f"{agg.num_bytes}, header {hlen}, clients {ups}, codecs "
                    f"{codecs}")
            lines.append(f"round {i} edge {agg.edge_id}: {row} = 4 + "
                         f"{hlen} + {ups}")
        if len(mine) != 2 or hist["uplink_bytes"][i] != clients:
            raise AssertionError(f"(a) round {i}: {len(mine)} edge messages, "
                                 f"uplink {hist['uplink_bytes'][i]} against "
                                 f"the clients' {clients}")
    log(f"  (a) each edge<i>_uplink = 4 + header + its clients' int8 "
        f"updates, the uplink their sum: " + "; ".join(lines)
        + f"; downlink {hist['downlink_bytes']} ok")
    return {"launches": got, "walls": [r["wall"] for r in rounds]}


def hold_merge(torch, label, truth, lora, alpha, ranks) -> None:
    """A merge's new adapter (rank r_max, its directions in the SVD's
    order, every mask 1) against ``flush_truth`` at each of ``ranks``: its
    leading r directions, (alpha / r_max) A[..., :r] B[..., :r, :], against
    the rank-r truncation of dW' in float64 by phase 7's (c) and (d)
    limits. Every rank, not r_max alone: a stack with no client of rank
    r_max leaves the r_max-th direction near noise, where (d) has no gap to
    hold at."""
    for t, (dw, sig, trunc) in sorted(truth.items()):
        a, b = lora[t]["A"].double(), lora[t]["B"].double()
        r_max = a.shape[-1]
        if not bool((lora[t]["mask"] == 1).all()):
            raise AssertionError(f"{label} {t}: the merge's masks are not 1")
        upd = torch.stack([(alpha / r_max) * a[..., :r] @ b[..., :r, :]
                           for r in ranks], 1)
        hold_eckart_young(torch, f"{label} {t}", dw, sig, upd, ranks)
        hold_updates(torch, f"{label} {t}", upd, trunc, sig, ranks)
        del upd


def _allclose_worst(torch, got, want, rtol, atol) -> float:
    """max |got - want| / (atol + rtol |want|): <= 1 is allclose."""
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def aggregation_paths(torch, np, cfg, base) -> dict:
    """(b) one cohort of 8 trained once (48 launches of each lora kernel a
    step), then merged on sessions of the same seed: 'stack' against the
    flat round (factors, head, uplink row bit for bit); 'engine' under
    naive against flat naive (``POP_DW_TOL``, ``POP_HEAD_TOL``), its
    edge-to-root bytes below the flat uplink; 'engine' under hlora
    ``randomized``: 3 recon_agg launches (2 edges at Kc 4, the root at Kc
    2), each edge's merge against float64 Eq. 2-3 of its stack and the
    root's against float64 of the edge aggregates (phase 7's (c), (d)).
    Returns the launches, the cohort, the trained stack and the round-0
    broadcast for (c)."""
    from repro_torch.core import agg_engine
    from repro_torch.core.lora import delta_w
    from repro_torch.fed import (FedSession, HierarchicalTopology,
                                 ServerConfig, SimConfig, join_adapters,
                                 make_experiment_setup, split_adapters)
    from repro_torch.kernels import ops

    alpha = cfg.lora.alpha
    scfg = ServerConfig(**dict(ROUND_SERVER, clients_per_round=POP_COHORT),
                        strategy="hlora", svd_method="factored",
                        rank_policy="random")
    kw, train, _, data_fn, _, _ = make_experiment_setup(
        cfg, SimConfig(rounds=1), scfg, base)
    s0 = FedSession(cfg, scfg, **kw)
    cohort = s0.sample_cohort()
    stacked, heads = s0.broadcast_cohort(cohort)
    factors, masks = split_adapters(stacked)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    trainable, losses = train(s0.base, {"factors": factors, "head": heads},
                              masks, data_fn(cohort, 0))
    got = _counted(torch, ops)
    t_train = time.perf_counter() - t0
    steps = POP_COHORT * SimConfig().local_steps
    want = _lora_launches(cfg, steps)
    trained = join_adapters(trainable["factors"], masks)
    theads = trainable["head"]
    ok = got == want and bool(torch.isfinite(losses).all())
    log(f"  (b) one cohort {[int(c) for c in cohort]} (ranks "
        f"{[int(s0.ranks[c]) for c in cohort]}) trained: {steps} client "
        f"steps in {t_train:.1f} s, launches {got} (expect {want}), losses "
        f"finite {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"(b) training: launches {got}")
    launches = dict(got)

    def fresh(**over):
        s = FedSession(cfg, ServerConfig(**{**vars(scfg), **over}), **kw)
        c = s.sample_cohort()
        if not np.array_equal(c, cohort):
            raise AssertionError(f"(b) cohort {c} against {cohort}")
        return s

    def merge(label, session, topo, expect):
        torch.cuda.synchronize()
        ops.reset_launches()
        t = time.perf_counter()
        if topo is None:
            tree, up = session.collect_updates(cohort, trained, theads)
            session.aggregate_round(tree, cohort, stacked_heads=up)
        else:
            topo.aggregate(session, cohort, trained, theads)
        n = _counted(torch, ops)
        ms = (time.perf_counter() - t) * 1e3
        if n != expect:
            raise AssertionError(f"(b) {label}: launches {n}, expect "
                                 f"{expect}")
        return ms

    # stack against flat, hlora factored: bit for bit
    flat, stack = fresh(), fresh()
    ms_flat = merge("flat", flat, None, {})
    ms_stack = merge("stack", stack, HierarchicalTopology(2), {})
    differ = _factor_bits_equal(torch, stack.global_lora, flat.global_lora)
    differ += [f"head {k}" for k in _factor_bits_equal(
        torch, stack.global_head, flat.global_head)]
    edge_rows = [stack.comm_log[f"edge{e}_uplink"][0] for e in range(2)]
    headers = sum(edge_rows) - flat.comm_log["uplink"][0]
    ok = (not differ and stack.comm_log["uplink"] == flat.comm_log["uplink"]
          and 0 < headers < 4096)
    log(f"  (b) 'stack' (2 edges) against the flat round, hlora factored: "
        f"global factors and head "
        f"{'bit for bit' if not differ else f'DIFFER in {differ}'}; uplink "
        f"{stack.comm_log['uplink']} (flat {flat.comm_log['uplink']}), edge "
        f"rows {edge_rows} (their headers {headers} bytes); {ms_stack:.1f} "
        f"ms against {ms_flat:.1f} ms {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("(b) stack mode differs from the flat round")

    # engine under naive against flat naive
    flat, eng = fresh(strategy="naive"), fresh(strategy="naive")
    merge("flat naive", flat, None, {})
    ms_eng = merge("engine naive", eng,
                   HierarchicalTopology(2, edge_mode="engine"), {})
    dw = max(_allclose_worst(torch, delta_w(eng.global_lora[t], alpha),
                             delta_w(flat.global_lora[t], alpha),
                             *POP_DW_TOL) for t in flat.global_lora)
    hd = max(_allclose_worst(torch, eng.global_head[k], flat.global_head[k],
                             *POP_HEAD_TOL) for k in flat.global_head)
    edge_bytes = sum(eng.comm_log[f"edge{e}_uplink"][0] for e in range(2))
    ok = dw <= 1.0 and hd <= 1.0 and edge_bytes < flat.comm_log["uplink"][0]
    log(f"  (b) 'engine' under naive against flat naive: dW' worst "
        f"err/limit {dw:.3e} (rtol {POP_DW_TOL[0]:.0e}, atol "
        f"{POP_DW_TOL[1]:.0e}), heads {hd:.3e} (rtol {POP_HEAD_TOL[0]:.0e}, "
        f"atol {POP_HEAD_TOL[1]:.0e}); edge-to-root {edge_bytes} bytes "
        f"against the flat uplink {flat.comm_log['uplink'][0]}; {ms_eng:.1f} "
        f"ms {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("(b) engine mode under naive differs")

    # engine under hlora randomized: the engine's calls recorded
    eng = fresh(svd_method="randomized")
    calls, shapes = [], []
    engine, launch = eng.engine, ops.recon_agg

    def recorded_engine(tree, eta, alpha_, **kw2):
        out = engine(tree, eta, alpha_, **kw2)
        calls.append((tree, out[0]))
        return out

    def recorded(a, b, eta):
        shapes.append(tuple(a.shape))
        return launch(a, b, eta)

    eng.engine = recorded_engine
    agg_engine.ops.recon_agg = recorded
    topo = HierarchicalTopology(2, edge_mode="engine")
    try:
        ms_rand = merge("engine randomized", eng, topo, {"recon_agg": 3})
    finally:
        agg_engine.ops.recon_agg = launch
    items = 2 * cfg.num_layers
    want_shapes = [(items, 4, cfg.d_model, cfg.lora.r_max)] * 2 + [
        (items, 2, cfg.d_model, cfg.lora.r_max)]
    log(f"  (b) 'engine' under hlora randomized: {ms_rand:.1f} ms, recon_agg "
        f"launched 3 times at {shapes} (expect {want_shapes}) "
        f"{'ok' if shapes == want_shapes else 'FAIL'}")
    if shapes != want_shapes or len(calls) != 3:
        raise AssertionError(f"(b) randomized: shapes {shapes}, "
                             f"{len(calls)} engine calls")
    launches["recon_agg"] = 3
    groups = topo.assign(cohort)
    sizes = [eng.client_sizes[cohort[pos]].astype(np.float64)
             for pos in groups]
    weights = [n / n.sum() for n in sizes] + [
        np.asarray([n.sum() for n in sizes]) / sum(n.sum() for n in sizes)]
    labels = [f"edge {e}" for e in range(2)] + ["root"]
    for (tree, out), w, label in zip(calls, weights, labels):
        stack = {t: [(ad["A"][k], ad["B"][k], ad["mask"][k])
                     for k in range(len(w))] for t, ad in tree.items()}
        ranks = [int(tree[t]["mask"][k].reshape(-1, cfg.lora.r_max)[0].sum())
                 for t in list(tree)[:1] for k in range(len(w))]
        where = f"(b) randomized {label} (ranks {ranks})"
        if sum(ranks) > cfg.lora.r_max + AGG_OVERSAMPLE:
            where += (f", summing past r_max + oversample: outside "
                      f"svd_randomized's contract")
        ranks = list(range(1, cfg.lora.r_max + 1))
        truth = flush_truth(torch, alpha, stack, torch.tensor(
            w, dtype=torch.float64, device="cuda"), ranks)
        lora = {t: {k: v[0] for k, v in ad.items()} for t, ad in out.items()}
        hold_merge(torch, f"{where}, against float64", truth, lora, alpha,
                   ranks)
        del truth
    return {"launches": launches, "cohort": cohort, "trained": trained,
            "heads": theads, "broadcast": stacked, "session": s0}


def codecs_card_against_cpu(torch, np, paths) -> None:
    """(c) the cohort's 8 updates and its first client's round-0 broadcast
    (B = 0: every topk score ties at 0) encoded with each of ``POP_CODECS``
    on the card and on the CPU from the same tensors: the same bytes; then
    decoded on the card: int8 within scale/2 of each element (plus float32
    rounding of the quotient and the product, 2^-22 max|a|), bf16 within
    2^-8 relative, topk:8 (k >= r_max) the raw factors bit for bit, topk:4
    the kept directions exact and the others zero; the decode of the bytes
    on the host equal to it, bit for bit."""
    from repro_torch.fed import compress
    from repro_torch.fed import messages as msg_lib

    s0, cohort = paths["session"], paths["cohort"]
    r_max = s0.cfg.lora.r_max
    msgs = []
    for i, cid in enumerate(cohort):
        sl = {t: {leaf: ad[leaf][i] for leaf in ("A", "B", "mask")}
              for t, ad in paths["trained"].items()}
        ranks = {t: int(ad["mask"].reshape(-1, r_max)[0].sum())
                 for t, ad in sl.items()}
        msgs.append((msg_lib.ClientUpdate, dict(
            client_id=int(cid), start_version=0,
            num_examples=int(s0.client_sizes[cid])),
            msg_lib.truncate_adapter(sl, ranks),
            {k: v[i] for k, v in paths["heads"].items()}))
    cid = int(cohort[0])
    sl = {t: {"A": ad["A"][0], "B": ad["B"][0]}
          for t, ad in paths["broadcast"].items()}
    msgs.append((msg_lib.Broadcast, dict(version=0, client_id=cid),
                 msg_lib.truncate_adapter(sl, s0._client_ranks(cid)),
                 dict(s0.global_head)))

    def host(tree):
        return {k: host(v) if isinstance(v, dict) else v.cpu()
                for k, v in tree.items()}

    raw = sum(cls(**kw, adapter=ad, head=hd).num_bytes
              for cls, kw, ad, hd in msgs)
    sizes = []
    t0 = time.perf_counter()
    for spec in POP_CODECS:
        codec = compress.from_name(spec)
        total = 0
        worst = 0.0
        for cls, kw, ad, hd in msgs:
            card = cls(**kw, adapter=ad, head=hd, codec=codec).to_bytes()
            cpu = cls(**kw, adapter=host(ad), head=host(hd),
                      codec=codec).to_bytes()
            if card != cpu:
                raise AssertionError(f"(c) {spec}: {cls.__name__} to client "
                                     f"{kw['client_id']} differs on the "
                                     f"card from the CPU")
            total += len(card)
            arrays, meta = codec.encode_adapter(ad)
            dec = codec.decode_adapter(arrays, meta)
            back = cls.from_bytes(card).adapter
            for t, x in ad.items():
                for leaf in ("A", "B"):
                    a, d = x[leaf], dec[t][leaf]
                    if d.device.type != "cuda" or not torch.equal(
                            _bits(torch, d), _bits(torch, back[t][leaf])):
                        raise AssertionError(f"(c) {spec} {t}/{leaf}: the "
                                             f"card's decode differs from "
                                             f"the host's")
                    err = (d - a).abs()
                    if spec == "int8":
                        lim = meta[t][f"{leaf}_scale"] / 2 \
                            + 2.0 ** -22 * float(a.abs().max())
                        bad = float(err.max()) > lim
                        worst = max(worst, float(err.max()) / lim)
                    elif spec == "bf16":
                        bad = bool((err > 2.0 ** -8 * a.abs()).any())
                    elif spec == "topk:8":
                        bad = not torch.equal(d, a)
                    else:
                        keep = meta[t]["keep"]
                        dim = -1 if leaf == "A" else -2
                        drop = [j for j in range(a.shape[dim])
                                if j not in keep]
                        kept = d.index_select(dim, torch.tensor(
                            keep, device=d.device))
                        bad = not torch.equal(kept, a.index_select(
                            dim, torch.tensor(keep, device=a.device))) \
                            or bool(d.index_select(dim, torch.tensor(
                                drop, device=d.device, dtype=torch.long)
                            ).any()) or len(keep) != min(4, a.shape[dim])
                        if cls is msg_lib.Broadcast and keep != list(
                                range(len(keep))):
                            bad = True          # the all-zero tie
                    if bad:
                        raise AssertionError(f"(c) {spec}: {cls.__name__} "
                                             f"{kw['client_id']} {t}/{leaf} "
                                             f"decodes out of bounds")
        sizes.append(f"{spec} {total} ({total / raw:.3f} of raw)"
                     + (f", worst err/limit {worst:.4f}"
                        if spec == "int8" else ""))
    log(f"  (c) {len(msgs) - 1} updates and a round-0 broadcast, each codec "
        f"on the card and the CPU: the same bytes; decoded on the card "
        f"within bounds and equal to the host's decode; {len(msgs)} messages "
        f"{raw} bytes raw, " + ", ".join(sizes)
        + f" ({time.perf_counter() - t0:.1f} s) ok")


def run_population_phase(torch, np) -> dict:
    """Phase 13 on phase 6's base (the same seed): (a)
    ``population_path``, (b) ``aggregation_paths``, (c)
    ``codecs_card_against_cpu``; the wall time of each part, a round's
    p50 and the peak memory. Returns the launches of (a) and (b)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib

    cfg = get_config("roberta-large")
    t0 = time.perf_counter()
    base = model_lib.init_params(cfg, seed=0, device="cpu").to_device("cuda")
    log(f"  phase 6's base rebuilt from its seed in "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pop = population_path(torch, np, cfg, base)
    t1 = time.perf_counter()
    paths = aggregation_paths(torch, np, cfg, base)
    t2 = time.perf_counter()
    codecs_card_against_cpu(torch, np, paths)
    t3 = time.perf_counter()
    launches = dict(pop["launches"])
    for k, v in paths["launches"].items():
        launches[k] = launches.get(k, 0) + v
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  phase 13 parts: (a) {t1 - t0:.1f} s (a round's wall p50 "
        f"{np.median(pop['walls']):.3f} s over {len(pop['walls'])}: "
        f"{[round(w, 3) for w in pop['walls']]}), (b) {t2 - t1:.1f} s, (c) "
        f"{t3 - t2:.1f} s; peak memory {peak:.2f} GiB; {device_line()}")
    return launches


# ---------------------------------------------------------------------------
# phase 15: the mixture-of-experts family on full-width OLMoE-1B-7B
# ---------------------------------------------------------------------------

MOE_ARCH = "olmoe-1b-7b"
# Routing on the card against the CPU, and in decode against forward: the
# two sides' router probabilities differ by float32 rounding (~1e-7), so a
# token's top-k set may differ only where its k-th and (k+1)-th
# probabilities are closer than this (phase 4's near-tie rule); every such
# place is named in the log, any other difference fails.
MOE_NEAR_TIE = 1e-5
# (a) one moe_ffn at 8 x 64 tokens (one group of 512, capacity 80), layer
# 0's weights: y held per element to MOE_Y_REL of max|y| (float32 sums of
# d = 2048 products through the router, we1 and we3 and ff = 1024 through
# we2, in another order), aux to MOE_AUX_REL
MOE_FFN_SHAPE = (8, 64)
MOE_Y_REL = 1e-5
MOE_AUX_REL = 1e-5
# (b) HLoRA fine-tuning at full depth: 4 clients, 4 local steps each of
# 16 x 64 bigram tokens (one group of 1024, capacity 160), backbone frozen
MOE_TUNE = dict(ranks=(2, 4, 6, 8), steps=4, batch=16, seq=64)
MOE_PROFILED = 2
# (c) decode at full depth: 8 prompts of 32 tokens teacher-forced at
# capacity factor 8.0 (no slot dropped in forward's group of 256 or in a
# decode step's group of 8), every position's logits held to forward's
# within MOE_DECODE_REL of the logits' largest magnitude: decode and
# forward sum the same float32 products in other GEMM shapes (M 8 against
# M 256; attention over the cache against the whole sequence), ~1e-6
# relative a layer over 16 layers, far under the reference test's 2e-3
# (tests/test_models.py); then 16 greedy steps at the config's own 1.25
# (capacity 2 a step), twice for the same bits
MOE_DECODE = dict(rows=8, prompt=32, greedy=16, capacity_factor=8.0)
MOE_DECODE_REL = 1e-4
# (d) the LM example's train at full width, 4 layers, every parameter:
# 30 steps of 16 x 64 tokens at the example's lr (its warmup takes 20)
MOE_LM = dict(layers=4, steps=30, batch=16, seq=64, lr=3e-3, q_chunk=64)


class RouteLog:
    """Wraps ``moe.route`` while in use: every call's routing (top-k
    indices, keep mask and each token's gap between its k-th and (k+1)-th
    router probability, recomputed from the same inputs, copied to the
    host, and the device it ran on, when ``keep`` is set) and, on the
    device, the slots dropped and routed."""

    def __init__(self, torch, moe_lib, keep: bool):
        self.torch, self.moe, self.keep = torch, moe_lib, keep
        self.calls, self.devices, self.dropped, self.slots = [], [], 0, 0

    def __enter__(self):
        route = self.orig = self.moe.route

        def logged(xg, router, cfg):
            r = route(xg, router, cfg)
            self.dropped = self.dropped + (~r.keep).sum()
            self.slots += r.keep.numel()
            if self.keep:
                k = cfg.experts_per_token
                srt = self.torch.softmax(
                    xg.detach().float() @ router.detach().float(),
                    dim=-1).sort(dim=-1, descending=True).values
                self.calls.append((r.top_idx.cpu(), r.keep.cpu(),
                                   (srt[..., k - 1] - srt[..., k]).cpu()))
                self.devices.append(r.keep.device.type)
            return r

        self.moe.route = logged
        return self

    def __exit__(self, *exc):
        self.moe.route = self.orig

    def drop_share(self) -> float:
        return float(self.dropped) / max(self.slots, 1)


def routing_held(label, got, want) -> list:
    """Each call's top-k indices and keep mask in ``got`` against ``want``
    (the same calls in the same order): equal, except at tokens whose
    top-k gap on the ``want`` side is under MOE_NEAR_TIE, which are named;
    a group with such a token is not held on its keep mask, which follows
    from the indices. Returns the near-tie places (call, group, token)."""
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} routing calls against "
                             f"{len(want)}")
    ties = []
    for c, ((gi, gk, _), (wi, wk, wgap)) in enumerate(zip(got, want)):
        differ = (gi != wi).any(-1)                        # (G, g)
        near = differ & (wgap < MOE_NEAR_TIE)
        if bool((differ & ~near).any()):
            g, t = [int(v) for v in (differ & ~near).nonzero()[0]]
            raise AssertionError(
                f"{label}: call {c} routes token {t} of group {g} to "
                f"{gi[g, t].tolist()} against {wi[g, t].tolist()} at a top-k "
                f"gap of {float(wgap[g, t]):.3e} (>= {MOE_NEAR_TIE:.0e})")
        ties += [(c, int(g), int(t)) for g, t in near.nonzero().tolist()]
        held = ~near.any(-1)                               # groups held
        if not bool((gk[held] == wk[held]).all()):
            raise AssertionError(f"{label}: call {c}: keep masks differ "
                                 f"with equal indices")
    log(f"  {label}: top-k indices and keep masks equal over {len(want)} "
        f"calls; near-ties (gap < {MOE_NEAR_TIE:.0e}; call, group, token) "
        f"{ties or 'none'}; smallest gap "
        f"{min(float(w[2].min()) for w in want):.3e}")
    return ties


def moe_ffn_against_cpu(torch, cfg) -> None:
    """(a) one ``moe_ffn`` of 8 x 64 random tokens through one layer of
    full-width weights (seed 0 on the CPU, copied across): y, aux, the
    routing."""
    from repro_torch.models import moe as moe_lib

    gen = torch.Generator().manual_seed(0)
    p = {k: v[0] for k, v in moe_lib.init_moe_params(
        gen, cfg, 1, device="cpu").items()}
    x = torch.randn(*MOE_FFN_SHAPE, cfg.d_model, generator=gen)
    res = {}
    for side, dev in (("cpu", "cpu"), ("card", "cuda")):
        with RouteLog(torch, moe_lib, keep=True) as rl:
            t0 = time.perf_counter()
            y, aux = moe_lib.moe_ffn(x.to(dev), {k: v.to(dev) for k, v in
                                                 p.items()}, cfg)
            torch.cuda.synchronize()
            res[side] = (y.cpu(), float(aux), rl.calls, rl.drop_share(),
                         time.perf_counter() - t0)
    (yc, ac, rc, dc, tc), (yg, ag, rg, dg, tg) = res["cpu"], res["card"]
    g = moe_lib.group_size(cfg, x.shape[0] * x.shape[1])
    log(f"  (a) moe_ffn, {MOE_FFN_SHAPE[0]} x {MOE_FFN_SHAPE[1]} tokens (one "
        f"group of {g}, capacity {moe_lib.capacity(cfg, g)}), layer 0 of "
        f"full-width weights: card {tg * 1e3:.1f} ms, cpu {tc * 1e3:.0f} ms; "
        f"dropped slots card {dg:.4f}, cpu {dc:.4f}")
    routing_held("(a) moe_ffn routing, card against cpu", rg, rc)
    compare_scaled("(a) moe_ffn y, card against cpu", yg, yc, MOE_Y_REL,
                   "float32 sums of 2048 and 1024 products in another order")
    rel = abs(ag - ac) / abs(ac)
    log(f"  (a) aux card {ag:.7f} cpu {ac:.7f}: rel {rel:.2e} (<= "
        f"{MOE_AUX_REL:.0e}) {'ok' if rel <= MOE_AUX_REL else 'FAIL'}")
    if not (rel <= MOE_AUX_REL and ac > 0):
        raise AssertionError(f"(a) aux {ag} against {ac}")


def moe_lm_step_against_cpu(torch, example, cfg) -> None:
    """(a) phase 11's ``lm_step_against_cpu`` on OLMoE-1B-7B's full width
    at 2 layers (its limits, launches 16/8/8), with every ``route`` call of
    the two sides held against each other. Returns the card's
    launches."""
    from repro_torch.kernels import ops
    from repro_torch.models import moe as moe_lib

    with RouteLog(torch, moe_lib, keep=True) as rl:
        lm_step_against_cpu(torch, example, cfg)
    # the card's step was the last to run: its launches
    launches = {name: ops.LAUNCHES[name] for name in (
        "lora_matmul", "lora_matmul_dx", "lora_matmul_grad_ab")}
    side = {dev: [c for c, d in zip(rl.calls, rl.devices) if d == dev]
            for dev in ("cpu", "cuda")}
    routing_held("(a) LM step routing (the forward and remat's "
                 "recomputation, every layer), card against cpu",
                 side["cuda"], side["cpu"])
    return launches


def _moe_steps_hooked(torch, ops, client_mod, model_lib, steps: list):
    """Hooks around ``loss_and_grads`` and ``loss_fn``: each step's start
    (after a synchronize), loss, aux and launches go to ``steps``.
    Returns the undo."""
    grad_step, loss_fn = client_mod.loss_and_grads, model_lib.loss_fn
    aux = []

    def hooked_loss(*args, **kw):
        out = loss_fn(*args, **kw)
        aux.append(out[1]["aux"].detach())
        return out

    def hooked(*args, **kw):
        torch.cuda.synchronize()
        start = time.perf_counter()
        ops.reset_launches()
        loss, grads = grad_step(*args, **kw)
        steps.append(dict(start=start, loss=float(loss),
                          aux=float(aux[-1]), launches=dict(ops.LAUNCHES)))
        return loss, grads

    client_mod.loss_and_grads, model_lib.loss_fn = hooked, hooked_loss

    def undo():
        client_mod.loss_and_grads, model_lib.loss_fn = grad_step, loss_fn
    return undo


def moe_group(key: str) -> str:
    """Device time groups of a MoE step: ``train_group``'s, and of the
    rest the dispatch and combine (index, scatter, gather, cat) and the
    routing (sort, softmax, cumsum, one-hot)."""
    g = train_group(key)
    if g != "other":
        return g
    if any(k in key for k in ("index", "scatter", "gather", "Cat")):
        return "dispatch and combine"
    if any(k in key for k in ("sort", "Sort", "SoftMax", "softmax", "scan")):
        return "routing"
    return "other"


def moe_finetune(torch, np, cfg, params) -> dict:
    """(b) ``make_cohort_train`` at full depth: 4 clients (ranks 2/4/6/8 on
    q, k, v, o), 4 steps each, backbone frozen. Returns the lora kernels'
    launches."""
    from repro_torch.core.lora import make_rank_mask
    from repro_torch.data import make_bigram_lm
    from repro_torch.fed import (SimConfig, client as client_mod,
                                 make_cohort_train, make_local_train,
                                 split_adapters, split_head)
    from repro_torch.kernels import ops
    from repro_torch.models import model as model_lib
    from repro_torch.models import moe as moe_lib
    from repro_torch.optim import adamw, tree_map

    ranks, n_steps = MOE_TUNE["ranks"], MOE_TUNE["steps"]
    L, r_max = cfg.num_layers, cfg.lora.r_max
    lr = SimConfig().lr
    frozen, head = split_head(params)
    factors, _ = split_adapters(params.lora)
    trainable = tree_map(lambda t: torch.stack([t] * len(ranks)),
                         {"factors": factors, "head": head})
    masks = {t: torch.stack([make_rank_mask(r, r_max, device="cuda").expand(
        L, r_max) for r in ranks]) for t in cfg.lora.targets}
    rows = len(ranks) * n_steps * MOE_TUNE["batch"]
    lm = make_bigram_lm(rows, MOE_TUNE["seq"], LM_DATA_VOCAB, seed=3)
    data = {k: torch.from_numpy(v).reshape(
        len(ranks), n_steps, MOE_TUNE["batch"], MOE_TUNE["seq"]).to("cuda")
        for k, v in lm.items()}
    g = moe_lib.group_size(cfg, MOE_TUNE["batch"] * MOE_TUNE["seq"])
    # one unmeasured step (cuBLAS, the kernels' first calls)
    make_local_train(cfg, adamw(lr), device="cuda")(
        frozen, tree_map(lambda t: t[0], trainable),
        tree_map(lambda t: t[0], masks), {k: v[0, :1] for k, v in
                                          data.items()})
    steps = []
    undo = _moe_steps_hooked(torch, ops, client_mod, model_lib, steps)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        with RouteLog(torch, moe_lib, keep=False) as rl:
            trained, losses = make_cohort_train(cfg, adamw(lr),
                                                device="cuda")(
                frozen, trainable, masks, data)
            torch.cuda.synchronize()
    finally:
        undo()
    end = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() / 2**30
    per = 4 * L                        # q, k, v and o in every layer
    expect = {name: 0 for name in ops.LAUNCHES}
    expect.update(lora_matmul=per, lora_matmul_dx=per,
                  lora_matmul_grad_ab=per)
    bad = [i for i, st in enumerate(steps) if st["launches"] != expect]
    walls = [b["start"] - a["start"] for a, b in zip(steps, steps[1:])]
    walls.append(end - steps[-1]["start"])
    moved = []
    for c, r in enumerate(ranks):
        for t in cfg.lora.targets:
            a1, b1 = (trained["factors"][t][k][c] for k in ("A", "B"))
            a0, b0 = (trainable["factors"][t][k][c] for k in ("A", "B"))
            if not (torch.equal(a1[..., r:], a0[..., r:])
                    and torch.equal(b1[:, r:], b0[:, r:])):
                raise AssertionError(f"(b) client {c}: masked directions of "
                                     f"{t} moved")
            moved.append(bool((b1 - b0).any()))
    finite = all(math.isfinite(st["loss"]) for st in steps)
    aux_ok = all(st["aux"] > 0 for st in steps)
    tokens = len(steps) * MOE_TUNE["batch"] * MOE_TUNE["seq"]
    ok = (finite and aux_ok and all(moved) and not bad
          and len(steps) == len(ranks) * n_steps)
    log(f"  (b) HLoRA fine-tuning, {cfg.num_layers} layers "
        f"({cfg.param_count() / 1e9:.3f} B parameters, "
        f"{cfg.active_param_count() / 1e9:.3f} B active a token), frozen; "
        f"{len(ranks)} clients at ranks {ranks} on {cfg.lora.targets}, "
        f"{n_steps} steps each of {MOE_TUNE['batch']} x {MOE_TUNE['seq']} "
        f"tokens (one group of {g}, capacity {moe_lib.capacity(cfg, g)}), "
        f"AdamW lr {lr}: {len(steps)} steps in {end - t0:.3f} s, "
        f"{tokens / (end - t0):.1f} tok/s; step p50 "
        f"{np.median(walls) * 1e3:.3f} ms (min {min(walls) * 1e3:.3f}, max "
        f"{max(walls) * 1e3:.3f}); dropped slots {rl.drop_share():.4f}; "
        f"peak memory {peak:.2f} GiB")
    log(f"  (b) losses {[round(st['loss'], 4) for st in steps]}; aux "
        f"{[round(st['aux'], 4) for st in steps]}; per-client mean "
        f"{[round(float(x), 4) for x in losses]}; every loss finite "
        f"{finite}, aux > 0 {aux_ok}; every client's factors moved "
        f"{all(moved)}, masked directions bit-unchanged; launches a step "
        f"{steps[0]['launches']} (expect {per} of each lora kernel: q, k, v "
        f"and o in {L} layers; layer 0's four dx launches compute g alone) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"(b) fine-tuning: launches differ at steps "
                             f"{bad[:5]}, finite {finite}, aux {aux_ok}, "
                             f"moved {moved}")
    launches = {name: sum(st["launches"][name] for st in steps) for name in
                ("lora_matmul", "lora_matmul_dx", "lora_matmul_grad_ab")}

    # two more steps under the profiler, moe_ffn's forward in a range
    forward = moe_lib.moe_ffn

    def ranged(*args, **kw):
        with torch.profiler.record_function("moe"):
            return forward(*args, **kw)

    def two_steps():
        make_local_train(cfg, adamw(lr), device="cuda")(
            frozen, tree_map(lambda t: t[0], trainable),
            tree_map(lambda t: t[0], masks),
            {k: v[0, :MOE_PROFILED] for k, v in data.items()})

    moe_lib.moe_ffn = ranged
    try:
        events = profile_window(torch, f"{MOE_PROFILED} fine-tuning steps",
                                two_steps, group=moe_group,
                                annotation="moe")
    finally:
        moe_lib.moe_ffn = forward
    inside = {}
    for key, ms, _ in events:
        if key.startswith("moe: "):
            grp = moe_group(key[5:])
            inside[grp] = inside.get(grp, 0.0) + ms
    groups = group_ms(events, moe_group)
    log("  (b) device ms a step: " + ", ".join(
        f"{k} {v / MOE_PROFILED:.3f}" for k, v in sorted(groups.items()))
        + "; of it moe_ffn's forward: " + ", ".join(
        f"{k} {v / MOE_PROFILED:.3f}" for k, v in sorted(inside.items())))
    return launches


def moe_decode(torch, np, cfg, params) -> dict:
    """(c) decode at full depth through ``model.init_cache`` and
    ``decode_step``. Returns the lora_matmul launches of the greedy
    steps."""
    from repro_torch.data import make_bigram_lm
    from repro_torch.kernels import ops
    from repro_torch.models import model as model_lib
    from repro_torch.models import moe as moe_lib

    rows, plen = MOE_DECODE["rows"], MOE_DECODE["prompt"]
    prompts = torch.from_numpy(make_bigram_lm(
        rows, plen, LM_DATA_VOCAB, seed=4)["tokens"]).to("cuda")
    tf_cfg = cfg.with_(moe_capacity_factor=MOE_DECODE["capacity_factor"])
    t0 = time.perf_counter()
    with torch.no_grad(), RouteLog(torch, moe_lib, keep=True) as fl:
        logits, _ = model_lib.forward(params, {"tokens": prompts}, tf_cfg,
                                      remat=False)
    with RouteLog(torch, moe_lib, keep=True) as dl:
        cache = model_lib.init_cache(tf_cfg, rows, plen, torch.float32,
                                     device="cuda")
        got = []
        for t in range(plen):
            lg, cache = model_lib.decode_step(params, cache,
                                              prompts[:, t:t + 1], t, tf_cfg)
            got.append(lg)
    got = torch.stack(got, dim=1)
    torch.cuda.synchronize()
    # forward's group is the 8 x 32 tokens, row-major; decode step t's the
    # 8 rows at position t: the same (layer, row, position) routings
    L, k = cfg.num_layers, cfg.experts_per_token
    want_r = []
    got_r = []
    for t in range(plen):
        for layer in range(L):
            fi, fk, fg = fl.calls[layer]
            sel = torch.arange(rows) * plen + t
            di, dk, dg = dl.calls[t * L + layer]
            want_r.append((fi[:, sel], fk.view(1, -1, k)[:, sel].reshape(
                1, -1), fg[:, sel]))
            got_r.append((di, dk, dg))
    # keep masks: no slot is dropped on either side at this capacity
    drops = (fl.drop_share(), dl.drop_share())
    if drops != (0.0, 0.0):
        raise AssertionError(f"(c) slots dropped at capacity factor "
                             f"{tf_cfg.moe_capacity_factor}: {drops}")
    ties = routing_held("(c) decode routing against forward's, every "
                        "layer and position", got_r, want_r)
    # a near-tie taken the other way changes that row from that position
    # on (attention carries it): those positions are named, not held
    skip = torch.zeros(rows, plen, dtype=torch.bool)
    for c, _, row in ties:
        skip[row, c // L:] = True
    diff = (got - logits).abs().amax(-1).cpu()            # (rows, plen)
    scale = float(logits.abs().max())
    err = float(diff[~skip].max())
    ok = err <= MOE_DECODE_REL * scale and bool(got.isfinite().all())
    log(f"  (c) {rows} prompts of {plen} tokens teacher-forced through "
        f"decode at capacity factor {tf_cfg.moe_capacity_factor} (no slot "
        f"dropped): max |decode - forward| {err:.3e} over "
        f"{int((~skip).sum())} of {rows * plen} positions, the logits' "
        f"max {scale:.3f}: err/scale {err / scale:.2e} (<= "
        f"{MOE_DECODE_REL:.0e}); positions after a near-tie, not held: "
        f"{int(skip.sum())}; {time.perf_counter() - t0:.1f} s "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"(c) decode against forward: {err} > "
                             f"{MOE_DECODE_REL} x {scale}")
    del cache, logits, got

    def greedy():
        """The prompts through decode, then greedy steps at the config's
        capacity factor: every step's logits and the greedy steps'
        launches and times."""
        cache = model_lib.init_cache(cfg, rows, plen + MOE_DECODE["greedy"],
                                     torch.float32, device="cuda")
        out, launches, walls = [], [], []
        for t in range(plen):
            lg, cache = model_lib.decode_step(params, cache,
                                              prompts[:, t:t + 1], t, cfg)
            out.append(lg)
        tok = lg.argmax(-1, keepdim=True)
        for t in range(plen, plen + MOE_DECODE["greedy"]):
            torch.cuda.synchronize()
            start = time.perf_counter()
            ops.reset_launches()
            lg, cache = model_lib.decode_step(params, cache, tok, t, cfg)
            tok = lg.argmax(-1, keepdim=True)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - start)
            launches.append(dict(ops.LAUNCHES))
            out.append(lg)
        return torch.stack(out), launches, walls

    with RouteLog(torch, moe_lib, keep=False) as gl:
        first, launches, walls = greedy()
    second, _, _ = greedy()
    same = torch.equal(first, second)
    expect = {name: 0 for name in ops.LAUNCHES}
    expect["lora_matmul"] = 4 * cfg.num_layers
    bad = [i for i, got in enumerate(launches) if got != expect]
    finite = bool(first.isfinite().all())
    ok = same and finite and not bad
    cap = moe_lib.capacity(cfg, rows)
    log(f"  (c) {MOE_DECODE['greedy']} greedy steps after the prompts at "
        f"capacity factor {cfg.moe_capacity_factor} (capacity {cap} a "
        f"step): logits finite {finite}; a second run bit for bit {same}; "
        f"dropped slots {gl.drop_share():.4f}; decode step p50 "
        f"{np.median(walls) * 1e3:.3f} ms "
        f"({rows * len(walls) / sum(walls):.1f} tok/s); launches a step {launches[0]} (expect "
        f"{expect['lora_matmul']} lora_matmul: q, k, v and o in "
        f"{cfg.num_layers} layers; decode attention is plain) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"(c) greedy decode: same bits {same}, finite "
                             f"{finite}, launches differ at steps {bad[:5]}")
    return {"lora_matmul": sum(n["lora_matmul"] for n in launches)}


def moe_lm_loop(torch, np, example, cfg) -> dict:
    """(d) the example's ``train`` at full width and 4 layers, every
    parameter. Returns the lora kernels' launches."""
    from repro_torch.data import make_bigram_lm
    from repro_torch.fed import simulation
    from repro_torch.kernels import ops
    from repro_torch.models import model as model_lib

    cfg = cfg.with_(num_layers=MOE_LM["layers"])
    data = make_bigram_lm(4096, MOE_LM["seq"], LM_DATA_VOCAB, seed=0)
    grad_step, loss_fn = simulation.pretrain_loss_and_grads, model_lib.loss_fn
    steps, aux = [], []

    def hooked_loss(*args, **kw):
        out = loss_fn(*args, **kw)
        aux.append(out[1]["aux"].detach())
        return out

    def hooked(tree, batch, cfg_, **kw):
        torch.cuda.synchronize()
        start = time.perf_counter()
        ops.reset_launches()
        loss, grads = grad_step(tree, batch, cfg_, **kw)
        steps.append(dict(start=start, loss=float(loss), aux=float(aux[-1]),
                          launches=dict(ops.LAUNCHES)))
        return loss, grads

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    simulation.pretrain_loss_and_grads, model_lib.loss_fn = hooked, \
        hooked_loss
    t0 = time.perf_counter()
    try:
        _, losses = example.train(
            cfg, model_lib.init_params(cfg, seed=0, device="cuda"), data,
            steps=MOE_LM["steps"], batch=MOE_LM["batch"], lr=MOE_LM["lr"],
            remat=True, q_chunk=MOE_LM["q_chunk"], device="cuda")
        torch.cuda.synchronize()
    finally:
        simulation.pretrain_loss_and_grads, model_lib.loss_fn = grad_step, \
            loss_fn
    end = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() / 2**30
    expect = _lm_expect(ops, cfg.num_layers, remat=True)
    bad = [i for i, st in enumerate(steps) if st["launches"] != expect]
    walls = [b["start"] - a["start"] for a, b in zip(steps, steps[1:])]
    walls.append(end - steps[-1]["start"])
    finite = all(math.isfinite(v) for v in losses)
    aux_ok = all(st["aux"] > 0 for st in steps)
    last = float(np.mean(losses[-5:]))
    ok = (finite and aux_ok and not bad and last < losses[0]
          and len(steps) == MOE_LM["steps"])
    tokens = len(steps) * MOE_LM["batch"] * MOE_LM["seq"]
    log(f"  (d) the example's train, {cfg.num_layers} layers at full width "
        f"({cfg.param_count() / 1e9:.3f} B parameters, every one trained), "
        f"{len(steps)} steps of {MOE_LM['batch']} x {MOE_LM['seq']} tokens, "
        f"remat, q_chunk {MOE_LM['q_chunk']}, AdamW lr {MOE_LM['lr']} "
        f"({example.WARMUP_STEPS} warmup steps) in {end - t0:.3f} s: "
        f"{tokens / (end - t0):.1f} tok/s; step p50 "
        f"{np.median(walls) * 1e3:.3f} ms (min {min(walls) * 1e3:.3f}, max "
        f"{max(walls) * 1e3:.3f}); peak memory {peak:.2f} GiB")
    log(f"  (d) losses {[round(v, 4) for v in losses]}; aux "
        f"{[round(st['aux'], 4) for st in steps[::5]]} (every 5th); every "
        f"loss finite {finite}, aux > 0 every step {aux_ok}; first "
        f"{losses[0]:.4f}, mean of the last 5 {last:.4f}; launches a step "
        f"{steps[0]['launches']} (expect {expect['lora_matmul']} forward "
        f"with remat's second pass, {expect['lora_matmul_dx']} dx, "
        f"{expect['lora_matmul_grad_ab']} dA/dB) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"(d) LM loop: launches differ at steps "
                             f"{bad[:5]}, finite {finite}, aux {aux_ok}, "
                             f"last 5 {last} against {losses[0]}")
    return {name: sum(st["launches"][name] for st in steps) for name in
            ("lora_matmul", "lora_matmul_dx", "lora_matmul_grad_ab")}


def run_moe_phase(torch, np) -> dict:
    """Phase 15 on OLMoE-1B-7B: (a) card against CPU at 2 layers, (b)
    fine-tuning and (c) decode at full depth on one set of weights, (d)
    LM training at 4 layers; each part's time and the peak memory.
    Returns the lora kernels' launches of (a)-(d)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib

    cfg = get_config(MOE_ARCH)
    example = _lm_example()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    moe_ffn_against_cpu(torch, cfg)
    launches = moe_lm_step_against_cpu(torch, example, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    params = model_lib.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"  {cfg.name} at full width and depth: {cfg.num_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.num_experts} experts of "
        f"{cfg.moe_d_ff}, top-{cfg.experts_per_token}, vocab "
        f"{cfg.vocab_size}: {cfg.param_count() / 1e9:.3f} B parameters "
        f"float32 from seed 0 on the card in {time.perf_counter() - t1:.1f} "
        f"s")
    for name, n in moe_finetune(torch, np, cfg, params).items():
        launches[name] += n
    t2 = time.perf_counter()
    for name, n in moe_decode(torch, np, cfg, params).items():
        launches[name] += n
    t3 = time.perf_counter()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    for name, n in moe_lm_loop(torch, np, example, cfg).items():
        launches[name] += n
    t4 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  phase 15 parts: (a) {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s, (c) "
        f"{t3 - t2:.1f} s, (d) {t4 - t3:.1f} s; peak memory {peak:.2f} GiB; "
        f"{device_line()}")
    return launches


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
    log("[14] the rest of single-device serving: full-width gemma-2b (the "
        "dense ring cache, checkpoint-backed adapters, bf16, the serving "
        "example)")
    t0 = time.perf_counter()
    # a second counted path for the serving kernels: phase 14's waves
    for name, n in run_serving_rest(torch, np, ctx).items():
        launches[name] += n
    log(f"  phase 14 took {time.perf_counter() - t0:.1f} s")
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
    base = trained.pop("base")
    del trained                       # phase 7's cohort
    gc.collect()
    torch.cuda.empty_cache()
    log("[8] the synchronous round: run_experiment on phase 6's base")
    t0 = time.perf_counter()
    round_launches = run_rounds(torch, np, base)
    log(f"  phase 8 took {time.perf_counter() - t0:.1f} s")
    # the lora kernels and recon_agg run on two counted paths each: phase
    # 6's cohort call or phase 7's engine calls, and phase 8's rounds
    for name in ("lora_matmul", "lora_matmul_dx", "lora_matmul_grad_ab",
                 "recon_agg"):
        launches[name] += round_launches[name]
    del base                          # phase 6's backbone
    gc.collect()
    torch.cuda.empty_cache()
    log("[9] backbone pretraining: full-width roberta-large, SimConfig "
        "defaults")
    t0 = time.perf_counter()
    # and a third counted path for the lora kernels: pretraining's steps
    # and the rounds from the trained backbone
    for name, n in run_pretraining(torch, np).items():
        launches[name] += n
    log(f"  phase 9 took {time.perf_counter() - t0:.1f} s")
    log("[10] the training driver and checkpoint / resume: full-width "
        "roberta-large")
    t0 = time.perf_counter()
    # a fourth counted path for the lora kernels and a third for recon_agg:
    # the driver's rounds and the resumed run's
    for name, n in run_driver(torch, np).items():
        launches[name] += n
    for name, n in run_resume(torch, np).items():
        launches[name] += n
    log(f"  phase 10 took {time.perf_counter() - t0:.1f} s")
    from repro_torch.fed import simulation
    simulation._PRETRAIN_STORE.clear()       # phase 9's backbone
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log("[11] next-token LM training: full-width gemma-2b")
    t0 = time.perf_counter()
    # a fifth counted path for the lora kernels: the LM loop's steps and
    # the steps at length
    for name, n in run_lm_training(torch, np).items():
        launches[name] += n
    log(f"  phase 11 took {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    log("[12] the semi-synchronous and buffered asynchronous rounds: "
        "full-width roberta-large")
    t0 = time.perf_counter()
    # a sixth counted path for the lora kernels and a fourth for recon_agg:
    # SemiSync's rounds, BufferedAsync's events and its randomized flush,
    # and the mid-flight resume's events
    for name, n in run_async_rounds(torch, np).items():
        launches[name] += n
    log(f"  phase 12 took {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    log("[13] population-scale federation: full-width roberta-large")
    t0 = time.perf_counter()
    # a seventh counted path for the lora kernels and a fifth for recon_agg:
    # the example's population rounds, the trained cohort and its
    # randomized two-tier merge (Kc 4 at each edge, Kc 2 at the root)
    for name, n in run_population_phase(torch, np).items():
        launches[name] += n
    log(f"  phase 13 took {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    log("[15] the mixture-of-experts family: full-width olmoe-1b-7b")
    t0 = time.perf_counter()
    # an eighth counted path for the lora kernels: the MoE decoder's LM
    # step against the CPU, its fine-tuning cohort, its greedy decode and
    # the LM example's steps
    for name, n in run_moe_phase(torch, np).items():
        launches[name] += n
    log(f"  phase 15 took {time.perf_counter() - t0:.1f} s")

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
