"""Backbone pretraining at RoBERTa-large's full width, the port against
the JAX reference, step by step on the CPU.

``tests/test_torch_pretrain.py`` holds the port to the reference at
``roberta-reduced`` (d_model 128) for 4 steps. This script runs both
``pretrain_backbone``s at RoBERTa-large's widths (d_model 1024, 16 heads,
d_ff 4096, vocab 50265, LoRA on q and v at r_max 8) with the depth cut to
``--layers``, at ``SimConfig``'s defaults otherwise (64 x 32 tokens a
step, AdamW lr 1e-3), from the reference's seed-0 weights on both sides.
It prints each step's loss on both sides, their largest difference, and
each leaf's distance after the last step against the change the steps
made (normwise). ``--reduced`` runs ``roberta-reduced`` (d_model 128, 2
layers) instead, for as many steps. It is a script, not a test: at full
width a step takes seconds on the CPU.

    PYTHONPATH=src python tests/pretrain_witness.py --layers 4 --steps 20
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import jax
import numpy as np
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_reduced as j_get_reduced
from repro.fed import simulation as j_sim
from repro.models import model as j_model
from repro_torch import interop
from repro_torch.configs import get_config, get_reduced
from repro_torch.fed import simulation as t_sim


# the key bias's gradient is zero in exact arithmetic (the softmax
# cancels q.bk) and rounding noise on both sides, so Adam moves it by
# about lr either way on each: its distance is printed, not ranked
BK = "layers/attn/bk"


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return {p: v for k in sorted(tree)
                for p, v in _paths(tree[k], prefix + (k,)).items()}
    return {prefix: tree}


def _flat(tree):
    return {p: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)).astype(np.float64)
            for p, v in _paths(tree).items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    if args.reduced:
        jcfg, tcfg = (get("roberta-large")
                      for get in (j_get_reduced, get_reduced))
    else:
        jcfg, tcfg = (dataclasses.replace(get("roberta-large"),
                                          num_layers=args.layers)
                      for get in (j_get_config, get_config))
    sim = dict(pretrain_steps=args.steps)
    init = jax.tree.map(np.asarray,
                        j_model.init_params(jax.random.PRNGKey(0), jcfg))

    jlosses, loss_fn = [], j_model.loss_fn

    def logged(*a, **kw):
        loss, m = loss_fn(*a, **kw)
        jax.debug.callback(lambda v: jlosses.append(float(v)), loss)
        return loss, m

    t0 = time.perf_counter()
    j_sim.model_lib.loss_fn = logged
    want = j_sim.pretrain_backbone(jcfg, j_sim.SimConfig(**sim))
    jax.block_until_ready(want)
    j_sim.model_lib.loss_fn = loss_fn
    j_secs = time.perf_counter() - t0

    tlosses, step = [], t_sim.pretrain_loss_and_grads

    def logged_step(*a):
        loss, grads = step(*a)
        tlosses.append(float(loss))
        return loss, grads

    t_sim.model_lib.init_params = (
        lambda cfg, seed=0, dtype=torch.float32, device=None:
        interop.params_from_jax(init, cfg, device=device))
    t_sim.pretrain_loss_and_grads = logged_step
    t0 = time.perf_counter()
    got = t_sim.pretrain_backbone(tcfg, t_sim.SimConfig(**sim), device="cpu")
    t_secs = time.perf_counter() - t0

    diffs = [abs(a - b) for a, b in zip(tlosses, jlosses)]
    for i, (a, b) in enumerate(zip(jlosses, tlosses)):
        print(f"step {i:3d}: reference {a:.6f} port {b:.6f} |diff| "
              f"{abs(a - b):.2e}")
    before, want, got = _flat(init), _flat(want), _flat(got.tree())
    leaves = {}
    for path, w in want.items():
        change = np.linalg.norm(w - before[path])
        leaves["/".join(path)] = (float(np.linalg.norm(got[path] - w)
                                        / change) if change else None)
    for name, rel in leaves.items():
        print(f"leaf {name}: ||port - reference|| / ||reference change|| "
              f"{rel if rel is None else f'{rel:.2e}'}")
    print(json.dumps({
        "layers": tcfg.num_layers, "d_model": tcfg.d_model,
        "steps": args.steps, "reference_s": round(j_secs, 1),
        "port_s": round(t_secs, 1), "max_loss_diff": max(diffs),
        "reference_losses": [round(v, 6) for v in jlosses],
        "port_losses": [round(v, 6) for v in tlosses],
        "worst_leaf": max((v, k) for k, v in leaves.items()
                          if v is not None and k != BK)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
