"""Federated fine-tuning driver (the end-to-end entry point; port of
``repro/launch/train.py``).

It runs the paper's pipeline: backbone pretraining, Dirichlet non-IID
sharding, N federated rounds with the chosen aggregation strategy (or the
centralized upper bound), an eval every round, then the checkpoint.

Usage, on the card (the default device):
  PYTHONPATH=src python -m repro_torch.launch.train --arch roberta-large \\
      --task mrpc --strategy hlora --rank-policy random --rounds 20 \\
      --ckpt-dir ckpts/mrpc_hlora

``--full-config`` uses the published architecture size; the default is
the reduced variant. ``--device cpu`` runs on the CPU. ``main(argv)``
takes the arguments as a list, so a caller can run the driver in process;
it returns the history.

With ``--ckpt-dir`` the driver saves, through ``repro_torch.checkpoint``,
step ``--rounds`` with the tree ``{"history": {column: float64 array}}``
and ``meta={"args": vars(args)}``, and writes ``history.json``. The
``health`` column (one dict a round) goes in by key, as ``{"health":
{key: float64 array over rounds}}``. (The reference converts every column
with ``float`` and so raises on ``health``: it saves only for
``--strategy centralized``.)
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch import checkpoint
from repro_torch.configs import get_config, get_reduced
from repro_torch.device import resolve_device
from repro_torch.fed import (ServerConfig, SimConfig, run_centralized,
                             run_experiment)
from repro_torch.fed.simulation import pretrain_backbone
from repro_torch.util import atomic_write_json


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="roberta-large")
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--task", default="mrpc", choices=["mrpc", "qqp", "rte"])
    ap.add_argument("--strategy", default="hlora",
                    choices=["hlora", "naive", "centralized"])
    ap.add_argument("--svd-method", default="factored",
                    choices=["factored", "exact", "randomized"])
    ap.add_argument("--rank-policy", default="random",
                    choices=["uniform", "random", "capacity", "data"])
    ap.add_argument("--r-min", type=int, default=2)
    ap.add_argument("--r-max", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--clients", type=int, default=30)
    ap.add_argument("--cohort", type=int, default=10)
    ap.add_argument("--local-steps", type=int, default=8)
    ap.add_argument("--local-batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--dirichlet-alpha", type=float, default=0.3)
    ap.add_argument("--examples", type=int, default=4096)
    ap.add_argument("--pretrain-steps", type=int, default=300)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' "
                         "runs on the CPU)")
    return ap.parse_args(argv)


def history_tree(history: Dict[str, List]) -> Dict[str, dict]:
    """The checkpoint tree of a history: every numeric column as a float64
    array, a column of dicts (``health``) as one array per key."""
    out = {}
    for col, values in history.items():
        if values and all(isinstance(v, dict) for v in values):
            out[col] = {k: np.asarray([float(v[k]) for v in values],
                                      np.float64) for k in values[0]}
        else:
            out[col] = np.asarray(list(map(float, values)), np.float64)
    return {"history": out}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, List]:
    args = parse_args(argv)
    cfg = get_config(args.arch) if args.full_config else get_reduced(args.arch)
    if cfg.num_classes == 0:
        raise SystemExit(
            "train.py drives the paper's classification pipeline; "
            "use --arch roberta-large (or add labels to an LM task).")
    dev = resolve_device(args.device)
    sim = SimConfig(task=args.task, num_examples=args.examples,
                    rounds=args.rounds, local_steps=args.local_steps,
                    local_batch=args.local_batch, lr=args.lr,
                    dirichlet_alpha=args.dirichlet_alpha,
                    pretrain_steps=args.pretrain_steps, seed=args.seed)

    # standalone CLI progress on the wall clock: there is no Recorder in
    # scope here and nothing downstream consumes these as trace events
    t0 = time.time()          # repro: allow=clock-discipline (CLI progress)
    print(f"[train] arch={cfg.name} task={args.task} strategy={args.strategy}"
          f" rank_policy={args.rank_policy} r∈[{args.r_min},{args.r_max}]")
    base = pretrain_backbone(cfg, sim, dev)
    # repro: allow=clock-discipline (CLI progress)
    print(f"[train] backbone ready ({time.time() - t0:.1f}s)")

    if args.strategy == "centralized":
        history = run_centralized(cfg, sim, rank=args.r_max,
                                  base_params=base, device=dev)
    else:
        scfg = ServerConfig(
            num_clients=args.clients, clients_per_round=args.cohort,
            strategy=args.strategy, svd_method=args.svd_method,
            rank_policy=args.rank_policy, r_min=args.r_min,
            r_max=args.r_max, seed=args.seed)
        history = run_experiment(cfg, sim, scfg, base_params=base,
                                 device=dev)

    for rnd, (l, a) in enumerate(zip(history["train_loss"],
                                     history["eval_acc"])):
        print(f"  round {rnd:3d}: train_loss={l:.4f} eval_acc={a:.4f}")
    # repro: allow=clock-discipline (CLI progress)
    print(f"[train] done in {time.time() - t0:.1f}s; "
          f"final acc={history['eval_acc'][-1]:.4f} "
          f"best={max(history['eval_acc']):.4f}")

    if args.ckpt_dir:
        checkpoint.save(args.ckpt_dir, args.rounds, history_tree(history),
                        meta={"args": vars(args)})
        atomic_write_json(f"{args.ckpt_dir}/history.json", history,
                          indent=1)
        print(f"[train] history saved to {args.ckpt_dir}")
    return history


if __name__ == "__main__":
    main()
