"""Paper reproduction script over the PyTorch port's FedSession API
(``repro_torch``; ``examples/fed_finetune.py`` is the reference's).

Runs the training strategies (centralized, naive, HLoRA homogeneous and
heterogeneous, FLoRA stacking) on a chosen task and prints their accuracy
curves side by side with the measured wire bytes a round (serialized
Broadcast / ClientUpdate messages).

``--scheduler`` switches the orchestration on the same session API: sync
(cohort barrier), semisync (deadline straggler cutoff) or async (K-buffered
staleness-discounted merging).

Population-scale federation rides on the same session: ``--population N``
switches to a lazily materialized N-client population with a
rank-stratified sampler (``--sample-rate`` sets the cohort fraction),
``--edges E`` routes aggregation through E edge aggregators (two-tier, bit
for bit the flat round), and ``--codec`` compresses every wire message
(none / bf16 / int8 / topk[:k]).

  PYTHONPATH=src python examples/fed_finetune_torch.py --task rte --rounds 12
  PYTHONPATH=src python examples/fed_finetune_torch.py --device cpu \\
      --population 300 --sample-rate 0.015 --edges 2 --codec int8 \\
      --rounds 2 --task mrpc

It runs on the CUDA card unless ``--device cpu`` is given, on the reduced
RoBERTa-large as the reference's does; ``run_population(cfg, sim, args)``
takes any config (full width included). ``main(argv)`` takes the arguments
as a list and returns the histories by label.
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs import get_reduced
from repro_torch.device import resolve_device
from repro_torch.fed import (AsyncConfig, BufferedAsync, ClientPopulation,
                             FedSession, HierarchicalTopology, SemiSync,
                             ServerConfig, SimConfig, SyncRound,
                             make_cohort_train, pretrain_backbone,
                             run_centralized, run_experiment)
from repro_torch.optim import adamw


def make_scheduler(name: str, num_clients: int, cohort: int, edges: int = 0):
    speeds = np.linspace(0.5, 2.0, num_clients)
    if name == "sync":
        topo = HierarchicalTopology(num_edges=edges) if edges else None
        return SyncRound(topology=topo)
    if edges:
        raise SystemExit("--edges needs the sync scheduler")
    if name == "semisync":
        return SemiSync(speeds=speeds, deadline_quantile=0.75)
    if name == "async":
        return BufferedAsync(speeds=speeds, buffer_size=cohort,
                             acfg=AsyncConfig(base_weight=0.5))
    raise ValueError(name)


def run_population(cfg, sim, args, base_params=None
                   ) -> Tuple[Dict[str, List], FedSession]:
    """Sampled rounds over a lazily materialized synthetic population on
    ``args.device``: only the cohort is ever resident, whatever
    ``--population`` says. ``base_params`` (a ``Transformer`` on that
    device) skips ``pretrain_backbone``. Returns the history and the
    session (its ``population`` carries the residency counters)."""
    dev = resolve_device(args.device)
    pop = ClientPopulation.synthetic(args.population, task=args.task,
                                     seed=args.seed,
                                     vocab_size=cfg.vocab_size)
    cohort = max(1, int(round(args.population * args.sample_rate)))
    scfg = ServerConfig(num_clients=pop.size, clients_per_round=cohort,
                        strategy="hlora", rank_policy="random",
                        r_min=2, r_max=8, seed=args.seed, codec=args.codec)
    base = base_params if base_params is not None \
        else pretrain_backbone(cfg, sim, device=dev)
    sess = FedSession(cfg, scfg, base, population=pop,
                      sampler="rank_stratified", device=dev)
    sched = make_scheduler(args.scheduler, pop.size, cohort, args.edges)
    h = sched.run(sess, make_cohort_train(cfg, adamw(sim.lr), device=dev),
                  pop.data_fn(sim.local_steps, sim.local_batch, dev),
                  sim.rounds)
    print(f"\n=== {args.task.upper()} population run: {pop.size} clients, "
          f"cohort={cohort} ({args.scheduler}"
          + (f", {args.edges} edges" if args.edges else "")
          + f", codec={args.codec}) ===")
    print("train_loss | " + " ".join(f"{x:.3f}" for x in h["train_loss"]))
    print(f"materialized {pop.materialized_total} client shards total, "
          f"max resident {pop.max_resident} (population never loaded)")
    print(f"wire/round down={np.mean(h['downlink_bytes']) / 1e3:.0f}kB "
          f"up={np.mean(h['uplink_bytes']) / 1e3:.0f}kB")
    return h, sess


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", default="rte", choices=["mrpc", "qqp", "rte"])
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scheduler", default="sync",
                    choices=["sync", "semisync", "async"])
    ap.add_argument("--population", type=int, default=0, metavar="N",
                    help="sample rounds from a lazy N-client population "
                         "instead of the strategy comparison")
    ap.add_argument("--sample-rate", type=float, default=0.01,
                    help="cohort fraction of the population per round")
    ap.add_argument("--edges", type=int, default=0, metavar="E",
                    help="two-tier aggregation through E edge aggregators "
                         "(0 = flat; sync scheduler only)")
    ap.add_argument("--codec", default="none",
                    help="wire codec: none, bf16, int8, topk[:k]")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' "
                         "runs on the CPU)")
    return ap.parse_args(argv)


def sim_config(args: argparse.Namespace) -> SimConfig:
    """The example's simulation settings (the reference's): 8 local steps
    of 16 examples at lr 1e-3, a backbone pretrained for 300 steps."""
    return SimConfig(task=args.task, num_examples=4096, eval_examples=1024,
                     rounds=args.rounds, local_steps=8, local_batch=16,
                     pretrain_steps=300, dirichlet_alpha=0.3, lr=1e-3,
                     seed=args.seed)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Dict[str, List]]:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_reduced("roberta-large")
    sim = sim_config(args)
    if args.population:
        h, _sess = run_population(cfg, sim, args)
        return {"population": h}
    base = pretrain_backbone(cfg, sim, device=dev)

    runs = {}
    runs["centralized (upper bound)"] = run_centralized(
        cfg, sim, rank=8, base_params=base, device=dev)
    for strat, policy, label in [
            ("naive", "uniform", "naive FedAvg of A,B (Eq. 1)"),
            ("hlora", "uniform", "HLoRA homogeneous r=8"),
            ("hlora", "random", "HLoRA heterogeneous r∈[2,8]"),
            ("flora", "random", "FLoRA stacking r∈[2,8]")]:
        scfg = ServerConfig(num_clients=30, clients_per_round=10,
                            strategy=strat, rank_policy=policy,
                            r_min=2, r_max=8, seed=args.seed,
                            codec=args.codec)
        runs[label] = run_experiment(
            cfg, sim, scfg, base_params=base, device=dev,
            scheduler=make_scheduler(args.scheduler, scfg.num_clients,
                                     scfg.clients_per_round, args.edges))

    print(f"\n=== {args.task.upper()} eval accuracy "
          f"({args.scheduler} scheduler) ===")
    width = max(len(k) for k in runs)
    for name, h in runs.items():
        curve = " ".join(f"{a:.2f}" for a in h["eval_acc"])
        line = f"{name:{width}s} | {curve} | best={max(h['eval_acc']):.3f}"
        if "downlink_bytes" in h:
            line += (f" | wire/round down="
                     f"{np.mean(h['downlink_bytes']) / 1e3:.0f}kB up="
                     f"{np.mean(h['uplink_bytes']) / 1e3:.0f}kB")
        if "stragglers" in h:
            line += f" | stragglers={sum(h['stragglers'])}"
        print(line)
    return runs


if __name__ == "__main__":
    main()
