"""Federated fine-tuning simulation settings and per-round client data
(port of the data side of ``repro/fed/simulation.py``: ``SimConfig`` and
``_stack_client_data``; the rounds themselves come with server
aggregation)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence

import numpy as np
import torch

from repro_torch.data import client_batches


@dataclass
class SimConfig:
    task: str = "mrpc"
    num_examples: int = 4096
    eval_examples: int = 1024
    dirichlet_alpha: float = 0.5
    rounds: int = 20
    local_steps: int = 8           # ≈ paper's E=2 local epochs on a shard
    local_batch: int = 16
    lr: float = 3e-4               # paper's LR
    pretrain_steps: int = 150      # full-param backbone pretraining
    pretrain_lr: float = 1e-3
    seed: int = 0


def stack_client_data(tokens: np.ndarray, labels: np.ndarray,
                      shards: Sequence[np.ndarray], cohort: Sequence[int],
                      sim: SimConfig, rnd: int) -> Dict[str, torch.Tensor]:
    """Round ``rnd``'s minibatches for each client of ``cohort``: {"tokens"
    (C, steps, batch, S), "labels" (C, steps, batch)} int32 CPU tensors,
    drawn with the reference's per-client seeds."""
    per = [client_batches(tokens, labels, shards[cid], sim.local_steps,
                          sim.local_batch,
                          seed=sim.seed * 7919 + rnd * 131 + int(cid))
           for cid in cohort]
    return {"tokens": torch.from_numpy(np.stack([p["tokens"] for p in per])),
            "labels": torch.from_numpy(np.stack([p["labels"] for p in per]))}
