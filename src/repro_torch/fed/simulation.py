"""End-to-end federated fine-tuning simulation (port of
``repro/fed/simulation.py``).

A frozen backbone, K clients with Dirichlet non-IID shards of a
classification task, LoRA local training (adapters and the task head),
one aggregation strategy per merge. ``run_experiment`` stands up the
data, the trainers and the eval function, then hands control to a
scheduler over one :class:`~repro_torch.fed.session.FedSession`:
``SyncRound`` by default, ``SemiSync`` through the same cohort trainer,
``BufferedAsync`` through the single-client trainer and one client's
batches an event. It returns the scheduler's history ({round, train_loss,
eval_acc, eval_loss, downlink_bytes, uplink_bytes, health}, plus
stragglers and round_time under SemiSync; {time, staleness, accepted,
flush_events, ...} under BufferedAsync).

The backbone is the caller's (``base_params``, a ``Transformer`` on
``device``) or, with ``base_params=None``, ``pretrain_backbone``'s: every
weight (W0, norms, embedding, head, and the LoRA factors and masks)
trained by AdamW on the synthetic qqp stand-in, as in the reference, then
frozen.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.seeds import derive_seed
from repro_torch.data import (client_batches, dirichlet_partition,
                              make_pair_classification)
from repro_torch.device import resolve_device
from repro_torch.fed.client import (evaluate, join_adapters,
                                    make_cohort_train, make_local_train,
                                    split_adapters, split_head)
from repro_torch.fed.schedulers import BufferedAsync, Scheduler, SyncRound
from repro_torch.fed.session import FedSession, ServerConfig
from repro_torch.models import model as model_lib
from repro_torch.models.transformer import Transformer
from repro_torch.optim import adamw, apply_updates
from repro_torch.optim.optimizers import tree_leaves, tree_map


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


# ---------------------------------------------------------------------------
# Backbone "pretraining": the paper starts from RoBERTa-large. As in the
# reference, a pretrained backbone is stood up by full-parameter training on
# the easy lexical-overlap task (the qqp stand-in, another seed than the
# federated shards), then frozen; LoRA then adapts it to the task.
# ---------------------------------------------------------------------------

_PRETRAIN_STORE: Dict = {}  # backbone cache: same cfg+seed ⇒ same backbone
PRETRAIN_BATCH = 64


def pretrain_batches(cfg: ModelConfig, sim: SimConfig):
    """The reference's pretraining minibatches, step by step: {"tokens"
    (64, S), "labels" (64,)} numpy arrays, 64 picks a step out of the qqp
    stand-in, drawn from its own seeded stream."""
    rng = np.random.default_rng(derive_seed(sim.seed, "pretrain-batches"))
    tokens, labels = make_pair_classification(
        "qqp", sim.num_examples, seed=sim.seed + 777,
        vocab_size=cfg.vocab_size)
    for _ in range(sim.pretrain_steps):
        picks = rng.integers(0, len(tokens), size=PRETRAIN_BATCH)
        yield {"tokens": tokens[picks], "labels": labels[picks]}


def pretrain_loss_and_grads(tree: Dict, batch: Dict[str, torch.Tensor],
                            cfg: ModelConfig, remat: bool = False,
                            q_chunk: int = 1024
                            ) -> Tuple[torch.Tensor, Dict]:
    """(loss, d loss / d every tensor) for one minibatch of a weight tree
    in ``Transformer.tree()``'s layout, the gradients in the same layout
    (the mask included), both detached; ``remat`` and ``q_chunk`` go to
    ``loss_fn`` (off, as in the reference's pretraining step; LM training
    turns it on). ``tree`` is not touched: the gradient is taken in a
    module built from its tensors whose own Parameters, adapters and head
    require grad."""
    live = Transformer.from_tree(cfg, tree_map(lambda t: t.detach(), tree))
    leaves = live.tree()
    for t in tree_leaves(leaves):
        t.requires_grad_(True)
    loss, _ = model_lib.loss_fn(live, batch, cfg, remat=remat,
                                q_chunk=q_chunk)
    grads = iter(torch.autograd.grad(loss, tree_leaves(leaves)))
    return loss.detach(), tree_map(lambda _: next(grads), leaves)


def pretrain_backbone(cfg: ModelConfig, sim: SimConfig, device=None
                      ) -> Transformer:
    """``sim.pretrain_steps`` full-parameter AdamW steps (lr
    ``sim.pretrain_lr``) from ``init_params(cfg, sim.seed)`` on ``device``
    (None = CUDA); 0 steps return the initial weights. Cached per
    (cfg.name, sim.seed, sim.pretrain_steps, sim.pretrain_lr, device): as
    in the reference, ``num_examples`` is not in the key, so a second call
    that differs only there gets the first call's backbone."""
    dev = resolve_device(device)
    key = (cfg.name, sim.seed, sim.pretrain_steps, sim.pretrain_lr, str(dev))
    if key in _PRETRAIN_STORE:
        return _PRETRAIN_STORE[key]
    params = model_lib.init_params(cfg, sim.seed, device=dev)
    if sim.pretrain_steps > 0:
        tree = tree_map(lambda t: t.detach(), params.tree())
        opt = adamw(sim.pretrain_lr)
        opt_state = opt.init(tree)
        for batch in pretrain_batches(cfg, sim):
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in batch.items()}
            _, grads = pretrain_loss_and_grads(tree, batch, cfg)
            upd, opt_state = opt.update(grads, opt_state, tree)
            tree = apply_updates(tree, upd)
        params = Transformer.from_tree(cfg, tree)
    _PRETRAIN_STORE[key] = params
    return params


def _eval_batch(cfg: ModelConfig, sim: SimConfig, dev: torch.device):
    ev_tokens, ev_labels = make_pair_classification(
        sim.task, sim.eval_examples, seed=sim.seed + 10_000,
        vocab_size=cfg.vocab_size)
    return {"tokens": torch.from_numpy(ev_tokens).to(dev),
            "labels": torch.from_numpy(ev_labels).to(dev)}


def make_experiment_setup(cfg: ModelConfig, sim: SimConfig,
                          scfg: ServerConfig, base_params=None, device=None):
    """Data, trainers and eval shared by the schedulers, on ``device``
    (None = CUDA). Returns ``(session_kwargs, cohort_train, local_train,
    data_fn, client_data_fn, eval_fn)``. ``base_params=None`` pretrains
    the backbone (``pretrain_backbone``, cached)."""
    dev = resolve_device(device)
    if base_params is None:
        base_params = pretrain_backbone(cfg, sim, dev)
    frozen, _ = split_head(base_params)

    tokens, labels = make_pair_classification(
        sim.task, sim.num_examples, seed=sim.seed, vocab_size=cfg.vocab_size)
    ev_batch = _eval_batch(cfg, sim, dev)

    shards = dirichlet_partition(labels, scfg.num_clients,
                                 sim.dirichlet_alpha, seed=sim.seed)
    opt = adamw(sim.lr)
    cohort_train = make_cohort_train(cfg, opt, device=dev)
    local_train = make_local_train(cfg, opt, device=dev)

    def eval_fn(lora_tree, head):
        params = copy.copy(frozen)
        params.cls, params.lora = dict(head), lora_tree
        return evaluate(params, ev_batch, cfg, device=dev)

    def data_fn(cohort, rnd):
        return stack_client_data(tokens, labels, shards, cohort, sim, rnd)

    rng = np.random.default_rng(
        derive_seed(sim.seed, "async-client-batches"))

    def client_data_fn(cid):          # async mode: one client's batches
        picks = rng.integers(0, len(shards[cid]),
                             size=(sim.local_steps, sim.local_batch))
        idx = shards[cid][picks]
        return {"tokens": torch.from_numpy(tokens[idx]),
                "labels": torch.from_numpy(labels[idx])}

    session_kwargs = dict(base_params=base_params,
                          client_sizes=[len(s) for s in shards])
    return (session_kwargs, cohort_train, local_train, data_fn,
            client_data_fn, eval_fn)


def run_experiment(
    cfg: ModelConfig,
    sim: SimConfig,
    scfg: ServerConfig,
    base_params=None,
    eval_every: int = 1,
    engine=None,
    strategy=None,
    scheduler: Optional[Scheduler] = None,
    track_comm: bool = True,
    device=None,
) -> Dict[str, List[float]]:
    """One federated experiment = one FedSession + one Scheduler on
    ``device`` (None = CUDA). ``strategy`` (an AggregationStrategy or
    name) defaults to ``scfg.strategy``; ``scheduler`` defaults to
    ``SyncRound()``; ``track_comm=False`` skips the wire round trip (the
    history's byte columns become 0). Under ``BufferedAsync`` one round
    counts as ``clients_per_round`` events: ``sim.rounds`` x that many
    events, evaluated every ``eval_every`` x that many."""
    (session_kwargs, cohort_train, local_train, data_fn, client_data_fn,
     eval_fn) = make_experiment_setup(cfg, sim, scfg, base_params, device)
    session = FedSession(cfg, scfg, engine=engine, strategy=strategy,
                         track_comm=track_comm, device=device,
                         **session_kwargs)
    sched = scheduler if scheduler is not None else SyncRound()
    if isinstance(sched, BufferedAsync):
        return sched.run(session, local_train, client_data_fn,
                         num_events=sim.rounds * scfg.clients_per_round,
                         eval_fn=eval_fn,
                         eval_every=eval_every * scfg.clients_per_round)
    return sched.run(session, cohort_train, data_fn, sim.rounds,
                     eval_fn=eval_fn, eval_every=eval_every)


def run_centralized(
    cfg: ModelConfig, sim: SimConfig, rank: int = 8,
    steps: Optional[int] = None, base_params=None, device=None,
) -> Dict[str, List[float]]:
    """Centralized LoRA fine-tuning, Table 1's upper-bound row, on
    ``device`` (None = CUDA), from the backbone's own LoRA factors with
    their mask reset to rank ``rank``; ``base_params=None`` pretrains the
    backbone (``pretrain_backbone``, cached)."""
    dev = resolve_device(device)
    if base_params is None:
        base_params = pretrain_backbone(cfg, sim, dev)
    frozen, head = split_head(base_params)
    r_max = cfg.lora.r_max
    lora0 = {t: dict(ad) for t, ad in base_params.lora.items()}
    for t in lora0:
        lora0[t]["mask"] = (torch.arange(r_max, device=dev) < rank).to(
            torch.float32).expand(lora0[t]["mask"].shape).clone()
    tokens, labels = make_pair_classification(
        sim.task, sim.num_examples, seed=sim.seed, vocab_size=cfg.vocab_size)
    ev_batch = _eval_batch(cfg, sim, dev)
    steps = steps if steps is not None else sim.rounds * sim.local_steps
    local = make_local_train(cfg, adamw(sim.lr), device=dev)
    factors, masks = split_adapters(lora0)
    trainable = {"factors": factors, "head": head}
    rng = np.random.default_rng(sim.seed)
    history = {"round": [], "train_loss": [], "eval_acc": [], "eval_loss": []}

    def eval_fn(trainable):
        params = copy.copy(frozen)
        params.cls = dict(trainable["head"])
        params.lora = join_adapters(trainable["factors"], masks)
        return evaluate(params, ev_batch, cfg, device=dev)

    chunk = sim.local_steps
    for rnd in range(max(1, steps // chunk)):
        picks = rng.integers(0, len(tokens), size=(chunk, sim.local_batch))
        data = {"tokens": torch.from_numpy(tokens[picks]),
                "labels": torch.from_numpy(labels[picks])}
        trainable, loss = local(frozen, trainable, masks, data)
        m = eval_fn(trainable)
        history["round"].append(rnd)
        history["train_loss"].append(float(loss))
        history["eval_acc"].append(float(m["acc"]))
        history["eval_loss"].append(float(m["loss"]))
    return history


def rounds_to_target(history: Dict[str, List[float]], target: float):
    for rnd, acc in zip(history["round"], history["eval_acc"]):
        if acc >= target:
            return rnd
    return None
