"""Client-side local training: LoRA factors and the task head, base frozen
(port of ``repro/fed/client.py``).

The reference's jit-compiled scan over minibatches becomes a Python loop
of eager steps, each ``torch.autograd.grad`` of the loss over the
trainable leaves, and its ``vmap`` over a cohort a loop over clients with
stacked inputs and outputs. Every LoRA projection on the way runs
``core.lora.apply_lora``: the fused ``lora_matmul`` kernels on the card,
forward and backward.
"""
from __future__ import annotations

import copy
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as model_lib
from repro_torch.models.transformer import Transformer
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.recorder import NULL_RECORDER
from repro_torch.optim.optimizers import (Optimizer, apply_updates,
                                          tree_leaves, tree_map)

Factors = Dict[str, Dict[str, torch.Tensor]]   # {target: {"A", "B"}}
Masks = Dict[str, torch.Tensor]                 # {target: mask}
Trainable = Dict[str, Dict]                     # {"factors", "head"}


def split_adapters(lora_tree) -> Tuple[Factors, Masks]:
    factors = {t: {"A": ad["A"], "B": ad["B"]} for t, ad in lora_tree.items()}
    masks = {t: ad["mask"] for t, ad in lora_tree.items()}
    return factors, masks


def join_adapters(factors: Factors, masks: Masks):
    return {t: {"A": f["A"], "B": f["B"], "mask": masks[t]}
            for t, f in factors.items()}


def split_head(params: Transformer) -> Tuple[Transformer, Dict]:
    """Classification configs train the task head alongside LoRA (as in
    Hu et al.'s GLUE setup). Returns (frozen base without head and
    adapters, head or {}); the base's tensors are shared, not copied."""
    frozen = copy.copy(params)
    frozen.cls, frozen.lora = {}, {}
    return frozen, dict(params.cls)


def client_params(frozen: Transformer, trainable: Trainable,
                  masks: Masks) -> Transformer:
    """The frozen base with a client's head and masked adapters in place."""
    params = copy.copy(frozen)
    params.cls = dict(trainable["head"])
    params.lora = join_adapters(trainable["factors"], masks)
    return params


def _to(tree, dev: torch.device):
    return tree_map(lambda t: torch.as_tensor(t).to(dev), tree)


def loss_and_grads(frozen: Transformer, trainable: Trainable, masks: Masks,
                   batch: Dict[str, torch.Tensor], cfg: ModelConfig, *,
                   remat: bool = False, q_chunk: int = 1024
                   ) -> Tuple[torch.Tensor, Trainable]:
    """(loss, d loss / d trainable) for one minibatch, both detached."""
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), trainable)
    loss, _ = model_lib.loss_fn(client_params(frozen, leaves, masks), batch,
                                cfg, remat=remat, q_chunk=q_chunk)
    grads = iter(torch.autograd.grad(loss, tree_leaves(leaves)))
    return loss.detach(), tree_map(lambda _: next(grads), leaves)


def make_local_train(cfg: ModelConfig, opt: Optimizer, remat: bool = False,
                     q_chunk: int = 1024, device=None,
                     metrics: Optional[MetricsRegistry] = None,
                     recorder=None):
    """Returns local_train(frozen, trainable, masks, data) -> (trainable',
    mean_loss) with trainable = {"factors", "head"} and ``data`` leaves
    (steps, batch, ...), numpy or tensors; ``remat`` and ``q_chunk`` go to
    ``loss_fn`` (off and 1024, the reference's trainer defaults). Runs on
    ``device`` (None = CUDA, which must exist); ``frozen`` must already
    live there. With ``metrics``, every step's loss is read into
    ``train.loss``; with an enabled ``recorder`` as well, every step is
    timed to completion (a device synchronise) on the recorder's clock
    into ``train.step_s``. Without one the trainer reads no clock and adds
    no synchronise."""
    dev = resolve_device(device)
    rec = recorder if recorder is not None else NULL_RECORDER
    timed = metrics is not None and rec.enabled

    def local_train(frozen, trainable, masks, data):
        if frozen.embed.device != dev:
            raise ValueError(f"frozen base on {frozen.embed.device}, the "
                             f"trainer on {dev}")
        trainable, masks, data = _to(trainable, dev), _to(masks, dev), \
            _to(data, dev)
        state = opt.init(trainable)
        losses = []
        for step in range(data["tokens"].shape[0]):
            t0 = rec.now() if timed else 0.0
            batch = {k: v[step] for k, v in data.items()}
            loss, grads = loss_and_grads(frozen, trainable, masks, batch, cfg,
                                         remat=remat, q_chunk=q_chunk)
            with torch.no_grad():
                updates, state = opt.update(grads, state, trainable)
                trainable = apply_updates(trainable, updates)
            losses.append(loss)
            if timed:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                metrics.histogram("train.step_s").observe(rec.now() - t0)
            if metrics is not None:
                metrics.histogram("train.loss").observe(float(loss))
        return trainable, torch.stack(losses).mean()

    return local_train


def make_cohort_train(cfg: ModelConfig, opt: Optimizer, remat: bool = False,
                      q_chunk: int = 1024, device=None,
                      metrics: Optional[MetricsRegistry] = None,
                      recorder=None):
    """The local trainer over a client cohort: cohort_train(frozen,
    trainable, masks, data) -> (trainable', mean losses (C,)), where
    trainable, masks and data carry a leading cohort axis and the frozen
    base is shared. Clients run one after another (the reference vmaps).
    ``metrics`` and ``recorder`` as for :func:`make_local_train`."""
    local = make_local_train(cfg, opt, remat, q_chunk, device, metrics,
                             recorder)

    def cohort_train(frozen, trainable, masks, data):
        cohort = tree_leaves(masks)[0].shape[0]
        outs, losses = [], []
        for c in range(cohort):
            pick = (lambda t, c=c: t[c])
            tr, loss = local(frozen, tree_map(pick, trainable),
                             tree_map(pick, masks), tree_map(pick, data))
            outs.append(tr)
            losses.append(loss)
        stacked = tree_map(lambda *xs: torch.stack(xs), outs[0], *outs[1:])
        return stacked, torch.stack(losses)

    return cohort_train


@torch.no_grad()
def evaluate(params: Transformer, batch, cfg: ModelConfig, device=None
             ) -> Dict[str, torch.Tensor]:
    """{"loss", "acc"} of ``params`` (head and adapters in place) on one
    batch, on ``device`` (None = CUDA)."""
    dev = resolve_device(device)
    _, metrics = model_lib.loss_fn(params, _to(dict(batch), dev), cfg,
                                   remat=False)
    return metrics
