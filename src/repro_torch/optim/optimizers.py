"""Optimizers over nested dicts of tensors (port of
``repro/optim/optimizers.py``; not ``torch.optim``, so the update
arithmetic is the reference's, step for step).

API as in the reference: ``opt = adamw(lr); state = opt.init(params);
updates, state = opt.update(grads, state, params); params =
apply_updates(params, updates)``. Schedules are callables step -> lr,
where ``step`` is a 0-d int32 tensor. Nothing is updated in place.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Union

import torch

Schedule = Union[float, Callable[[torch.Tensor], torch.Tensor]]
Tree = Union[torch.Tensor, Dict[str, "Tree"]]


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def tree_map(fn, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of nested dicts of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def _lr_at(lr: Schedule, step: torch.Tensor) -> torch.Tensor:
    if callable(lr):
        return lr(step)
    return torch.tensor(lr, dtype=torch.float32, device=step.device)


def apply_updates(params: Tree, updates: Tree) -> Tree:
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def clip_by_global_norm(grads: Tree, max_norm: float):
    """(grads scaled to a global L2 norm of at most ``max_norm``, the
    norm before scaling)."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                        for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), gn


def _step0(params: Tree) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def adamw(lr: Schedule, b1=0.9, b2=0.999, eps=1e-8,
          weight_decay=0.0) -> Optimizer:
    def init(params):
        def zeros(p):
            return torch.zeros_like(p, dtype=torch.float32)
        return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
                "step": _step0(params)}

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = _lr_at(lr, step)
        b1t = 1.0 - b1 ** step.to(torch.float32)
        b2t = 1.0 - b2 ** step.to(torch.float32)

        def upd(g, m, v, p):
            g = g.float()
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            mhat = m / b1t
            vhat = v / b2t
            u = -lr_t * (mhat / (torch.sqrt(vhat) + eps)
                         + weight_decay * p.float())
            return u, m, v

        triples = tree_map(upd, grads, state["mu"], state["nu"], params)

        def part(i):
            return tree_map(lambda _g, t: t[i], grads, triples)

        return part(0), {"mu": part(1), "nu": part(2), "step": step}

    return Optimizer(init, update)


def sgd(lr: Schedule, momentum: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return {"step": _step0(params)}
        return {"vel": tree_map(lambda p: torch.zeros_like(
            p, dtype=torch.float32), params), "step": _step0(params)}

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = _lr_at(lr, step)
        if momentum == 0.0:
            return tree_map(lambda g: -lr_t * g.float(), grads), \
                {"step": step}
        vel = tree_map(lambda v, g: momentum * v + g.float(), state["vel"],
                       grads)
        return tree_map(lambda v: -lr_t * v, vel), {"vel": vel, "step": step}

    return Optimizer(init, update)
