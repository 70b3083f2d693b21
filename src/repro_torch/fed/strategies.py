"""Aggregation strategies for the :class:`~repro_torch.fed.session.FedSession`
(port of ``repro/fed/strategies.py``).

A strategy is a small declarative object: the configuration of the
batched engine (``core/agg_engine.py``) that aggregates the cohort, and
the redistribution policy the session's broadcast applies.

``NaiveAvg``       Eq. 1: FedAvg of the A and B factors separately, the
                   zero-padding baseline under heterogeneous rank masks.
                   Plain truncated broadcast; no SVD, so no spectrum.
``HLoRA``          Eq. 2-3: reconstruct ΔW_k, exact FedAvg, SVD
                   re-decomposition; the broadcast applies the r_k/r_max
                   scale correction, so each client's effective update is
                   exactly the rank-r_k truncation of ΔW'.
``FLoRAStacking``  Wang et al.'s stacking: the factors stacked into P
                   (d_in, Σr_k) and Q (Σr_k, d_out), which is what the
                   engine's ``method='factored'`` path builds before its
                   SVD, truncated back to r_max; plain broadcast with the
                   'sqrt' split.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class AggregationStrategy:
    """Base class: subclasses override the class-level policy fields."""

    #: short name, also accepted as ``ServerConfig.strategy``
    name: str = "base"
    #: the engine's ``strategy`` ("naive" | "hlora")
    engine_strategy: str = "hlora"
    #: SVD back-end of reconstruction-based aggregation
    method: str = "factored"
    #: how σ is split between the redistributed factors
    split: str = "paper"
    #: apply the r_eff/r_max correction to broadcast B factors
    scale_correction: bool = False
    #: the engine returns a meaningful singular spectrum (drives spectrum
    #: and per-target rank adaptation without the factor-norm fallback)
    has_spectrum: bool = False

    def engine_kwargs(self) -> dict:
        return {"strategy": self.engine_strategy, "method": self.method,
                "split": self.split}


@dataclass(frozen=True)
class NaiveAvg(AggregationStrategy):
    name: str = "naive"
    engine_strategy: str = "naive"
    scale_correction: bool = False
    has_spectrum: bool = False


@dataclass(frozen=True)
class HLoRA(AggregationStrategy):
    name: str = "hlora"
    engine_strategy: str = "hlora"
    method: str = "factored"
    split: str = "paper"
    scale_correction: bool = True
    has_spectrum: bool = True


@dataclass(frozen=True)
class FLoRAStacking(AggregationStrategy):
    name: str = "flora"
    engine_strategy: str = "hlora"   # the factored path is the stacking
    method: str = "factored"
    split: str = "sqrt"
    scale_correction: bool = False
    has_spectrum: bool = True


#: user-registered strategies, resolved by ``from_name`` after the built-ins
_REGISTRY: dict = {}


def register_strategy(strategy: AggregationStrategy) -> AggregationStrategy:
    """Make a custom strategy resolvable by name (``ServerConfig.strategy
    = strategy.name``). Built-in names are reserved. Returns the
    strategy."""
    if strategy.name in ("naive", "hlora", "flora"):
        raise ValueError(f"{strategy.name!r} is a built-in strategy name")
    _REGISTRY[strategy.name] = strategy
    return strategy


def from_name(name: str, scfg=None) -> AggregationStrategy:
    """A ``ServerConfig.strategy`` string as a strategy object; ``'hlora'``
    takes the config's ``svd_method`` and ``split``."""
    if name == "naive":
        return NaiveAvg()
    if name == "hlora":
        if scfg is not None:
            return HLoRA(method=scfg.svd_method, split=scfg.split)
        return HLoRA()
    if name == "flora":
        return FLoRAStacking()
    if name in _REGISTRY:
        return _REGISTRY[name]
    raise ValueError(f"unknown aggregation strategy {name!r}; "
                     f"known: naive, hlora, flora"
                     + (f", {', '.join(sorted(_REGISTRY))}"
                        if _REGISTRY else ""))
