"""Declarative SLO objectives with error-budget / burn-rate state (port of
``repro/obs/slo.py``).

An :class:`Objective` names a time series (see ``repro_torch.obs.timeseries``
for the event routing), a per-observation threshold, and an attainment
target: "``first_token.ttft_s`` must stay at or under 0.2 s for 99% of
requests" is ``Objective("ttft", series="first_token.ttft_s",
threshold=0.2, target=0.99)``.

The :class:`SLOMonitor` folds observations into per-objective good/bad
time buckets (two :class:`~repro_torch.obs.timeseries.TimeSeries` per
objective, so the window semantics, O(1) updates and bounded memory are
exactly the store's) and ``evaluate()`` reduces the window to one
:class:`SLOState` per objective:

* ``attainment``   good / (good + bad) over the retained window
                   (1.0 on an empty window — no traffic, no violation)
* ``error_budget`` 1 - target: the fraction of observations *allowed*
                   to be bad
* ``burn_rate``    error_rate / error_budget — 1.0 means failing at
                   exactly the budgeted rate, >1 the budget is burning
                   down faster than allowed, 1/(1-target) is the
                   all-violating ceiling
* ``in_violation`` attainment < target

Violations are emitted back onto the recorder as ``i`` instants on the
``obs.slo`` track, so an exported trace shows *when* the system fell
out of budget against the same clock as the spans that caused it. The
monitor is observe-only: nothing in serve/fed changes behaviour on a
violation.

The clock is only read when ``evaluate()`` is called without an
explicit ``now`` (via ``Recorder.now()`` — never raw ``time``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional

from repro_torch.obs.recorder import Event, NULL_RECORDER, Recorder
from repro_torch.obs.timeseries import TimeSeries, iter_observations

#: the track SLO violations and health anomalies are recorded on
SLO_TRACK = "obs.slo"


@dataclass(frozen=True)
class Objective:
    """One declarative SLO over a time series."""
    name: str
    series: str                 # series name from iter_observations routing
    threshold: float            # per-observation good/bad cut
    target: float = 0.99        # required attainment in [0, 1)
    lower_is_better: bool = True

    def __post_init__(self):
        if not 0.0 <= self.target < 1.0:
            raise ValueError(
                f"target must be in [0, 1), got {self.target} "
                f"(an objective with target 1.0 has no error budget)")

    def good(self, value: float) -> bool:
        if self.lower_is_better:
            return value <= self.threshold
        return value >= self.threshold


@dataclass
class SLOState:
    """One ``evaluate()`` reduction of an objective's window."""
    objective: Objective
    good: int
    bad: int
    attainment: float
    error_budget: float
    burn_rate: float
    in_violation: bool

    @property
    def total(self) -> int:
        return self.good + self.bad

    def as_dict(self) -> Dict[str, float]:
        return {"good": self.good, "bad": self.bad,
                "attainment": self.attainment,
                "error_budget": self.error_budget,
                "burn_rate": self.burn_rate,
                "in_violation": int(self.in_violation)}


class SLOMonitor:
    """Fold observations, keep budget state, emit violation instants."""

    def __init__(self, objectives: Iterable[Objective],
                 recorder=None, bucket_s: float = 1.0,
                 window_buckets: int = 300,
                 max_violations: int = 1024):
        self.objectives: List[Objective] = list(objectives)
        names = [o.name for o in self.objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate objective names in {names}")
        self.rec = recorder if recorder is not None else NULL_RECORDER
        self.max_violations = int(max_violations)
        self.violations: List[dict] = []
        # per objective: good/bad count series sharing the window shape
        self._good: Dict[str, TimeSeries] = {}
        self._bad: Dict[str, TimeSeries] = {}
        self._by_series: Dict[str, List[Objective]] = {}
        for o in self.objectives:
            self._good[o.name] = TimeSeries(
                f"{o.name}.good", bucket_s, window_buckets)
            self._bad[o.name] = TimeSeries(
                f"{o.name}.bad", bucket_s, window_buckets)
            self._by_series.setdefault(o.series, []).append(o)

    def observe(self, series: str, t: float, value: float) -> None:
        """Route one valued observation to every objective on ``series``."""
        for o in self._by_series.get(series, ()):
            if o.good(float(value)):
                self._good[o.name].observe(t)
            else:
                self._bad[o.name].observe(t)

    def fold(self, events: Iterable[Event],
             instant_values: Optional[Dict[str, str]] = None) -> int:
        """Fold an event stream through the shared series routing;
        count-only observations (bare instants) carry no value and are
        skipped. Returns observations routed to at least one objective."""
        n = 0
        for series, t, v in iter_observations(events, instant_values):
            if v is None or series not in self._by_series:
                continue
            self.observe(series, t, v)
            n += 1
        return n

    # -- evaluation ---------------------------------------------------------

    def evaluate(self, now: Optional[float] = None) -> Dict[str, SLOState]:
        """Reduce every objective's retained window to an SLOState;
        record an ``i`` instant on ``obs.slo`` per violated objective."""
        if now is None:
            now = Recorder.now()
        out: Dict[str, SLOState] = {}
        for o in self.objectives:
            good = self._good[o.name].window_count()
            bad = self._bad[o.name].window_count()
            total = good + bad
            budget = 1.0 - o.target
            if total == 0:
                # empty window: vacuously attained, nothing burning
                state = SLOState(o, 0, 0, attainment=1.0,
                                 error_budget=budget, burn_rate=0.0,
                                 in_violation=False)
            else:
                attainment = good / total
                burn = (bad / total) / budget
                state = SLOState(o, good, bad, attainment=attainment,
                                 error_budget=budget, burn_rate=burn,
                                 in_violation=attainment < o.target)
            out[o.name] = state
            if state.in_violation:
                row = {"t": now, "objective": o.name, "series": o.series,
                       "attainment": state.attainment,
                       "burn_rate": state.burn_rate,
                       "good": good, "bad": bad}
                if len(self.violations) < self.max_violations:
                    self.violations.append(row)
                if self.rec.enabled:
                    self.rec.instant(
                        f"slo_violation.{o.name}", SLO_TRACK,
                        series=o.series, attainment=state.attainment,
                        burn_rate=state.burn_rate, target=o.target)
        return out

    def as_dict(self, now: Optional[float] = None) -> Dict[str, dict]:
        return {name: s.as_dict()
                for name, s in self.evaluate(now).items()}
