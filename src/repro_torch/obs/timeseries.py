"""Streaming time-bucketed series over recorder events and metrics (port
of ``repro/obs/timeseries.py``).

Where the recorder answers *when did each thing happen* and the metrics
registry answers *how much overall*, this module answers *how is it
trending*: fixed-width time buckets holding count/total/min/max, folded
from the event stream (or sampled from registry gauges) so a monitor or
report can plot tok/s, TTFT, decode-step latency, page-pool occupancy,
wire bytes and staleness against the shared clock.

Same discipline as the event ring, in order:

1. **O(1) per observation.** ``TimeSeries.observe`` is a dict upsert on
   ``floor(t / bucket_s)`` — no sorting, no scans, no allocation beyond
   the bucket itself. ``SeriesStore.fold`` is one pass over the events
   with O(1) work per event.
2. **Bounded memory.** Each series keeps at most ``max_buckets``
   buckets; when time advances past the window, the oldest buckets are
   evicted and their observations counted in ``dropped`` (the lifetime
   ``count``/``total`` keep covering them — exactly the histogram's
   window-vs-lifetime split). Observations behind the evicted horizon
   are dropped on arrival, never resurrected.
3. **No clock reads.** Every observation carries its own ``t`` (a
   ``Recorder.now()`` stamp from the event being folded); this module
   never touches the clock, so folding is replayable from an archived
   JSONL stream byte-for-byte.

Bucketing invariant (property-tested): for any bucket width, the sum of
bucket counts/totals over a fold with no evictions equals the number /
sum of the observations — rebucketing conserves mass.

Event routing (``iter_observations``): ``C`` counter samples observe
their value under the series name; ``X`` spans observe their duration
under ``span.<name>``; ``i`` instants observe count-only under
``inst.<name>``, plus a valued series ``<name>.<arg>`` for instants the
instrumentation stamps a measurement onto (``first_token`` carries
``ttft_s``, ``finish`` carries ``tokens``, ``update_arrival`` carries
``staleness``, ``preempt`` carries ``pages_freed``).
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Iterator, List, NamedTuple, Optional, Tuple

from repro_torch.obs.recorder import Event

#: instant name -> args key whose value becomes a ``<name>.<key>`` series
DEFAULT_INSTANT_VALUES = {
    "first_token": "ttft_s",
    "finish": "tokens",
    "update_arrival": "staleness",
    "preempt": "pages_freed",
}


class Bucket(NamedTuple):
    start: float       # bucket start time (seconds, recorder clock)
    count: int
    total: float
    vmin: float
    vmax: float

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0


class TimeSeries:
    """One named series of fixed-width time buckets."""

    __slots__ = ("name", "bucket_s", "max_buckets", "count", "total",
                 "dropped", "_buckets", "_max_idx")

    def __init__(self, name: str, bucket_s: float = 1.0,
                 max_buckets: int = 512):
        if bucket_s <= 0:
            raise ValueError(f"bucket_s must be positive, got {bucket_s}")
        if max_buckets <= 0:
            raise ValueError(
                f"max_buckets must be positive, got {max_buckets}")
        self.name = name
        self.bucket_s = float(bucket_s)
        self.max_buckets = int(max_buckets)
        self.count = 0          # lifetime observations (incl. evicted)
        self.total = 0.0        # lifetime value sum
        self.dropped = 0        # observations no longer in the window
        # idx -> [count, total, vmin, vmax]; idx = floor(t / bucket_s)
        self._buckets: Dict[int, list] = {}
        self._max_idx: Optional[int] = None

    def observe(self, t: float, value: Optional[float] = None) -> None:
        """Fold one observation at time ``t``; ``value=None`` counts
        without contributing a value (instant events)."""
        v = 0.0 if value is None else float(value)
        self.count += 1
        self.total += v
        idx = math.floor(float(t) / self.bucket_s)
        if self._max_idx is not None and \
                idx <= self._max_idx - self.max_buckets:
            self.dropped += 1          # behind the evicted horizon
            return
        b = self._buckets.get(idx)
        if b is None:
            self._buckets[idx] = [1, v, v, v]
        else:
            b[0] += 1
            b[1] += v
            if v < b[2]:
                b[2] = v
            if v > b[3]:
                b[3] = v
        if self._max_idx is None or idx > self._max_idx:
            self._max_idx = idx
            horizon = idx - self.max_buckets
            for old in [i for i in self._buckets if i <= horizon]:
                self.dropped += self._buckets.pop(old)[0]

    # -- queries ------------------------------------------------------------

    def buckets(self) -> List[Bucket]:
        """Retained buckets, oldest first."""
        return [Bucket(i * self.bucket_s, b[0], b[1], b[2], b[3])
                for i, b in sorted(self._buckets.items())]

    def window_count(self) -> int:
        return sum(b[0] for b in self._buckets.values())

    def window_total(self) -> float:
        return sum(b[1] for b in self._buckets.values())

    def means(self) -> List[float]:
        return [b.mean for b in self.buckets()]

    def rates(self) -> List[float]:
        """Observations per second per bucket (tok/s when the series
        counts tokens, requests/s when it counts finishes, ...)."""
        return [b.count / self.bucket_s for b in self.buckets()]

    def value_rates(self) -> List[float]:
        """Value units per second per bucket (bytes/s for a wire-byte
        series, tokens/s for a ``finish.tokens`` series)."""
        return [b.total / self.bucket_s for b in self.buckets()]

    def __len__(self) -> int:
        return len(self._buckets)


def iter_observations(
        events: Iterable[Event],
        instant_values: Optional[Dict[str, str]] = None,
) -> Iterator[Tuple[str, float, Optional[float]]]:
    """The event -> (series, t, value) routing both the store and the
    SLO monitor fold with (see module docstring for the rules)."""
    if instant_values is None:
        instant_values = DEFAULT_INSTANT_VALUES
    for kind, name, _track, t0, dur, args in events:
        if kind == "C":
            v = args.get(name)
            if isinstance(v, (int, float)):
                yield name, t0, float(v)
        elif kind == "X":
            yield f"span.{name}", t0, float(dur)
        elif kind == "i":
            yield f"inst.{name}", t0, None
            key = instant_values.get(name)
            if key is not None:
                v = args.get(key)
                if isinstance(v, (int, float)):
                    yield f"{name}.{key}", t0, float(v)


class SeriesStore:
    """Get-or-create namespace of :class:`TimeSeries` plus the fold."""

    def __init__(self, bucket_s: float = 1.0, max_buckets: int = 512):
        self.bucket_s = float(bucket_s)
        self.max_buckets = int(max_buckets)
        self._series: Dict[str, TimeSeries] = {}

    def series(self, name: str) -> TimeSeries:
        s = self._series.get(name)
        if s is None:
            s = self._series[name] = TimeSeries(
                name, self.bucket_s, self.max_buckets)
        return s

    def names(self) -> List[str]:
        return sorted(self._series)

    def has(self, name: str) -> bool:
        return name in self._series

    def fold(self, events: Iterable[Event],
             instant_values: Optional[Dict[str, str]] = None) -> int:
        """Route events into series (O(1) each); returns observations
        folded. Idempotence is the caller's concern — fold an event
        stream once, or fold disjoint suffixes."""
        n = 0
        for name, t, v in iter_observations(events, instant_values):
            self.series(name).observe(t, v)
            n += 1
        return n

    def sample_gauges(self, metrics, t: float,
                      prefix: str = "") -> int:
        """Snapshot registry gauges (page-pool occupancy and friends)
        into same-named series at time ``t`` — the bridge for state
        that is level-valued rather than event-valued. Returns the
        number of gauges sampled. ``t`` comes from the caller (a
        ``Recorder.now()`` read at an enabled site); this module stays
        clock-free."""
        n = 0
        for name, g in metrics.gauges().items():
            if prefix and not name.startswith(prefix):
                continue
            if isinstance(g.value, (int, float)):
                self.series(name).observe(float(t), float(g.value))
                n += 1
        return n

    def as_dict(self) -> Dict[str, dict]:
        """JSON-serializable summary per series."""
        out: Dict[str, dict] = {}
        for name in self.names():
            s = self._series[name]
            bs = s.buckets()
            out[name] = {
                "count": s.count, "total": s.total, "dropped": s.dropped,
                "buckets": len(bs), "bucket_s": s.bucket_s,
                "mean": (s.total / s.count) if s.count else 0.0,
                "last": bs[-1].mean if bs else 0.0,
            }
        return out
