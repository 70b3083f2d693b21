"""Metrics registry: counters, gauges and percentile histograms (port of
``repro/obs/metrics.py``).

Where the recorder (``obs/recorder.py``) answers *when did things happen*,
this module answers *how much and how fast overall*: the always-on half
of the observability layer. A counter increment is one Python int add, so
the engines keep their metrics on with event recording off; everything
that needs a clock read (the latency histograms) is gated behind
``recorder.enabled`` by the instrumented call sites.

Naming: dotted lowercase paths (``serve.steps``, ``fed.uplink_bytes``,
``serve.pages.free``). ``as_dict()`` and ``summary_text()`` flatten the
whole registry for JSON export or human reading."""
from __future__ import annotations

import math
from collections import deque
from typing import Dict, List, Optional, Sequence


class Counter:
    """Monotonically-growing (but settable, for view semantics) int."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def set(self, v) -> None:
        self.value = v


def percentile(values: Sequence[float], p: float) -> float:
    """Nearest-rank percentile (p in [0, 100]) over a non-empty sequence."""
    if not values:
        raise ValueError("percentile of an empty sequence")
    xs = sorted(values)
    if p <= 0:
        return float(xs[0])
    rank = math.ceil(p / 100.0 * len(xs))
    return float(xs[min(rank, len(xs)) - 1])


class Histogram:
    """Lifetime count/total/min/max plus the most recent ``window``
    observations for percentiles."""

    __slots__ = ("name", "count", "total", "vmin", "vmax", "_window")

    def __init__(self, name: str, window: int = 65536):
        if window <= 0:
            raise ValueError(f"window must be positive, got {window}")
        self.name = name
        self._window: deque = deque(maxlen=int(window))
        self.reset()

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)
        self._window.append(v)

    def reset(self) -> None:
        """Drop all observations (e.g. to exclude a warmup phase)."""
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self._window.clear()

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, p: float) -> float:
        return percentile(self._window, p)

    def values(self) -> list:
        """The windowed observations, oldest first."""
        return list(self._window)

    def summary(self) -> Dict[str, float]:
        if not self.count:
            return {"count": 0}
        return {"count": self.count, "mean": self.mean,
                "min": self.vmin, "max": self.vmax,
                "p50": self.percentile(50), "p90": self.percentile(90),
                "p99": self.percentile(99)}


class MetricsRegistry:
    """Get-or-create namespace of counters / gauges / histograms."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        if name not in self._counters:
            self._counters[name] = Counter(name)
        return self._counters[name]

    def gauge(self, name: str) -> Gauge:
        if name not in self._gauges:
            self._gauges[name] = Gauge(name)
        return self._gauges[name]

    def histogram(self, name: str, window: int = 65536) -> Histogram:
        if name not in self._histograms:
            self._histograms[name] = Histogram(name, window)
        return self._histograms[name]

    def as_dict(self) -> Dict[str, object]:
        """Flat {name: value-or-summary} snapshot (JSON-serializable)."""
        out: Dict[str, object] = {n: c.value for n, c in
                                  self._counters.items()}
        out.update({n: g.value for n, g in self._gauges.items()})
        out.update({n: h.summary() for n, h in self._histograms.items()})
        return out

    def has(self, name: str) -> bool:
        return (name in self._counters or name in self._gauges
                or name in self._histograms)

    def gauges(self) -> Dict[str, Gauge]:
        """Read-only snapshot of the gauge namespace (the time-series store
        samples level-valued state, such as pool occupancy, from here)."""
        return dict(self._gauges)

    def summary_text(self, title: Optional[str] = None) -> str:
        """Aligned human-readable dump (the text exporter)."""
        lines: List[str] = []
        if title:
            lines.append(title)
            lines.append("-" * len(title))
        scalars = {**{n: c.value for n, c in sorted(self._counters.items())},
                   **{n: g.value for n, g in sorted(self._gauges.items())}}
        if scalars:
            w = max(len(n) for n in scalars)
            for n, v in sorted(scalars.items()):
                lines.append(f"{n:<{w}}  {v}")
        for n, h in sorted(self._histograms.items()):
            s = h.summary()
            if not s["count"]:
                lines.append(f"{n}  (empty)")
                continue
            lines.append(
                f"{n}  n={s['count']} mean={s['mean']:.6g} "
                f"p50={s['p50']:.6g} p90={s['p90']:.6g} "
                f"p99={s['p99']:.6g} max={s['max']:.6g}")
        return "\n".join(lines)
