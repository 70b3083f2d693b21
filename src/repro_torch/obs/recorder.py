"""Low-overhead event recorder: the shared clock of the serve and fed stacks
(port of ``repro/obs/recorder.py``).

One ``Recorder`` instance is the single timeline for everything a process
does (serving steps, federated rounds, page churn, wire traffic), so a
Chrome-trace export lines every subsystem up against one monotonic clock.
This file is the port's only clock owner: the ``clock-discipline`` pass of
the reference's analysis tool, run over ``src/repro_torch``, allows raw
clock reads here and on lines that carry its pragma, nowhere else.

Design constraints, in order:

* **A disabled recorder is a true no-op.** ``NULL_RECORDER`` is a
  singleton whose methods do nothing and whose ``enabled`` is ``False``;
  hot paths guard their timestamp reads with ``if rec.enabled:``, so a
  recorder-free engine never calls the clock, never allocates an event
  and launches exactly the kernels it launches without one.
* **Zero device work.** The recorder stores host scalars only (floats,
  ints, strings). It never touches a tensor and never synchronizes the
  device; exporting is a pure host serialization.
* **Append-only ring buffer.** Events land in a ``deque(maxlen=capacity)``:
  O(1) append, the oldest events drop first under pressure (``dropped``
  counts them), no reallocation mid-run.

Clock semantics: ``now()`` is ``time.perf_counter()``, host-monotonic
seconds with an arbitrary origin, shared by every subsystem recording into
the same instance. Spans measure *host wall time between the two reads*.
CUDA work is asynchronous, so a span holds device time exactly where the
host blocks on a result inside it: the serve engine's step spans do (each
step copies its sampled tokens to the host before the span ends), the
federated session's spans do not block by themselves.

Event model (one tuple per event, Chrome-trace phase names)::

    ("X", name, track, t0, dur, args)   span      [t0, t0 + dur)
    ("i", name, track, t0, 0.0, args)   instant   at t0
    ("C", name, track, t0, 0.0, args)   counter sample (args = {series: value})

``track`` is a free-form string; the Chrome exporter maps each distinct
track to its own thread row (one per request, one per engine or server).
Within one track, spans are recorded by sequential host code, so they
never overlap.

Profiler alignment: ``Recorder(annotate=True)`` makes ``annotation(name)``
return ``torch.profiler.record_function(name)``, so the step functions show
up under the same names in a ``torch.profiler`` trace, with the kernels
they launch beneath them; otherwise (and always on ``NULL_RECORDER``) it
returns a shared reusable null context.
"""
from __future__ import annotations

import time
from collections import deque
from contextlib import contextmanager, nullcontext
from typing import Iterator, List, Tuple

Event = Tuple[str, str, str, float, float, dict]

#: shared reusable and reentrant null context, so a disabled annotation
#: costs one attribute load and an empty ``__enter__``/``__exit__``
_NULL_CTX = nullcontext()


class Recorder:
    """Append-only host-side event recorder over one monotonic clock."""

    __slots__ = ("enabled", "capacity", "appended", "_events", "_annotate")

    def __init__(self, capacity: int = 65536, annotate: bool = False):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.enabled = True
        self.capacity = int(capacity)
        self.appended = 0                 # total ever, dropped included
        self._events: deque = deque(maxlen=self.capacity)
        self._annotate = bool(annotate)

    # -- clock --------------------------------------------------------------

    @staticmethod
    def now() -> float:
        """Monotonic seconds (arbitrary origin, shared process-wide)."""
        return time.perf_counter()

    @staticmethod
    def wall() -> float:
        """Wall-clock seconds (``time.time()``), not for recording.

        Events always carry ``now()`` stamps; the wall clock exists only
        for the cross-process clock handshake (``repro_torch.obs.collect``),
        where it is the one reference two processes share."""
        return time.time()

    # -- recording ----------------------------------------------------------

    def instant(self, name: str, track: str, **args) -> None:
        self.appended += 1
        self._events.append(("i", name, track, time.perf_counter(), 0.0,
                             args))

    def complete(self, name: str, track: str, t0: float, t1: float,
                 **args) -> None:
        """A finished span from two ``now()`` reads (the hot-path form:
        callers read ``t0`` themselves inside an ``if rec.enabled:`` guard,
        so nothing is computed when recording is off)."""
        self.appended += 1
        self._events.append(("X", name, track, t0, max(t1 - t0, 0.0),
                             args))

    @contextmanager
    def span(self, name: str, track: str, **args) -> Iterator[None]:
        """Context-manager convenience for paths off the hot loop."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.complete(name, track, t0, time.perf_counter(), **args)

    def counter_sample(self, name: str, track: str, value) -> None:
        """One sample of a named time series (Chrome 'C' event)."""
        self.appended += 1
        self._events.append(("C", name, track, time.perf_counter(), 0.0,
                             {name: value}))

    def annotation(self, name: str):
        """``torch.profiler.record_function(name)`` when profiler alignment
        was requested; a shared null context otherwise. Imported lazily, so
        the record path needs no torch."""
        if self._annotate:
            from torch.profiler import record_function
            return record_function(name)
        return _NULL_CTX

    # -- introspection ------------------------------------------------------

    @property
    def dropped(self) -> int:
        """Events lost to ring-buffer pressure (oldest first)."""
        return self.appended - len(self._events)

    def events(self) -> List[Event]:
        """Snapshot of the retained events, oldest first."""
        return list(self._events)

    def clear(self) -> None:
        self._events.clear()
        self.appended = 0

    def __len__(self) -> int:
        return len(self._events)


class NullRecorder:
    """The disabled recorder: every method is a no-op, ``enabled`` is
    False, and there is exactly one instance (``NULL_RECORDER``), so
    'recording is off' is an identity check away."""

    __slots__ = ()
    enabled = False
    capacity = 0
    appended = 0
    dropped = 0

    @staticmethod
    def now() -> float:
        return 0.0

    def instant(self, name: str, track: str, **args) -> None:
        pass

    def complete(self, name: str, track: str, t0: float, t1: float,
                 **args) -> None:
        pass

    def span(self, name: str, track: str, **args):
        return _NULL_CTX

    def counter_sample(self, name: str, track: str, value) -> None:
        pass

    def annotation(self, name: str):
        return _NULL_CTX

    def events(self) -> List[Event]:
        return []

    def clear(self) -> None:
        pass

    def __len__(self) -> int:
        return 0


NULL_RECORDER = NullRecorder()
