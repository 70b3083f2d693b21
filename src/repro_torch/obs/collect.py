"""Cross-process telemetry: collect child recorders onto one timeline
(port of ``repro/obs/collect.py``).

A child process's recorder dies with the process; this module is the
collection protocol that brings its events onto the parent's timeline:

* **Child side** — ``dump_stream(recorder, path, process=...)`` writes
  the recorder's events as JSONL with a leading *clock handshake* meta
  row. The handshake pairs one ``Recorder.now()`` read (the
  ``perf_counter`` clock every event is stamped with — monotonic but
  with a per-process arbitrary origin) with one ``Recorder.wall()``
  read (the wall clock — the one clock all processes on a host share).
* **Parent side** — ``merge_streams(parent_events, children,
  parent_handshake)`` rebases each child's ``perf_counter`` origin onto
  the parent's: a child event at child-perf ``t`` happened at wall time
  ``child.wall + (t - child.perf)``, which is parent-perf
  ``t + (child.wall - child.perf) - (parent.wall - parent.perf)`` — a
  constant shift per child, so child-internal ordering and span
  durations are preserved exactly. Child tracks get a
  ``<process>/`` prefix, so per-track span monotonicity survives the
  merge trivially (tracks from different processes never interleave)
  and the merged list feeds straight into ``write_chrome_trace`` /
  ``validate_chrome_trace`` — one perfetto timeline spanning parent and
  children.

Accuracy: the two handshake reads are a few microseconds apart and
the wall clock vs ``perf_counter`` drift over minutes, so cross-process
alignment is good to well under a millisecond on one host — plenty for
eyeballing a multi-process run, not for ordering individual allocator
calls.
Child-internal timing is exact (constant shift).

Handshake format (the ``meta.handshake`` row in the JSONL dump)::

    {"process": "child", "perf": <Recorder.now()>,
     "wall": <Recorder.wall()>, "dropped": <recorder.dropped>}

This module reads clocks only through ``Recorder.now()`` /
``Recorder.wall()``.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

from repro_torch.obs.export import read_jsonl_with_meta, write_jsonl
from repro_torch.obs.recorder import Event, Recorder

#: key of the handshake inside the JSONL meta row
HANDSHAKE_KEY = "handshake"


def clock_handshake(process: str = "parent") -> dict:
    """Pair the event clock with the cross-process wall clock, now."""
    return {"process": str(process), "perf": Recorder.now(),
            "wall": Recorder.wall()}


def dump_stream(recorder, path: str, process: str = "child") -> dict:
    """Child side: atomically write ``recorder``'s events + handshake
    to ``path`` (JSONL); returns the handshake written."""
    hs = clock_handshake(process)
    hs["dropped"] = int(recorder.dropped)
    write_jsonl(recorder.events(), path, meta={HANDSHAKE_KEY: hs})
    return hs


def read_stream(path: str) -> Tuple[List[Event], Optional[dict]]:
    """Parent side: ``(events, handshake)`` from a child dump; the
    handshake is ``None`` for a plain (non-collect) JSONL archive."""
    events, meta = read_jsonl_with_meta(path)
    hs = (meta or {}).get(HANDSHAKE_KEY)
    return events, hs


def rebase_events(events: Iterable[Event], child_handshake: dict,
                  parent_handshake: dict,
                  track_prefix: str = "") -> List[Event]:
    """Shift a child's events onto the parent's ``perf_counter``
    timeline (see module docstring for the algebra); optionally prefix
    every track name."""
    offset = ((child_handshake["wall"] - child_handshake["perf"])
              - (parent_handshake["wall"] - parent_handshake["perf"]))
    out: List[Event] = []
    for kind, name, track, t0, dur, args in events:
        out.append((kind, name, track_prefix + track,
                    t0 + offset, dur, args))
    return out


def merge_streams(parent_events: Sequence[Event],
                  children: Iterable[Tuple[Sequence[Event], dict]],
                  parent_handshake: Optional[dict] = None) -> List[Event]:
    """One merged event list: parent events verbatim, each child's
    events clock-rebased and track-prefixed with its handshake's
    process name. Sorted by start time; per-track span monotonicity is
    preserved (parent tracks untouched, child tracks constant-shifted
    and disjoint by prefix), so the result is accepted by
    ``write_chrome_trace`` / ``validate_chrome_trace``.

    ``parent_handshake`` must be a ``clock_handshake()`` taken in the
    process that recorded ``parent_events`` (defaults to taking one
    now, which is correct exactly when the caller *is* that process).
    """
    if parent_handshake is None:
        parent_handshake = clock_handshake("parent")
    merged: List[Event] = list(parent_events)
    for events, hs in children:
        if hs is None:
            raise ValueError(
                "child stream has no clock handshake — was it written "
                "by dump_stream()? A plain JSONL archive cannot be "
                "rebased onto another process's timeline")
        prefix = f"{hs.get('process', 'child')}/"
        merged.extend(rebase_events(events, hs, parent_handshake, prefix))
    merged.sort(key=lambda e: e[3])
    return merged
