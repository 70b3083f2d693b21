"""Exporters for recorder event logs: JSONL, Chrome trace-event JSON,
and validation (port of ``repro/obs/export.py``; the two packages write
the same bytes for the same events and read each other's files).

Three formats, one source of truth (``Recorder.events()``):

* ``write_jsonl`` / ``read_jsonl`` — one JSON object per event per line,
  lossless round-trip of the internal event tuples. The archival format:
  greppable, streamable, diffable. An optional leading ``{"meta": ...}``
  row carries out-of-band state (the cross-process clock handshake from
  ``repro_torch.obs.collect``, ring-truncation counts); ``read_jsonl`` skips
  it, ``read_jsonl_with_meta`` returns it.
* ``chrome_trace`` — the Chrome trace-event JSON object format
  (perfetto-loadable: open ``ui.perfetto.dev`` or ``chrome://tracing``
  and drop the file in). Spans become complete ``"X"`` events, instants
  ``"i"``, counter samples ``"C"``; each distinct recorder track gets
  its own thread row, named via ``"M"`` metadata events, in
  first-appearance order. Timestamps convert from the recorder's
  monotonic seconds to integer-friendly microseconds with the earliest
  event at ts 0 (Chrome's expected origin). When the source ring
  dropped events (``recorder.dropped > 0``) a ``recorder_dropped``
  metadata row records how many, so a truncated timeline is visibly
  truncated instead of passing for a complete one.
* ``validate_chrome_trace`` — the schema contract the golden test pins:
  required keys per phase, numeric non-negative ts/dur, and per-track
  spans monotone and non-overlapping (each next span starts at or after
  the previous span's end — recorder tracks are written by sequential
  host code, so overlap means a recording bug, not concurrency). The
  returned counts include ``"dropped"`` from the truncation metadata
  row (0 when absent), so callers can refuse partial timelines.

All file writes go through ``repro_torch.util.atomic_write_text`` (tmp +
``os.replace``): a crashed or interrupted export never leaves a
half-written trace behind.
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.obs.recorder import Event
from repro_torch.util import atomic_write_text as _atomic_write_text

_US = 1e6
_PID = 1
#: validation tolerance for float->µs rounding at track boundaries
_OVERLAP_EPS_US = 0.5
#: name of the "M" metadata row that surfaces ring truncation
DROPPED_META_NAME = "recorder_dropped"


# ---------------------------------------------------------------------------
# JSONL
# ---------------------------------------------------------------------------

def write_jsonl(events: Iterable[Event], path: str,
                meta: Optional[dict] = None) -> int:
    """One event per line (atomic); returns the number of *event* lines.

    ``meta`` (optional) lands as a leading ``{"meta": {...}}`` row —
    the slot for the collect-module clock handshake and for
    ``recorder.dropped`` counts; it does not count toward the return
    value and ``read_jsonl`` skips it."""
    lines = []
    if meta is not None:
        lines.append(json.dumps({"meta": meta}))
    n = 0
    for kind, name, track, t0, dur, args in events:
        lines.append(json.dumps({"kind": kind, "name": name, "track": track,
                                 "t0": t0, "dur": dur, "args": args}))
        n += 1
    _atomic_write_text(path, "".join(line + "\n" for line in lines))
    return n


def read_jsonl_with_meta(path: str) -> Tuple[List[Event], Optional[dict]]:
    """Events plus the leading meta row (``None`` when absent)."""
    out: List[Event] = []
    meta: Optional[dict] = None
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            d = json.loads(line)
            if "kind" not in d:
                if "meta" in d and meta is None:
                    meta = d["meta"]
                continue
            out.append((d["kind"], d["name"], d["track"],
                        float(d["t0"]), float(d["dur"]), d["args"]))
    return out, meta


def read_jsonl(path: str) -> List[Event]:
    return read_jsonl_with_meta(path)[0]


# ---------------------------------------------------------------------------
# Chrome trace-event JSON
# ---------------------------------------------------------------------------

def chrome_trace(events: Sequence[Event], process_name: str = "repro",
                 dropped: int = 0) -> Dict:
    """Events -> Chrome trace-event *object format* document.

    ``dropped`` (pass ``recorder.dropped``) > 0 embeds a
    ``recorder_dropped`` metadata row: the exported timeline is missing
    its oldest ``dropped`` events to ring pressure, and both perfetto
    viewers and ``validate_chrome_trace`` surface that."""
    tids: Dict[str, int] = {}
    out: List[Dict] = [{
        "ph": "M", "name": "process_name", "pid": _PID, "tid": 0,
        "args": {"name": process_name}}]
    if dropped:
        out.append({"ph": "M", "name": DROPPED_META_NAME, "pid": _PID,
                    "tid": 0, "args": {"dropped": int(dropped)}})
    t_origin = min((e[3] for e in events), default=0.0)
    for kind, name, track, t0, dur, args in events:
        tid = tids.get(track)
        if tid is None:
            tid = tids[track] = len(tids) + 1
            out.append({"ph": "M", "name": "thread_name", "pid": _PID,
                        "tid": tid, "args": {"name": track}})
        ev = {"name": name, "ph": kind, "pid": _PID, "tid": tid,
              "ts": (t0 - t_origin) * _US, "args": dict(args)}
        if kind == "X":
            ev["dur"] = dur * _US
        elif kind == "i":
            ev["s"] = "t"                       # thread-scoped instant
        out.append(ev)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_chrome_trace(events: Sequence[Event], path: str,
                       process_name: str = "repro",
                       dropped: int = 0) -> Dict:
    doc = chrome_trace(events, process_name, dropped=dropped)
    _atomic_write_text(path, json.dumps(doc))
    return doc


def validate_chrome_trace(doc: Dict) -> Dict[str, int]:
    """Raise ``AssertionError`` on any schema violation; return counts.

    Checks: top-level shape, per-phase required keys, numeric
    non-negative timestamps/durations, and — per (pid, tid) track —
    ``"X"`` spans sorted by start time are non-overlapping (sequential
    host recording guarantees it; overlap would render as garbage rows
    in perfetto and means two spans were interleaved on one track).

    The returned counts carry a ``"dropped"`` entry read from the
    ``recorder_dropped`` metadata row (0 when the ring never
    overflowed): a validated document with ``dropped > 0`` is
    *well-formed but incomplete*, and callers that need the full
    timeline must treat it as truncated rather than blessed.
    """
    assert isinstance(doc, dict), f"trace doc must be a dict, got {type(doc)}"
    evs = doc.get("traceEvents")
    assert isinstance(evs, list), "traceEvents must be a list"
    counts = {"X": 0, "i": 0, "C": 0, "M": 0, "dropped": 0}
    spans: Dict[tuple, List[tuple]] = {}
    for ev in evs:
        assert isinstance(ev, dict), f"event must be a dict, got {ev!r}"
        ph = ev.get("ph")
        assert ph in ("X", "i", "C", "M"), f"unknown phase {ph!r} in {ev!r}"
        counts[ph] += 1
        assert isinstance(ev.get("name"), str) and ev["name"], \
            f"event missing name: {ev!r}"
        assert "pid" in ev and "tid" in ev, f"event missing pid/tid: {ev!r}"
        if ph == "M":
            if ev["name"] == DROPPED_META_NAME:
                n = ev.get("args", {}).get("dropped")
                assert isinstance(n, int) and n > 0, \
                    f"bad {DROPPED_META_NAME} row: {ev!r}"
                counts["dropped"] = n
            continue
        ts = ev.get("ts")
        assert isinstance(ts, (int, float)) and ts >= 0, \
            f"bad ts in {ev!r}"
        if ph == "X":
            dur = ev.get("dur")
            assert isinstance(dur, (int, float)) and dur >= 0, \
                f"bad dur in {ev!r}"
            spans.setdefault((ev["pid"], ev["tid"]), []).append(
                (float(ts), float(dur), ev["name"]))
        elif ph == "i":
            assert ev.get("s") in ("t", "p", "g"), \
                f"instant missing scope: {ev!r}"
        elif ph == "C":
            assert isinstance(ev.get("args"), dict) and ev["args"], \
                f"counter event needs a non-empty args series: {ev!r}"
    for track, ss in spans.items():
        ss.sort(key=lambda s: s[0])
        for (a0, ad, an), (b0, _bd, bn) in zip(ss, ss[1:]):
            assert b0 + _OVERLAP_EPS_US >= a0 + ad, (
                f"overlapping spans on track {track}: {an!r} "
                f"[{a0}, {a0 + ad}) vs {bn!r} starting {b0}")
    return counts
