"""Unified observability layer: event recorder, metrics registry,
time-series/SLO monitoring, cross-process collection, exporters and the
ops report.

Port of ``repro/obs``: the same event model, names, tracks and argument
keys, the same series/SLO layer, clock-handshake format and exporter
formats, so one trace reads the same from either package.
"""
from repro_torch.obs.recorder import (
    Event,
    NULL_RECORDER,
    NullRecorder,
    Recorder,
)
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    percentile,
)
from repro_torch.obs.export import (
    chrome_trace,
    read_jsonl,
    read_jsonl_with_meta,
    validate_chrome_trace,
    write_chrome_trace,
    write_jsonl,
)
from repro_torch.obs.timeseries import (
    Bucket,
    DEFAULT_INSTANT_VALUES,
    SeriesStore,
    TimeSeries,
    iter_observations,
)
from repro_torch.obs.slo import (
    Objective,
    SLOMonitor,
    SLOState,
    SLO_TRACK,
)
from repro_torch.obs.collect import (
    clock_handshake,
    dump_stream,
    merge_streams,
    read_stream,
    rebase_events,
)
from repro_torch.obs.report import (
    render_html,
    snapshot_text,
    sparkline_svg,
    write_html,
)

__all__ = [
    "Event",
    "NULL_RECORDER",
    "NullRecorder",
    "Recorder",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "percentile",
    "chrome_trace",
    "read_jsonl",
    "read_jsonl_with_meta",
    "validate_chrome_trace",
    "write_chrome_trace",
    "write_jsonl",
    "Bucket",
    "DEFAULT_INSTANT_VALUES",
    "SeriesStore",
    "TimeSeries",
    "iter_observations",
    "Objective",
    "SLOMonitor",
    "SLOState",
    "SLO_TRACK",
    "clock_handshake",
    "dump_stream",
    "merge_streams",
    "read_stream",
    "rebase_events",
    "render_html",
    "snapshot_text",
    "sparkline_svg",
    "write_html",
]
