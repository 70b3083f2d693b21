"""Static HTML ops report + terminal snapshot. Stdlib only (port of
``repro/obs/report.py``; both packages render the same text).

One self-contained HTML file (inline CSS + inline SVG sparklines, no
external assets, no JS, no new dependencies) summarizing a run the way
an on-call engineer would want to see it:

* a truncation banner when the source ring dropped events,
* per-series sparklines (bucket means over the retained window) with
  count / mean / min / max,
* the SLO attainment table (attainment vs target, error-budget burn
  rate, violation status per objective),
* the recorded violation list (what fell out of budget, and when,
  relative to the window),
* the full metrics summary (``MetricsRegistry.summary_text``).

``snapshot_text`` is the same content as a terminal block, the
``summary_text``-style quick look a run prints.

Writes are atomic (tmp + ``os.replace``), like every exporter here.
"""
from __future__ import annotations

import html as _html
from typing import List, Optional, Sequence

from repro_torch.util import atomic_write_text

_CSS = """
body { font-family: ui-monospace, Menlo, Consolas, monospace;
       margin: 2rem auto; max-width: 64rem; color: #1a1a2e;
       background: #fafafa; }
h1 { font-size: 1.3rem; } h2 { font-size: 1.05rem; margin-top: 2rem; }
table { border-collapse: collapse; width: 100%; font-size: 0.85rem; }
th, td { text-align: left; padding: 0.3rem 0.6rem;
         border-bottom: 1px solid #ddd; }
th { border-bottom: 2px solid #999; }
td.num { text-align: right; font-variant-numeric: tabular-nums; }
.ok { color: #1a7f37; } .bad { color: #b42318; font-weight: bold; }
.banner { background: #fff3cd; border: 1px solid #b42318;
          padding: 0.6rem 1rem; margin: 1rem 0; }
pre { background: #f0f0f5; padding: 1rem; overflow-x: auto;
      font-size: 0.8rem; }
svg { vertical-align: middle; }
"""


def _esc(s) -> str:
    return _html.escape(str(s))


def sparkline_svg(values: Sequence[float], width: int = 160,
                  height: int = 28) -> str:
    """Inline-SVG sparkline: min..max normalized polyline, last point
    marked. Empty/constant series render as a flat midline."""
    vs = [float(v) for v in values]
    if not vs:
        return (f'<svg width="{width}" height="{height}" '
                f'role="img" aria-label="no data"></svg>')
    vmin, vmax = min(vs), max(vs)
    span = (vmax - vmin) or 1.0
    pad = 2
    if len(vs) == 1:
        vs = vs * 2
    step = (width - 2 * pad) / (len(vs) - 1)
    pts = []
    for i, v in enumerate(vs):
        x = pad + i * step
        y = pad + (height - 2 * pad) * (1.0 - (v - vmin) / span)
        pts.append(f"{x:.1f},{y:.1f}")
    lx, ly = pts[-1].split(",")
    return (
        f'<svg width="{width}" height="{height}" role="img" '
        f'aria-label="sparkline, {len(values)} points, '
        f'min {vmin:.4g}, max {vmax:.4g}">'
        f'<polyline points="{" ".join(pts)}" fill="none" '
        f'stroke="#2a5db0" stroke-width="1.5"/>'
        f'<circle cx="{lx}" cy="{ly}" r="2" fill="#b42318"/></svg>')


def _series_rows(store) -> List[str]:
    rows = []
    for name in store.names():
        s = store.series(name)
        bs = s.buckets()
        means = [b.mean for b in bs]
        vmin = min((b.vmin for b in bs), default=0.0)
        vmax = max((b.vmax for b in bs), default=0.0)
        mean = (s.total / s.count) if s.count else 0.0
        dropped = f" (+{s.dropped} dropped)" if s.dropped else ""
        rows.append(
            f"<tr><td>{_esc(name)}</td>"
            f"<td class=num>{s.count}{_esc(dropped)}</td>"
            f"<td class=num>{mean:.4g}</td>"
            f"<td class=num>{vmin:.4g}</td>"
            f"<td class=num>{vmax:.4g}</td>"
            f"<td>{sparkline_svg(means)}</td></tr>")
    return rows


def _slo_rows(states) -> List[str]:
    rows = []
    for name, st in sorted(states.items()):
        o = st.objective
        cls, label = (("bad", "VIOLATED") if st.in_violation
                      else ("ok", "ok"))
        cmp_s = "&le;" if o.lower_is_better else "&ge;"
        rows.append(
            f"<tr><td>{_esc(name)}</td>"
            f"<td>{_esc(o.series)} {cmp_s} {o.threshold:.4g}</td>"
            f"<td class=num>{o.target:.2%}</td>"
            f"<td class=num>{st.attainment:.2%}</td>"
            f"<td class=num>{st.good}/{st.total}</td>"
            f"<td class=num>{st.burn_rate:.2f}x</td>"
            f"<td class={cls}>{label}</td></tr>")
    return rows


def render_html(title: str = "repro ops report", store=None, slo=None,
                metrics=None, dropped: int = 0) -> str:
    """The report document as a string; every section is optional."""
    parts = [
        "<!DOCTYPE html><html lang=\"en\"><head>",
        "<meta charset=\"utf-8\">",
        f"<title>{_esc(title)}</title>",
        f"<style>{_CSS}</style></head><body>",
        f"<h1>{_esc(title)}</h1>",
    ]
    if dropped:
        parts.append(
            f"<div class=banner>⚠ recorder ring dropped "
            f"<b>{int(dropped)}</b> oldest events — this report covers "
            f"a truncated timeline.</div>")
    states = slo.evaluate() if slo is not None else None
    if states is not None:
        parts.append("<h2>SLO attainment</h2>")
        parts.append(
            "<table><tr><th>objective</th><th>rule</th><th>target</th>"
            "<th>attainment</th><th>good/total</th><th>budget burn</th>"
            "<th>status</th></tr>"
            + "".join(_slo_rows(states)) + "</table>")
        if slo.violations:
            parts.append(f"<h2>Violations ({len(slo.violations)})</h2><ul>")
            for v in slo.violations:
                parts.append(
                    f"<li>{_esc(v['objective'])} on {_esc(v['series'])}: "
                    f"attainment {v['attainment']:.2%}, burn "
                    f"{v['burn_rate']:.2f}x ({v['bad']}/"
                    f"{v['good'] + v['bad']} bad)</li>")
            parts.append("</ul>")
    if store is not None and store.names():
        parts.append("<h2>Time series</h2>")
        parts.append(
            "<table><tr><th>series</th><th>n</th><th>mean</th>"
            "<th>min</th><th>max</th><th>trend (bucket means)</th></tr>"
            + "".join(_series_rows(store)) + "</table>")
    if metrics is not None:
        parts.append("<h2>Metrics</h2>")
        parts.append(f"<pre>{_esc(metrics.summary_text())}</pre>")
    parts.append("</body></html>")
    return "\n".join(parts)


def write_html(path: str, title: str = "repro ops report", store=None,
               slo=None, metrics=None, dropped: int = 0) -> str:
    """Render + atomic write; returns ``path``."""
    text = render_html(title=title, store=store, slo=slo,
                       metrics=metrics, dropped=dropped)
    atomic_write_text(path, text)
    return path


def snapshot_text(store=None, slo=None, metrics=None,
                  title: Optional[str] = None) -> str:
    """Terminal twin of the report: series one-liners + SLO states."""
    lines: List[str] = []
    if title:
        lines.append(title)
        lines.append("=" * len(title))
    if slo is not None:
        for name, st in sorted(slo.evaluate().items()):
            o = st.objective
            mark = "VIOLATED" if st.in_violation else "ok"
            lines.append(
                f"slo {name:<20} {st.attainment:7.2%} of target "
                f"{o.target:.2%}  burn {st.burn_rate:5.2f}x  [{mark}]")
    if store is not None:
        for name in store.names():
            s = store.series(name)
            mean = (s.total / s.count) if s.count else 0.0
            lines.append(
                f"ts  {name:<28} n={s.count:<6} mean={mean:<10.4g} "
                f"buckets={len(s)}")
    if metrics is not None:
        lines.append(metrics.summary_text())
    return "\n".join(lines)
