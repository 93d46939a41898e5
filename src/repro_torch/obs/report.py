"""SweepReport — the in-memory registry snapshot rendered as answers
(port of ``repro.obs.report``).

* **wall-clock attribution** — seconds and share of wall across the
  host-side phases (``sweep.decode``, ``sweep.dispatch``,
  ``sweep.device_wait``, ``sweep.archive``, ``sweep.checkpoint``, pruner
  stages...).  The host loop is sequential, so the shares should sum to
  ~100% of wall; ``coverage`` says how much of wall the instrumented
  phases account for.
* **throughput over time** — the ``sweep.points`` counter series binned
  into a pts/s timeline, plus overall pts/s.
* **compile-time attribution** — ``compile.L<n>`` histograms and the
  ``sweep.compiles`` counter.  The reference counts XLA traces there;
  the port's walks are eager torch and compile nothing, so they emit no
  compile event and a port report's compile section is empty
  (``n_compiles`` 0).  The fields stay so both packages' reports share
  one schema.
* **RSS** — first/last/min/max/growth of the periodic ``rss_mb`` gauge.

What ``device_wait`` means differs by device.  It keeps the reference's
name: the span around ``dse.finish_chunk``.  On a CUDA device it is the
host blocked on the chunk's completion event (the device work that the
pipeline did not hide behind host work).  On the CPU the dispatch does
the work eagerly, so ``device_wait`` is only the host copy and reads
about 0; the evaluation's time lands in ``dispatch``.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass, field

# Registry names the instrumented walks use (keep in sync with dse/shard/
# coexplore/serve instrumentation; tests import these).
POINTS_COUNTER = "sweep.points"
COMPILES_COUNTER = "sweep.compiles"
COMPILE_PREFIX = "compile."
PHASE_PREFIX = "sweep."
RSS_GAUGE = "rss_mb"


@dataclass
class SweepReport:
    """JSON-friendly reduction of a traced sweep (see module docstring)."""

    wall_s: float
    points: float
    pts_per_s: float
    attribution: dict = field(default_factory=dict)   # phase -> {seconds, share, count}
    coverage: float = 0.0                             # accounted / wall
    compiles: dict = field(default_factory=dict)      # bucket -> {count, seconds}
    n_compiles: int = 0
    rss: dict = field(default_factory=dict)
    timeline: list = field(default_factory=list)      # [(t_rel_s, pts_per_s)]
    counters: dict = field(default_factory=dict)
    histograms: dict = field(default_factory=dict)
    dropped_events: int = 0

    def as_dict(self) -> dict:
        return dict(wall_s=self.wall_s, points=self.points,
                    pts_per_s=self.pts_per_s, attribution=self.attribution,
                    coverage=self.coverage, compiles=self.compiles,
                    n_compiles=self.n_compiles, rss=self.rss,
                    timeline=self.timeline, counters=self.counters,
                    histograms=self.histograms,
                    dropped_events=self.dropped_events)

    def render(self) -> str:
        return render_sweep_report(self)


def _wall_from_events(tracer) -> float:
    events = tracer.events
    if not events:
        return float("nan")
    start = min(e.ts_ns for e in events)
    end = max(e.ts_ns + (e.dur_ns or 0) for e in events)
    return (end - start) / 1e9


def _wall_from_series(registry) -> float:
    ts: list[float] = []
    for g in registry.gauges.values():
        s = g.series
        if s:
            ts += [s[0][0], s[-1][0]]
    for c in registry.counters.values():
        s = c.series
        if s:
            ts += [s[0][0], s[-1][0]]
    return max(ts) - min(ts) if len(ts) >= 2 else float("nan")


def build_sweep_report(tracer, wall_s: float | None = None,
                       timeline_bins: int = 24) -> SweepReport:
    """Reduce a tracer (or anything with ``.registry``/``.events``) to a
    ``SweepReport``.  ``wall_s`` overrides the inferred wall clock (event
    bounds, falling back to registry series bounds) — pass the caller's
    own measurement when the tracer outlives the sweep."""
    registry = tracer.registry
    hists = registry.histograms
    counters = registry.counters
    gauges = registry.gauges

    if wall_s is None:
        wall_s = _wall_from_events(tracer)
        if not math.isfinite(wall_s):
            wall_s = _wall_from_series(registry)

    # -- wall-clock attribution over host-side phase histograms ----------
    attribution: dict[str, dict] = {}
    accounted = 0.0
    for name, h in sorted(hists.items()):
        if not name.startswith(PHASE_PREFIX) or not h.count:
            continue
        phase = name[len(PHASE_PREFIX):]
        share = (h.total / wall_s) if wall_s and math.isfinite(wall_s) else float("nan")
        attribution[phase] = dict(seconds=h.total, share=share,
                                  count=h.count, p50=h.quantile(0.5),
                                  p99=h.quantile(0.99))
        accounted += h.total
    coverage = (accounted / wall_s) if wall_s and math.isfinite(wall_s) else float("nan")

    # -- compile attribution per layer bucket ----------------------------
    compiles = {name[len(COMPILE_PREFIX):]: dict(count=h.count, seconds=h.total)
                for name, h in sorted(hists.items())
                if name.startswith(COMPILE_PREFIX) and h.count}
    n_compiles = int(counters[COMPILES_COUNTER].value) \
        if COMPILES_COUNTER in counters else \
        sum(b["count"] for b in compiles.values())

    # -- throughput ------------------------------------------------------
    points = counters[POINTS_COUNTER].value if POINTS_COUNTER in counters else 0.0
    pts_per_s = points / wall_s if points and wall_s and math.isfinite(wall_s) \
        else float("nan")
    timeline: list[tuple[float, float]] = []
    series = counters[POINTS_COUNTER].series if POINTS_COUNTER in counters else []
    if len(series) >= 2 and timeline_bins > 0:
        t0, t1 = series[0][0], series[-1][0]
        span = max(t1 - t0, 1e-9)
        nbins = min(timeline_bins, len(series))
        width = span / nbins
        bins = [0.0] * nbins
        for ts, n in series:
            b = min(int((ts - t0) / width), nbins - 1)
            bins[b] += n
        timeline = [(round(i * width, 6), bins[i] / width)
                    for i in range(nbins)]

    # -- RSS -------------------------------------------------------------
    rss: dict = {}
    if RSS_GAUGE in gauges:
        g = gauges[RSS_GAUGE]
        rss = dict(first_mb=g.first, last_mb=g.last, min_mb=g.min,
                   max_mb=g.max, growth_mb=g.growth(), samples=len(g.series))

    return SweepReport(
        wall_s=wall_s, points=points, pts_per_s=pts_per_s,
        attribution=attribution, coverage=coverage, compiles=compiles,
        n_compiles=n_compiles, rss=rss, timeline=timeline,
        counters={k: c.summary() for k, c in counters.items()},
        histograms={k: h.summary() for k, h in hists.items()},
        dropped_events=getattr(tracer, "dropped_events", 0))


def render_sweep_report(report: SweepReport) -> str:
    """Markdown rendering: the attribution table plus compile / RSS /
    throughput one-liners."""
    lines = ["## Sweep report", ""]
    if math.isfinite(report.wall_s):
        tput = (f", {report.pts_per_s:,.0f} pts/s"
                if math.isfinite(report.pts_per_s) else "")
        lines.append(f"wall {report.wall_s:.3f} s, "
                     f"{report.points:,.0f} points{tput}")
    lines += ["", "| phase | seconds | share | count | p50 ms | p99 ms |",
              "|---|---|---|---|---|---|"]
    for phase, a in sorted(report.attribution.items(),
                           key=lambda kv: -kv[1]["seconds"]):
        share = f"{100.0 * a['share']:.1f}%" if math.isfinite(a["share"]) else "-"
        lines.append(f"| {phase} | {a['seconds']:.3f} | {share} "
                     f"| {a['count']} | {1e3 * a['p50']:.2f} "
                     f"| {1e3 * a['p99']:.2f} |")
    if math.isfinite(report.coverage):
        lines.append(f"| **total accounted** | — | "
                     f"**{100.0 * report.coverage:.1f}%** | | | |")
    if report.compiles:
        per_bucket = ", ".join(
            f"{b}: {v['count']}x {v['seconds']:.2f}s"
            for b, v in sorted(report.compiles.items()))
        lines += ["", f"compiles: {report.n_compiles} ({per_bucket})"]
    else:
        lines += ["", f"compiles: {report.n_compiles}"]
    if report.rss:
        r = report.rss
        lines.append(f"rss: {r['first_mb']:.0f} -> {r['last_mb']:.0f} MB "
                     f"(growth {r['growth_mb']:.1f} MB over "
                     f"{r['samples']} samples)")
    if report.dropped_events:
        lines.append(f"WARNING: {report.dropped_events} trace events dropped")
    return "\n".join(lines) + "\n"


def write_sweep_report(path: str, report: SweepReport) -> str:
    """Serialize ``report.as_dict()`` as JSON (atomic); returns ``path``."""
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(report.as_dict(), f, indent=1)
    os.replace(tmp, path)
    return path


def load_sweep_report(path: str) -> SweepReport:
    """Inverse of ``write_sweep_report`` (timeline tuples come back as
    lists — fine for rendering)."""
    with open(path) as f:
        d = json.load(f)
    return SweepReport(**d)
