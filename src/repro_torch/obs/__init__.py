"""repro_torch.obs — structured tracing, metrics, and trace export for the
port's sweep/serving hot paths (a copy of ``repro.obs``, which the port
may not import).

Quick start::

    from repro_torch.obs import Tracer, build_sweep_report, write_chrome_trace

    with Tracer(jsonl_path="out/events.jsonl") as tr:
        front = pareto_front_streaming(w, space, shards=4, telemetry=tr)
        print(build_sweep_report(tr).render())
        write_chrome_trace("out/trace.json", tr)   # open in Perfetto

Every ``telemetry=`` knob defaults to ``None`` (the no-op
``NULL_TRACER``), so uninstrumented sweeps pay nothing.
"""

from repro_torch.obs.tracer import (
    MAX_EVENTS,
    MAX_SAMPLES,
    RSS_INTERVAL_S,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    NULL_TRACER,
    NullTracer,
    TraceEvent,
    Tracer,
    as_tracer,
    rss_mb,
    timed_iter,
)
from repro_torch.obs.export import chrome_trace, trace_lanes, write_chrome_trace
from repro_torch.obs.report import (
    SweepReport,
    build_sweep_report,
    load_sweep_report,
    render_sweep_report,
    write_sweep_report,
)

__all__ = [
    "MAX_EVENTS",
    "MAX_SAMPLES",
    "RSS_INTERVAL_S",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL_TRACER",
    "NullTracer",
    "TraceEvent",
    "Tracer",
    "as_tracer",
    "rss_mb",
    "timed_iter",
    "chrome_trace",
    "trace_lanes",
    "write_chrome_trace",
    "SweepReport",
    "build_sweep_report",
    "load_sweep_report",
    "render_sweep_report",
    "write_sweep_report",
]
