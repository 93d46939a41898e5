"""Structured tracing + metrics for the sweep/serving hot paths (port of
``repro.obs.tracer``: numpy and the standard library, the same names,
event schema and JSONL format, so one package's trace files read in the
other's tools).

* ``MetricsRegistry`` — named ``Counter`` / ``Gauge`` / ``Histogram``
  aggregates (histograms carry exact count/sum/min/max plus p50/p90/p99
  over a bounded sample buffer; gauges keep a bounded time series, so RSS
  *growth* over a phase is visible).  All mutation is lock-guarded.

* ``Tracer`` — the span/event API over a registry: ``span(name)`` is a
  context manager timing a phase (duration lands in histogram
  ``<cat>.<name>`` AND as a trace event), ``instant``/``complete`` emit
  point/retroactive events, ``counter``/``gauge``/``observe`` feed the
  registry, and a periodic RSS sampler rides along on span exits.
  Timestamps are ``time.perf_counter_ns()`` (monotonic).  Events carry a
  ``track`` (one lane per shard in the Chrome trace; see
  ``repro_torch.obs.export``) and stream to a JSONL log when
  ``jsonl_path`` is given.

* ``NULL_TRACER`` — the default-off half of the contract: every
  ``telemetry=`` knob defaults to ``None``, ``as_tracer(None)`` returns
  this singleton whose methods are empty-body no-ops sharing one
  preallocated null span, so an uninstrumented sweep pays a few
  nanoseconds per chunk (``tests/test_torch_obs.py`` bounds it).

Telemetry NEVER touches evaluated values: it reads timestamps and host
scalars only, so fronts are bit-identical with tracing on or off.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Iterable, Iterator

import numpy as np

# Bounded-memory caps: histogram sample buffers and gauge/counter time
# series decimate (keep-every-2nd, doubling the record stride) once they
# hit this many samples — count/sum/min/max stay exact, quantiles become
# approximate over an evenly thinned sample.  Giga-scale sweeps emit a
# few events per chunk (~2.7k chunks at WIDE_SPACE), so the caps are only
# a guard against pathological callers, not a working limit.
MAX_SAMPLES = 65536
# Hard cap on buffered trace events; past it events are dropped (counted
# in ``Tracer.dropped_events``) rather than OOMing a long walk.
MAX_EVENTS = 1_000_000
# Default seconds between periodic RSS gauge samples.
RSS_INTERVAL_S = 0.25

_PAGE_SIZE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def rss_mb() -> float:
    """CURRENT resident-set size in MB (``/proc/self/statm``), not the
    ``ru_maxrss`` high-water mark — sampling this periodically is what
    lets a sweep report RSS *growth* per phase.  Falls back to the
    high-water mark on platforms without procfs."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * _PAGE_SIZE / 1e6
    except (OSError, ValueError, IndexError):
        import resource
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


class Histogram:
    """Streaming value distribution: exact count/sum/min/max plus
    quantiles over a bounded, evenly decimated sample buffer."""

    __slots__ = ("count", "total", "min", "max", "last",
                 "_values", "_stride", "_pending")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.last = float("nan")
        self._values: list[float] = []
        self._stride = 1      # record every stride-th observation
        self._pending = 0

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.total += v
        self.last = v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        self._pending += 1
        if self._pending >= self._stride:
            self._pending = 0
            self._values.append(v)
            if len(self._values) >= MAX_SAMPLES:
                self._values = self._values[::2]
                self._stride *= 2

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else float("nan")

    def quantile(self, q: float) -> float:
        if not self._values:
            return float("nan")
        return float(np.percentile(np.asarray(self._values, np.float64),
                                   100.0 * q))

    def summary(self) -> dict:
        """count/sum/min/max/mean + p50/p90/p99 as a JSON-friendly dict."""
        if not self.count:
            return dict(count=0)
        return dict(count=self.count, sum=self.total, min=self.min,
                    max=self.max, mean=self.mean, last=self.last,
                    p50=self.quantile(0.50), p90=self.quantile(0.90),
                    p99=self.quantile(0.99))


class Gauge:
    """Last-value metric with a bounded (ts, value) time series — the
    series (not just the final value) is what per-phase RSS growth and
    pipeline-occupancy plots read."""

    __slots__ = ("count", "last", "min", "max", "first", "_series",
                 "_stride", "_pending")

    def __init__(self):
        self.count = 0
        self.last = float("nan")
        self.min = float("inf")
        self.max = float("-inf")
        self.first = float("nan")
        self._series: list[tuple[float, float]] = []
        self._stride = 1
        self._pending = 0

    def set(self, value: float, ts: float | None = None) -> None:
        v = float(value)
        if not self.count:
            self.first = v
        self.count += 1
        self.last = v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        self._pending += 1
        if self._pending >= self._stride:
            self._pending = 0
            self._series.append((time.perf_counter() if ts is None else ts,
                                 v))
            if len(self._series) >= MAX_SAMPLES:
                self._series = self._series[::2]
                self._stride *= 2

    @property
    def series(self) -> list[tuple[float, float]]:
        """The recorded (perf_counter seconds, value) samples."""
        return list(self._series)

    def growth(self, since_sample: int = 0) -> float:
        """max - min over the samples recorded at/after ``since_sample``
        (an index into ``series``) — 0.0 with fewer than two samples.
        Benchmarks mark ``len(series)`` at a phase boundary and read the
        phase's growth from the slice."""
        vals = [v for _, v in self._series[since_sample:]]
        if len(vals) < 2:
            return 0.0
        return max(vals) - min(vals)

    def summary(self) -> dict:
        if not self.count:
            return dict(count=0)
        return dict(count=self.count, first=self.first, last=self.last,
                    min=self.min, max=self.max, samples=len(self._series))


class Counter:
    """Monotonic accumulator with a bounded (ts, increment) series — the
    series is what "pts/s over time" is binned from."""

    __slots__ = ("value", "count", "_series", "_stride", "_pending")

    def __init__(self):
        self.value = 0.0
        self.count = 0
        self._series: list[tuple[float, float]] = []
        self._stride = 1
        self._pending = 0

    def inc(self, n: float = 1.0, ts: float | None = None) -> None:
        n = float(n)
        self.value += n
        self.count += 1
        self._pending += 1
        if self._pending >= self._stride:
            self._pending = 0
            self._series.append((time.perf_counter() if ts is None else ts,
                                 n * self._stride))
            if len(self._series) >= MAX_SAMPLES:
                self._series = self._series[::2]
                self._stride *= 2

    @property
    def series(self) -> list[tuple[float, float]]:
        return list(self._series)

    def summary(self) -> dict:
        return dict(value=self.value, increments=self.count)


class MetricsRegistry:
    """Thread-safe name -> Counter/Gauge/Histogram store.

    The in-memory sink of the tracer trio (registry snapshot, JSONL event
    log, Chrome trace) and the thing ``SweepReport`` reads.  Lookup
    methods create on first use; ``as_dict()`` snapshots everything
    JSON-friendly.  A registry can also be used alone (no tracer): the
    benchmark harness keeps one always-on registry so BENCH rows and
    telemetry derive from the same numbers by construction.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter()
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge()
            return g

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram()
            return h

    @property
    def counters(self) -> dict[str, Counter]:
        with self._lock:
            return dict(self._counters)

    @property
    def gauges(self) -> dict[str, Gauge]:
        with self._lock:
            return dict(self._gauges)

    @property
    def histograms(self) -> dict[str, Histogram]:
        with self._lock:
            return dict(self._histograms)

    def as_dict(self) -> dict:
        return dict(
            counters={k: v.summary() for k, v in self.counters.items()},
            gauges={k: v.summary() for k, v in self.gauges.items()},
            histograms={k: v.summary()
                        for k, v in self.histograms.items()})


class TraceEvent:
    """One recorded event: ``ph`` follows the Chrome trace-event phase
    alphabet ("X" complete, "i" instant, "C" counter sample)."""

    __slots__ = ("ph", "name", "cat", "ts_ns", "dur_ns", "track", "args")

    def __init__(self, ph, name, cat, ts_ns, dur_ns, track, args):
        self.ph = ph
        self.name = name
        self.cat = cat
        self.ts_ns = ts_ns
        self.dur_ns = dur_ns
        self.track = track
        self.args = args

    def as_dict(self) -> dict:
        d = dict(ph=self.ph, name=self.name, cat=self.cat,
                 ts_ns=self.ts_ns, track=self.track)
        if self.dur_ns is not None:
            d["dur_ns"] = self.dur_ns
        if self.args:
            d["args"] = self.args
        return d


class _Span:
    """Context manager recording one timed phase.  On exit the duration
    lands in histogram ``<cat>.<name>`` (seconds) and — when the tracer
    records events — as one complete ("X") trace event."""

    __slots__ = ("_tr", "name", "cat", "track", "args", "t0")

    def __init__(self, tr, name, cat, track, args):
        self._tr = tr
        self.name = name
        self.cat = cat
        self.track = track
        self.args = args
        self.t0 = 0

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        self._tr._end_span(self)
        return False


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """The disabled tracer: every method is an empty-body no-op and
    ``span`` returns one preallocated null context manager — the hot
    paths call it unconditionally and pay nanoseconds."""

    __slots__ = ()
    enabled = False

    def span(self, name, cat="sweep", track=None, **args):
        return _NULL_SPAN

    def instant(self, name, cat="sweep", track=None, level=None, **args):
        pass

    def complete(self, name, start_ns, end_ns, cat="sweep", track=None,
                 **args):
        pass

    def counter(self, name, n=1.0):
        pass

    def gauge(self, name, value, track=None):
        pass

    def observe(self, name, value):
        pass

    def sample_rss(self, force=False):
        pass

    def close(self):
        pass


NULL_TRACER = NullTracer()


def as_tracer(telemetry) -> "Tracer | NullTracer":
    """Normalize a ``telemetry=`` knob: None -> the no-op singleton."""
    if telemetry is None:
        return NULL_TRACER
    if isinstance(telemetry, (Tracer, NullTracer)):
        return telemetry
    raise TypeError(f"telemetry must be a Tracer or None, got "
                    f"{type(telemetry).__name__}")


class Tracer:
    """Span/event tracer over a ``MetricsRegistry`` with three sinks:
    the registry (aggregates), an in-memory event buffer (Chrome trace),
    and an optional streaming JSONL log.

    ``record_events=False`` keeps only the registry aggregates (cheapest
    enabled mode — what the benchmark harness uses when no telemetry dir
    is configured).  ``rss_interval_s`` controls the periodic RSS gauge
    (samples ride along on span exits; 0 disables).  Thread-safe: spans
    may be entered/exited concurrently from the serving engine's threads.
    """

    enabled = True

    def __init__(self, registry: MetricsRegistry | None = None,
                 jsonl_path: str | None = None,
                 record_events: bool = True,
                 rss_interval_s: float = RSS_INTERVAL_S):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.t0_ns = time.perf_counter_ns()
        self.dropped_events = 0
        self._events: list[TraceEvent] = []
        self._record_events = record_events
        self._lock = threading.Lock()
        self._rss_interval = float(rss_interval_s)
        self._last_rss = 0.0
        self._jsonl_path = jsonl_path
        self._jsonl = None
        if jsonl_path is not None:
            parent = os.path.dirname(os.path.abspath(jsonl_path))
            os.makedirs(parent, exist_ok=True)
            self._jsonl = open(jsonl_path, "w")
        self.sample_rss(force=True)

    # -- event plumbing ----------------------------------------------------

    def _emit(self, ev: TraceEvent) -> None:
        if not self._record_events and self._jsonl is None:
            return
        with self._lock:
            if self._record_events:
                if len(self._events) < MAX_EVENTS:
                    self._events.append(ev)
                else:
                    self.dropped_events += 1
            if self._jsonl is not None:
                self._jsonl.write(json.dumps(ev.as_dict()) + "\n")

    @property
    def events(self) -> list[TraceEvent]:
        with self._lock:
            return list(self._events)

    # -- span / event API --------------------------------------------------

    def span(self, name: str, cat: str = "sweep", track: str | None = None,
             **args) -> _Span:
        return _Span(self, name, cat, track, args or None)

    def _end_span(self, span: _Span) -> None:
        end = time.perf_counter_ns()
        dur = end - span.t0
        self.registry.histogram(f"{span.cat}.{span.name}").observe(dur / 1e9)
        self._emit(TraceEvent("X", span.name, span.cat, span.t0, dur,
                              span.track, span.args))
        self.sample_rss()

    def instant(self, name: str, cat: str = "sweep",
                track: str | None = None, level: str | None = None,
                **args) -> None:
        if level is not None:
            args = dict(args, level=level)
        self._emit(TraceEvent("i", name, cat, time.perf_counter_ns(), None,
                              track, args or None))

    def complete(self, name: str, start_ns: int, end_ns: int,
                 cat: str = "sweep", track: str | None = None,
                 **args) -> None:
        """Record a retroactive complete event from caller-captured
        ``perf_counter_ns`` stamps — how the sharded pipeline draws each
        chunk's dispatch->retire residency on its shard's lane."""
        self.registry.histogram(f"{cat}.{name}").observe(
            (end_ns - start_ns) / 1e9)
        self._emit(TraceEvent("X", name, cat, start_ns, end_ns - start_ns,
                              track, args or None))

    def counter(self, name: str, n: float = 1.0) -> None:
        self.registry.counter(name).inc(n)

    def gauge(self, name: str, value: float, track: str | None = None) -> None:
        self.registry.gauge(name).set(value)
        self._emit(TraceEvent("C", name, "gauge", time.perf_counter_ns(),
                              None, track, {"value": float(value)}))

    def observe(self, name: str, value: float) -> None:
        self.registry.histogram(name).observe(value)

    def sample_rss(self, force: bool = False) -> None:
        """Periodic current-RSS gauge sample (at most one per
        ``rss_interval_s``; rides along on span exits)."""
        if self._rss_interval <= 0 and not force:
            return
        now = time.perf_counter()
        if force or now - self._last_rss >= self._rss_interval:
            self._last_rss = now
            self.registry.gauge("rss_mb").set(rss_mb(), ts=now)

    def now_ns(self) -> int:
        return time.perf_counter_ns()

    def close(self) -> None:
        """Flush and close the JSONL sink (idempotent)."""
        with self._lock:
            if self._jsonl is not None:
                self._jsonl.flush()
                self._jsonl.close()
                self._jsonl = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False


def timed_iter(it: Iterable, tracer, name: str = "decode",
               cat: str = "sweep", track: str | None = None) -> Iterator:
    """Wrap an iterator so each ``next()`` is timed as a span — how the
    walks attribute chunk-DECODE time (mixed-radix index arithmetic)
    separately from dispatch/evaluation.  With a disabled tracer this is
    a plain passthrough."""
    if not tracer.enabled:
        yield from it
        return
    it = iter(it)
    while True:
        with tracer.span(name, cat=cat, track=track):
            try:
                item = next(it)
            except StopIteration:
                return
        yield item
