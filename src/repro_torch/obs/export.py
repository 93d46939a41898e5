"""Chrome trace-event export (port of ``repro.obs.export``): render a
traced sweep for ``chrome://tracing`` or Perfetto (https://ui.perfetto.dev).

The exporter maps each event ``track`` to one lane (Chrome "thread"):
the host driver runs on the ``main`` lane and every shard of the async
pipeline gets its own ``shard<N>`` lane carrying its chunks'
dispatch->retire residency bars — so the double-buffering claim ("host
archive reduction overlaps device evaluation") is *visually* verifiable:
host-lane ``archive`` spans sit under resident chunk bars on the shard
lanes.  Gauge samples become Chrome counter tracks (pipeline in-flight
depth, RSS).

Timestamps are the tracer's monotonic ``perf_counter_ns`` rebased to its
start and converted to the microseconds Chrome expects.
"""

from __future__ import annotations

import json
import os

# Stable lane ordering: host first, then shards in numeric order, then
# anything else alphabetically.
_MAIN_TRACK = "main"


def _track_order(tracks) -> list[str]:
    def key(t: str):
        if t == _MAIN_TRACK:
            return (0, 0, t)
        if t.startswith("shard"):
            suffix = t[5:]
            if suffix.isdigit():
                return (1, int(suffix), t)
        return (2, 0, t)
    return sorted(tracks, key=key)


def chrome_trace(tracer, process_name: str = "sweep") -> dict:
    """The tracer's event buffer as a Chrome trace-event JSON object
    (``{"traceEvents": [...]}``) — load it in chrome://tracing or
    Perfetto.  Spans/completes become "X" events, instants "i", gauge
    samples "C" counter tracks; one lane per distinct event track with
    the host (``main``) lane sorted first."""
    events = tracer.events
    t0 = tracer.t0_ns
    tracks = {e.track or _MAIN_TRACK for e in events}
    tracks.add(_MAIN_TRACK)
    tids = {t: i for i, t in enumerate(_track_order(tracks))}
    out = [
        {"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
         "args": {"name": process_name}},
    ]
    for track, tid in tids.items():
        out.append({"ph": "M", "name": "thread_name", "pid": 0, "tid": tid,
                    "args": {"name": track}})
        out.append({"ph": "M", "name": "thread_sort_index", "pid": 0,
                    "tid": tid, "args": {"sort_index": tid}})
    for e in events:
        tid = tids[e.track or _MAIN_TRACK]
        ts_us = (e.ts_ns - t0) / 1e3
        if e.ph == "X":
            ev = {"ph": "X", "name": e.name, "cat": e.cat, "pid": 0,
                  "tid": tid, "ts": ts_us, "dur": (e.dur_ns or 0) / 1e3}
        elif e.ph == "C":
            ev = {"ph": "C", "name": e.name, "pid": 0, "tid": tid,
                  "ts": ts_us}
        else:
            ev = {"ph": "i", "name": e.name, "cat": e.cat, "pid": 0,
                  "tid": tid, "ts": ts_us, "s": "t"}
        if e.args:
            ev["args"] = dict(e.args)
        out.append(ev)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, tracer, process_name: str = "sweep") -> str:
    """Write ``chrome_trace(tracer)`` atomically (tmp + ``os.replace``);
    returns ``path``."""
    trace = chrome_trace(tracer, process_name=process_name)
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(trace, f)
    os.replace(tmp, path)
    return path


def trace_lanes(trace: dict) -> dict[str, int]:
    """track-name -> tid map of a ``chrome_trace`` object (test/debug
    helper: asserts like "one lane per shard" read this)."""
    return {e["args"]["name"]: e["tid"]
            for e in trace["traceEvents"]
            if e.get("ph") == "M" and e.get("name") == "thread_name"}
