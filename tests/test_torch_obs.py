"""Sweep telemetry of the port (``repro_torch.obs``), mirroring
``tests/test_obs.py`` case by case: tracer / registry / exporter units,
fronts bit-identical with telemetry on or off (all three walks, sharded
and unsharded, both cost-model backends), near-zero disabled cost, one
Chrome-trace lane per shard, checkpoint and serving events.  The port
compiles nothing, so where the reference counts compiles the mirror
asserts that none is reported.  Cross-package: the two tracers write the
same event schema and JSONL format, and the two reports the same keys.
(``TestBenchCommon`` tests ``benchmarks/common.py`` and is not
mirrored.)"""

import json
import threading
import time

import numpy as np
import pytest
import torch

import repro_torch.obs.tracer as tracer_mod
from repro_torch.checkpoint import manager
from repro_torch.core import (Budget, coexplore_front,
                              evaluate_space_streaming,
                              pareto_front_streaming)
from repro_torch.obs import (MAX_SAMPLES, Histogram, MetricsRegistry,
                             NULL_TRACER, NullTracer, Tracer, as_tracer,
                             build_sweep_report, chrome_trace,
                             load_sweep_report, rss_mb, timed_iter,
                             trace_lanes, write_chrome_trace,
                             write_sweep_report)

import _torch_scale_helpers as H
from _torch_scale_helpers import CHUNK, METRICS, TINY_SPACE, cpus

BUDGET = Budget(area_mm2=60.0, power_mw=1e5)


@pytest.fixture(scope="module")
def workload():
    return H.workload()


@pytest.fixture(scope="module")
def tiny_models():
    return H.tiny_models()


@pytest.fixture(scope="module")
def ppa_models():
    return H.ppa_models()


_assert_archives_equal = H.assert_archives_equal


# ---------------------------------------------------------------------------
# metric primitives
# ---------------------------------------------------------------------------

class TestPrimitives:

    def test_histogram_exact_stats_and_quantiles(self):
        h = Histogram()
        for v in range(1000):
            h.observe(float(v))
        assert h.count == 1000
        assert h.total == sum(range(1000))
        assert (h.min, h.max, h.last) == (0.0, 999.0, 999.0)
        assert abs(h.quantile(0.5) - 499.5) < 5
        assert h.quantile(0.99) > h.quantile(0.90) > h.quantile(0.50)
        s = h.summary()
        assert s["count"] == 1000 and "p50" in s and "p99" in s
        assert Histogram().summary() == dict(count=0)

    def test_histogram_decimation_keeps_exact_aggregates(self):
        h = Histogram()
        n = MAX_SAMPLES * 2 + 17
        for v in range(n):
            h.observe(v)
        assert h.count == n                    # exact despite decimation
        assert h.total == sum(range(n))
        assert (h.min, h.max) == (0, n - 1)
        assert len(h._values) < MAX_SAMPLES    # buffer stays bounded
        assert abs(h.quantile(0.5) / (n / 2) - 1) < 0.05

    def test_gauge_growth_marks(self):
        reg = MetricsRegistry()
        g = reg.gauge("rss_mb")
        for v in (100, 120, 110):
            g.set(v)
        mark = len(g.series)
        for v in (110, 140, 150):
            g.set(v)
        assert g.growth() == 50
        assert g.growth(since_sample=mark) == 40   # phase slice only
        assert g.growth(since_sample=len(g.series)) == 0.0
        assert (g.first, g.last, g.min, g.max) == (100, 150, 100, 150)

    def test_counter_value_and_series(self):
        reg = MetricsRegistry()
        c = reg.counter("pts")
        for _ in range(10):
            c.inc(16)
        assert c.value == 160
        assert sum(n for _, n in c.series) == 160
        ts = [t for t, _ in c.series]
        assert ts == sorted(ts)

    def test_registry_thread_safety(self):
        reg = MetricsRegistry()

        def hammer():
            for _ in range(5000):
                reg.counter("c").inc()
                reg.histogram("h").observe(1.0)
                reg.gauge("g").set(1.0)

        threads = [threading.Thread(target=hammer) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert reg.counter("c").value == 40000
        assert reg.histogram("h").count == 40000
        d = reg.as_dict()
        assert set(d) == {"counters", "gauges", "histograms"}


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------

class TestTracer:

    def test_null_tracer_contract(self):
        assert as_tracer(None) is NULL_TRACER
        assert not NULL_TRACER.enabled
        tr = Tracer(record_events=False)
        assert as_tracer(tr) is tr
        assert isinstance(as_tracer(NULL_TRACER), NullTracer)
        with pytest.raises(TypeError):
            as_tracer(object())
        # every method is a no-op that doesn't blow up
        with NULL_TRACER.span("x", track="shard0", foo=1):
            pass
        NULL_TRACER.instant("i", level="warning")
        NULL_TRACER.complete("c", 0, 10)
        NULL_TRACER.counter("c")
        NULL_TRACER.gauge("g", 1.0)
        NULL_TRACER.observe("h", 1.0)
        NULL_TRACER.sample_rss()
        NULL_TRACER.close()

    def test_span_feeds_histogram_and_events(self, tmp_path):
        path = str(tmp_path / "events.jsonl")
        with Tracer(jsonl_path=path) as tr:
            with tr.span("decode", cat="sweep", track="main"):
                pass
            tr.instant("compile", bucket="L22", level="warning")
            tr.complete("chunk", 100, 300, cat="pipeline", track="shard0",
                        chunk=7)
            tr.gauge("pipeline.in_flight", 3)
            tr.counter("sweep.points", 16)
            tr.observe("compile.L22", 1.5)
        reg = tr.registry
        assert reg.histograms["sweep.decode"].count == 1
        assert reg.histograms["pipeline.chunk"].count == 1
        assert reg.histograms["pipeline.chunk"].last == pytest.approx(2e-7)
        assert reg.counters["sweep.points"].value == 16
        assert reg.gauges["pipeline.in_flight"].last == 3
        phases = [(e.ph, e.name) for e in tr.events]
        assert ("X", "decode") in phases and ("X", "chunk") in phases
        assert ("i", "compile") in phases and ("C", "pipeline.in_flight") \
            in phases
        inst = next(e for e in tr.events if e.ph == "i")
        assert inst.args["level"] == "warning"
        with open(path) as f:
            lines = [json.loads(ln) for ln in f]
        assert len(lines) >= 4 and all("ph" in ln and "ts_ns" in ln
                                       for ln in lines)
        tr.close()  # idempotent

    def test_event_cap_counts_drops(self, monkeypatch):
        monkeypatch.setattr(tracer_mod, "MAX_EVENTS", 5)
        tr = Tracer(rss_interval_s=0)
        for i in range(9):
            tr.instant(f"e{i}")
        assert len(tr.events) == 5
        assert tr.dropped_events == 4

    def test_timed_iter(self):
        items = list(range(7))
        assert list(timed_iter(iter(items), NULL_TRACER)) == items
        tr = Tracer(record_events=False)
        assert list(timed_iter(iter(items), tr, name="decode")) == items
        assert tr.registry.histograms["sweep.decode"].count >= len(items)

    def test_rss_gauge_samples_current_rss(self):
        assert rss_mb() > 10.0
        tr = Tracer(record_events=False, rss_interval_s=0.0)
        tr.sample_rss(force=True)
        g = tr.registry.gauges["rss_mb"]
        assert g.count >= 2 and g.last > 10.0     # __init__ seeds one
        assert g.growth() >= 0.0

    def test_disabled_tracer_near_zero_cost(self):
        """The disabled tracer costs about what the cheapest Python calls
        cost: timed against a local no-op object with the same call
        shape (a context manager and two methods), as a ratio with a
        generous bound, so a loaded machine slows both sides alike
        (the reference bounds the absolute time a call instead)."""
        class _Noop:
            def __enter__(self):
                return self

            def __exit__(self, *exc):
                return False

            def span(self, name):
                return self

            def counter(self, name, n=1):
                pass

            def observe(self, name, v):
                pass

        def loop(t, n=20_000):
            t0 = time.perf_counter()
            for _ in range(n):
                with t.span("x"):
                    pass
                t.counter("c", 16)
                t.observe("h", 1.0)
            return time.perf_counter() - t0

        noop = _Noop()
        base = min(loop(noop) for _ in range(3))
        null = min(loop(NULL_TRACER) for _ in range(3))
        assert null < 5.0 * base, (null, base)


# ---------------------------------------------------------------------------
# exporters + report
# ---------------------------------------------------------------------------

class TestExportAndReport:

    def _tracer_with_shards(self):
        tr = Tracer(rss_interval_s=0)
        for s in (0, 1):
            with tr.span("dispatch", track=f"shard{s}"):
                pass
        with tr.span("archive"):
            pass
        tr.gauge("pipeline.in_flight", 2)
        return tr

    def test_chrome_trace_one_lane_per_shard(self, tmp_path):
        tr = self._tracer_with_shards()
        trace = chrome_trace(tr)
        assert trace["displayTimeUnit"] == "ms"
        evs = trace["traceEvents"]
        assert all(e["pid"] == 0 for e in evs)
        lanes = trace_lanes(trace)
        assert {"main", "shard0", "shard1"} <= set(lanes)
        assert len(set(lanes.values())) == len(lanes)  # distinct tids
        # main sorts first, shards in numeric order
        assert lanes["main"] < lanes["shard0"] < lanes["shard1"]
        for e in evs:
            if e["ph"] == "X":
                assert e["dur"] >= 0 and e["ts"] >= 0
        out = tmp_path / "trace.json"
        write_chrome_trace(str(out), tr)
        assert trace_lanes(json.loads(out.read_text())) == lanes

    def test_sweep_report_attribution_exact(self, tmp_path):
        tr = Tracer(rss_interval_s=0)
        t0 = tr.now_ns()
        tr.complete("decode", t0, t0 + int(2e8))          # 0.2 s
        tr.complete("dispatch", t0, t0 + int(3e8))        # 0.3 s
        tr.complete("chunk", t0, t0 + int(9e8), cat="pipeline")  # ignored
        tr.counter("sweep.points", 100)
        tr.counter("sweep.compiles", 2)
        tr.observe("compile.L22", 1.5)
        rep = build_sweep_report(tr, wall_s=1.0)
        assert rep.points == 100 and rep.pts_per_s == pytest.approx(100.0)
        assert rep.attribution["decode"]["share"] == pytest.approx(0.2)
        assert rep.attribution["dispatch"]["share"] == pytest.approx(0.3)
        assert "chunk" not in rep.attribution   # pipeline cat excluded
        assert rep.coverage == pytest.approx(0.5)
        assert rep.n_compiles == 2
        assert rep.compiles["L22"]["count"] == 1
        text = rep.render()
        assert "decode" in text and "total accounted" in text
        out = tmp_path / "sweep_report.json"
        write_sweep_report(str(out), rep)
        back = load_sweep_report(str(out))
        assert back.points == rep.points
        assert back.attribution["decode"]["seconds"] == \
            pytest.approx(rep.attribution["decode"]["seconds"])


# ---------------------------------------------------------------------------
# the walks: bit-identical fronts with telemetry on, real trace content
# ---------------------------------------------------------------------------

def _shard_kw(shards):
    return dict(shards=shards, devices=cpus(shards)) if shards else {}


class TestWalksBitIdentical:

    @pytest.mark.parametrize("shards", (None, 2))
    @pytest.mark.parametrize("backend", ("oracle", "surrogate"))
    def test_pareto_front_streaming(self, workload, ppa_models, shards,
                                    backend):
        kw = dict(chunk_size=CHUNK, metrics=METRICS, **_shard_kw(shards))
        if backend == "surrogate":
            kw["surrogate"] = ppa_models
        ref, _ = pareto_front_streaming(workload, TINY_SPACE, **kw)
        with Tracer(rss_interval_s=0) as tr:
            got, _ = pareto_front_streaming(workload, TINY_SPACE,
                                            telemetry=tr, **kw)
        H.assert_archives_identical(ref, got)
        reg = tr.registry
        assert reg.counters["sweep.points"].value == 40  # |TINY_SPACE|
        assert reg.histograms["sweep.dispatch"].count >= 1
        assert reg.histograms["sweep.archive"].count >= 1

    @pytest.mark.parametrize("prune", (False, True))
    def test_pruned_budget_walk(self, workload, prune):
        kw = dict(chunk_size=CHUNK, metrics=METRICS, budget=BUDGET,
                  prune=prune)
        ref, _ = pareto_front_streaming(workload, TINY_SPACE, **kw)
        with Tracer(rss_interval_s=0) as tr:
            got, _ = pareto_front_streaming(workload, TINY_SPACE,
                                            telemetry=tr, **kw)
        H.assert_archives_identical(ref, got)
        if prune:
            assert tr.registry.histograms["sweep.prune_stage1"].count >= 1
            assert tr.registry.counters["prune.flushes"].value >= 1

    @pytest.mark.parametrize("shards", (None, 3))
    def test_evaluate_space_streaming(self, workload, shards):
        def collect(**kw):
            rows = {}
            for res, idx in evaluate_space_streaming(
                    workload, TINY_SPACE, chunk_size=CHUNK, **kw):
                for j, i in enumerate(np.asarray(idx)):
                    rows[int(i)] = (float(res.latency_s[j]),
                                    float(res.energy_j[j]))
            return rows
        kw = _shard_kw(shards)
        ref = collect(**kw)
        with Tracer(rss_interval_s=0) as tr:
            got = collect(telemetry=tr, **kw)
        assert ref == got
        assert tr.registry.counters["sweep.points"].value == 40

    @pytest.mark.parametrize("shards", (None, 2))
    @pytest.mark.parametrize("backend", ("oracle", "surrogate"))
    def test_coexplore_front(self, tiny_models, ppa_models, shards, backend):
        kw = dict(chunk_size=CHUNK, max_points=150, seed=3,
                  **_shard_kw(shards))
        if backend == "surrogate":
            kw["surrogate"] = ppa_models
        ref = coexplore_front(tiny_models, TINY_SPACE, **kw)
        with Tracer(rss_interval_s=0) as tr:
            got = coexplore_front(tiny_models, TINY_SPACE, telemetry=tr,
                                  **kw)
        H.assert_archives_identical(ref.archive, got.archive)
        assert got.per_model_best == ref.per_model_best
        assert got.points_evaluated == ref.points_evaluated
        assert tr.registry.counters["sweep.points"].value == \
            ref.points_evaluated

    def test_coexplore_budget_kill_counters(self, tiny_models):
        # mid-range area bound: TINY_SPACE spans ~0.38-3.4 mm^2, so some
        # lanes die at the config-only stage and feed the kill counters
        kw = dict(chunk_size=CHUNK, budget=Budget(area_mm2=0.6), prune=True)
        ref = coexplore_front(tiny_models, TINY_SPACE, **kw)
        with Tracer(rss_interval_s=0) as tr:
            got = coexplore_front(tiny_models, TINY_SPACE, telemetry=tr,
                                  **kw)
        H.assert_archives_identical(ref.archive, got.archive)
        expected = ref.budget_stats.evaluated - ref.budget_stats.feasible
        assert expected > 0
        assert tr.registry.counters["budget.killed"].value == expected
        per_cons = {k: c.value for k, c in tr.registry.counters.items()
                    if k.startswith("budget.kill.")}
        assert per_cons and sum(per_cons.values()) >= expected

    def test_sharded_trace_has_one_lane_per_shard(self, workload):
        with Tracer() as tr:
            pareto_front_streaming(workload, TINY_SPACE, chunk_size=CHUNK,
                                   metrics=METRICS, telemetry=tr,
                                   **_shard_kw(2))
        lanes = trace_lanes(chrome_trace(tr))
        assert {"shard0", "shard1"} <= set(lanes)
        reg = tr.registry
        assert reg.histograms["pipeline.chunk"].count >= 1
        assert reg.gauges["pipeline.in_flight"].max >= 1
        rep = build_sweep_report(tr)
        assert rep.points == 40
        # host phases are sequential, so attribution never exceeds wall
        assert 0.0 < rep.coverage <= 1.05

    def test_compile_events_charged_to_layer_bucket(self, workload):
        """The reference charges XLA compiles to ``compile.L<n>``; eager
        torch compiles nothing, so the port's walk emits no compile
        event, counter or histogram, and its report's compile section is
        empty (``n_compiles`` 0)."""
        with Tracer(rss_interval_s=0) as tr:
            pareto_front_streaming(workload, TINY_SPACE, chunk_size=13,
                                   metrics=METRICS, telemetry=tr)
        reg = tr.registry
        assert "sweep.compiles" not in reg.counters
        assert not [k for k in reg.histograms if k.startswith("compile.")]
        assert not any(e.name == "compile" for e in tr.events)
        rep = build_sweep_report(tr)
        assert rep.n_compiles == 0 and rep.compiles == {}
        assert rep.attribution["dispatch"]["count"] == 4   # 40 / 13 chunks


# ---------------------------------------------------------------------------
# checkpoint + serving instrumentation
# ---------------------------------------------------------------------------

class TestCheckpointTelemetry:

    def test_save_load_durations_sizes_and_gc_warning(self, tmp_path):
        state = {"front": np.arange(32).reshape(4, 8), "cursor": 7,
                 "tensor": torch.arange(6, dtype=torch.float32)}
        with Tracer(rss_interval_s=0) as tr:
            for step in (1, 2, 3):
                manager.save_state(str(tmp_path), step, state, keep=2,
                                   telemetry=tr)
            step, got = manager.load_state(str(tmp_path), telemetry=tr)
        assert step == 3 and got["cursor"] == 7
        np.testing.assert_array_equal(got["tensor"], np.arange(6.0))
        reg = tr.registry
        assert reg.histograms["checkpoint.save"].count == 3
        assert reg.histograms["checkpoint.load"].count == 1
        assert reg.histograms["checkpoint.bytes"].count == 4
        assert reg.histograms["checkpoint.bytes"].min > 0
        warns = [e for e in tr.events if e.name == "gc_removed"]
        assert len(warns) == 1                      # keep=2 removed step 1
        assert warns[0].args["level"] == "warning"
        assert warns[0].args["step"] == 1


class TestServeTelemetry:

    def test_engine_metrics(self):
        """The reference's counts, and the same tokens and logits as the
        run with telemetry off."""
        from repro_torch import convert
        from repro_torch.configs import reduced
        from repro_torch.models import transformer as T
        from repro_torch.serve import ServeEngine, check
        cfg = reduced("smollm-135m").replace(dtype="float32")
        params = convert.params_from_numpy(T.numpy_params(cfg, seed=0),
                                           "cpu")
        prompts = [np.arange(4) % cfg.vocab] * 4

        def serve(telemetry):
            eng = ServeEngine(cfg, T, params, batch_slots=2, max_len=64,
                              telemetry=telemetry)
            return check.record(eng, prompts, 3, lambda t: t.numpy())

        plain = serve(None)
        with Tracer(rss_interval_s=0) as tr:
            got = serve(tr)
        assert got["tokens"] == plain["tokens"]
        assert all(len(t) == 3 for t in got["tokens"])
        for a, b in zip(got["logits"], plain["logits"]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        reg = tr.registry
        assert reg.counters["serve.requests"].value == 4
        assert reg.counters["serve.tokens"].value == 12
        assert reg.histograms["serve.queue_s"].count == 4
        assert reg.histograms["serve.request_s"].count == 4
        assert reg.histograms["serve.prefill"].count >= 1
        assert reg.histograms["serve.decode"].count >= 1
        occ = reg.gauges["serve.slot_occupancy"]
        assert 0.0 <= occ.min and occ.max <= 1.0


# ---------------------------------------------------------------------------
# cross-package: one event schema, one JSONL format, one report layout
# ---------------------------------------------------------------------------

def _drive(tracer_cls, path):
    with tracer_cls(jsonl_path=path, rss_interval_s=0) as tr:
        with tr.span("decode", cat="sweep", track="main", chunk=3):
            pass
        tr.instant("gc_removed", cat="checkpoint", level="warning", step=1)
        tr.complete("chunk", 100, 300, cat="pipeline", track="shard1",
                    chunk=7)
        tr.gauge("pipeline.in_flight", 3)
        tr.counter("sweep.points", 16)
    return tr


class TestAgainstReference:

    def test_jsonl_and_events_match_the_reference(self, tmp_path):
        from repro.obs import Tracer as JaxTracer
        ours = _drive(Tracer, str(tmp_path / "port.jsonl"))
        ref = _drive(JaxTracer, str(tmp_path / "ref.jsonl"))
        strip = lambda d: {k: v for k, v in d.items()  # noqa: E731
                           if k not in ("ts_ns", "dur_ns", "tid", "pid")}
        lines = lambda p: [strip(json.loads(ln))  # noqa: E731
                           for ln in open(p)]
        assert lines(tmp_path / "port.jsonl") == lines(tmp_path / "ref.jsonl")
        assert [strip(e.as_dict()) for e in ours.events] == \
            [strip(e.as_dict()) for e in ref.events]
        assert sorted(ours.registry.as_dict()["counters"]) == \
            sorted(ref.registry.as_dict()["counters"])

    def test_report_layout_matches_the_reference(self):
        from repro.obs import Tracer as JaxTracer
        from repro.obs import build_sweep_report as jax_report
        reps = []
        for cls, build in ((Tracer, build_sweep_report),
                           (JaxTracer, jax_report)):
            tr = cls(rss_interval_s=0)
            t0 = tr.now_ns()
            tr.complete("decode", t0, t0 + int(2e8))
            tr.complete("dispatch", t0, t0 + int(3e8))
            tr.counter("sweep.points", 100)
            reps.append(build(tr, wall_s=1.0).as_dict())
        ours, ref = reps
        assert ours.keys() == ref.keys()
        assert ours["attribution"] == ref["attribution"]
        assert (ours["points"], ours["pts_per_s"], ours["n_compiles"]) == \
            (ref["points"], ref["pts_per_s"], ref["n_compiles"])
