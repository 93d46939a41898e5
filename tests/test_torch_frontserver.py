"""Pareto-front-as-a-service on the port
(``repro_torch.serve.frontserver``), mirroring
``tests/test_frontserver.py`` case by case: coalesced budget queries
over one shared chunk walk, mid-sweep joins with prefix replay, the warm
front cache and its persistence; every served front BIT-IDENTICAL
(indices, objectives, row order) to its standalone
``coexplore_front(budget=..., prune=False)`` sweep.  The deadline case
runs on an injected clock.

Cross-package: the responses of one coalesced walk against the
reference ``FrontServer``'s on the same queries (index sets, objectives
at rtol 1e-5), and the backend fingerprint of fits that differ in one
bit."""

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # CI images without hypothesis: deterministic fallback
    from _hypothesis_fallback import given, settings, st

from repro_torch.core import (Budget, BudgetColumns, ParetoArchive,
                              coexplore_front, enumerate_space,
                              fit_ppa_models)
from repro_torch.obs import Tracer
from repro_torch.serve import (DONE, EXPIRED, REJECTED, FrontCache,
                               FrontServer, backend_signature, budget_key)
from repro_torch.serve.frontserver import _front_rows

import _torch_scale_helpers as H
from _torch_scale_helpers import CPU, TINY_SPACE

CHUNK = 16

# The query mix the property test draws from: unconstrained (None and the
# inactive Budget), loose/mid/tight single bounds, multi-bound, a
# lower-bound pair, and an infeasible-everywhere envelope (empty front).
BUDGET_CHOICES = (
    None,
    Budget(),
    Budget(area_mm2=2.0),
    Budget(power_mw=250.0),
    Budget(area_mm2=1.0, min_accuracy=0.3),
    Budget(min_utilization=0.2),
    Budget(area_mm2=0.6),
    Budget(area_mm2=0.05),
)


def _active(b):
    return b if b is not None and b.active else None




def _active(b):
    return b if b is not None and b.active else None


@pytest.fixture(scope="module")
def tiny_models():
    return H.tiny_models()


@pytest.fixture(scope="module")
def ppa_models():
    return H.ppa_models()


@pytest.fixture(scope="module")
def oracle_refs(tiny_models):
    """Standalone constrained sweeps per budget choice — the bit-identity
    oracle every served front is compared against (prune=False: the
    frontserver's shared walk never config-prunes)."""
    return {i: coexplore_front(tiny_models, TINY_SPACE, chunk_size=CHUNK,
                               budget=_active(b), prune=False)
            for i, b in enumerate(BUDGET_CHOICES)}


def _assert_bitident(resp, ref):
    """Indices AND objectives, including row order."""
    np.testing.assert_array_equal(resp.archive.indices, ref.archive.indices)
    np.testing.assert_array_equal(resp.archive.objectives,
                                  ref.archive.objectives)


def _assert_stats_equal(got, ref):
    assert got.evaluated == ref.evaluated
    assert got.feasible == ref.feasible
    assert got.kills == ref.kills


class TestCoalescedBitIdentity:
    @given(picks=st.lists(st.integers(0, len(BUDGET_CHOICES) - 1),
                          min_size=1, max_size=5),
           join_step=st.integers(0, 6),
           warm=st.booleans())
    @settings(max_examples=12, deadline=None)
    def test_query_mixes_and_joins(self, tiny_models, oracle_refs, picks,
                                   join_step, warm):
        """Random query mixes, a mid-sweep joiner, warm or cold cache:
        every response bit-identical to its standalone sweep."""
        srv = FrontServer(tiny_models, TINY_SPACE, chunk_size=CHUNK)
        if warm:  # superset cached -> feasibility-covered budgets hit
            srv.query(None)
        first = srv.submit(BUDGET_CHOICES[picks[0]])
        for _ in range(join_step):
            srv.step()
        rest = [srv.submit(BUDGET_CHOICES[i]) for i in picks[1:]]
        srv.run()
        for q, i in zip([first] + rest, picks):
            assert q.state == DONE
            ref = oracle_refs[i]
            _assert_bitident(q.response, ref)
            if q.served_from in ("sweep", "join") \
                    and _active(BUDGET_CHOICES[i]) is not None:
                _assert_stats_equal(q.response.budget_stats,
                                    ref.budget_stats)

    def test_surrogate_backend(self, tiny_models, ppa_models):
        budgets = (Budget(area_mm2=2.0), Budget(power_mw=250.0), None)
        srv = FrontServer(tiny_models, TINY_SPACE, chunk_size=CHUNK,
                          surrogate=ppa_models)
        qs = [srv.submit(b) for b in budgets]
        srv.run()
        for q, b in zip(qs, budgets):
            ref = coexplore_front(tiny_models, TINY_SPACE, chunk_size=CHUNK,
                                  surrogate=ppa_models, budget=b,
                                  prune=False)
            _assert_bitident(q.response, ref)

    def test_per_model_walk_mode(self, tiny_models, oracle_refs):
        """mix_models=False plans the per-model chunk stream; fronts still
        match the standalone sweep (which is itself bit-identical across
        walk modes)."""
        srv = FrontServer(tiny_models, TINY_SPACE, chunk_size=CHUNK,
                          mix_models=False)
        resp = srv.query(Budget(area_mm2=2.0))
        _assert_bitident(resp, oracle_refs[2])

    def test_decoded_front_payload(self, tiny_models, oracle_refs):
        srv = FrontServer(tiny_models, TINY_SPACE, chunk_size=CHUNK)
        resp = srv.query(Budget(area_mm2=2.0))
        assert resp.decoded_front() == oracle_refs[2].decoded_front()


class TestCoalescingCost:
    def test_q_queries_cost_one_sweep(self, tiny_models, oracle_refs):
        """4 concurrent budgets admitted together evaluate each chunk
        exactly once — the per-query cost is the host-side mask + fold."""
        srv = FrontServer(tiny_models, TINY_SPACE, chunk_size=CHUNK)
        budgets = (None, Budget(area_mm2=2.0), Budget(power_mw=250.0),
                   Budget(area_mm2=0.6))
        qs = [srv.submit(b) for b in budgets]
        srv.run()
        n_chunks = sum(1 for _ in srv._plan.chunks())
        assert srv.chunk_evals == n_chunks  # one shared walk for all 4
        for q, i in zip(qs, (0, 2, 3, 6)):
            _assert_bitident(q.response, oracle_refs[i])

    def test_joiner_replays_prefix(self, tiny_models, oracle_refs):
        srv = FrontServer(tiny_models, TINY_SPACE, chunk_size=CHUNK)
        srv.submit(None)
        srv.step()
        srv.step()
        q = srv.submit(Budget(area_mm2=1.0, min_accuracy=0.3))
        srv.run()
        assert q.served_from == "join"
        n_chunks = sum(1 for _ in srv._plan.chunks())
        assert srv.chunk_evals == n_chunks  # the join added no evals
        _assert_bitident(q.response, oracle_refs[4])
        _assert_stats_equal(q.response.budget_stats,
                            oracle_refs[4].budget_stats)


class TestFrontCache:
    def test_repeat_hit_zero_evals(self, tiny_models, oracle_refs):
        srv = FrontServer(tiny_models, TINY_SPACE, chunk_size=CHUNK)
        first = srv.query(Budget(area_mm2=0.6))
        evals = srv.chunk_evals
        again = srv.query(Budget(area_mm2=0.6))
        assert srv.chunk_evals == evals  # zero chunk evaluations
        assert again.served_from == "cache:repeat"
        _assert_bitident(again, oracle_refs[6])
        # repeat hits replay the original run's stats too
        _assert_stats_equal(again.budget_stats, first.budget_stats)

    def test_superset_hit_when_front_feasible(self, tiny_models,
                                              oracle_refs):
        """A budget every superset-front row satisfies is served from the
        unconstrained archive — exact, because any point off that front
        is dominated by a feasible front point."""
        srv = FrontServer(tiny_models, TINY_SPACE, chunk_size=CHUNK)
        srv.query(None)
        evals = srv.chunk_evals
        loose = Budget(area_mm2=50.0)
        resp = srv.query(loose)
        assert srv.chunk_evals == evals
        assert resp.served_from == "cache:superset"
        assert resp.budget_stats is None  # nothing was ever masked
        ref = coexplore_front(tiny_models, TINY_SPACE, chunk_size=CHUNK,
                              budget=loose, prune=False)
        _assert_bitident(resp, ref)

    def test_tight_budget_misses_and_resweeps(self, tiny_models,
                                              oracle_refs):
        srv = FrontServer(tiny_models, TINY_SPACE, chunk_size=CHUNK)
        srv.query(None)
        evals = srv.chunk_evals
        resp = srv.query(Budget(area_mm2=0.6))  # kills superset-front rows
        assert resp.served_from == "sweep"
        assert srv.chunk_evals > evals
        _assert_bitident(resp, oracle_refs[6])

    def test_unconstrained_aliases(self, tiny_models):
        """None and a bound-free Budget() share the superset entry."""
        assert budget_key(None) == budget_key(Budget()) == "unconstrained"
        srv = FrontServer(tiny_models, TINY_SPACE, chunk_size=CHUNK)
        srv.query(None)
        evals = srv.chunk_evals
        resp = srv.query(Budget())
        assert resp.served_from == "cache:repeat"
        assert srv.chunk_evals == evals

    def test_lru_eviction(self):
        arch = ParetoArchive(3)
        arch.update(np.array([[1.0, 1.0, 1.0]]), np.array([0]))
        cache = FrontCache(capacity=2)
        sig = {"kind": "t"}
        cache.store(sig, None, arch, 1,
                    feas=BudgetColumns(*[np.ones(1)] * 5),
                    accuracy=np.ones(1))
        cache.store(sig, Budget(area_mm2=1.0), arch, 1)
        cache.store(sig, Budget(area_mm2=2.0), arch, 1)  # evicts superset
        assert len(cache) == 2
        assert cache.lookup(sig, None) is None
        hit = cache.lookup(sig, Budget(area_mm2=2.0))
        assert hit is not None and hit[0] == "repeat"
        # lookups refresh recency: touch area=2, store a third budget,
        # area=1 (now oldest) is the one evicted
        cache.store(sig, Budget(power_mw=9.0), arch, 1)
        assert cache.lookup(sig, Budget(area_mm2=1.0)) is None
        assert cache.lookup(sig, Budget(area_mm2=2.0)) is not None

    def test_signature_mismatch_rejected(self):
        arch = ParetoArchive(3)
        arch.update(np.array([[1.0, 1.0, 1.0]]), np.array([0]))
        cache = FrontCache()
        sig = {"kind": "t", "seed": 0}
        cache.store(sig, None, arch, 1)
        # doctor the stored signature: models a digest collision / stale
        # entry written by a different target under the same short key
        entry = next(iter(cache._entries.values()))
        entry.signature = {"kind": "t", "seed": 1}
        with pytest.raises(ValueError, match="different target"):
            cache.lookup(sig, None)

    def test_backend_fingerprint_separates_fits(self, tiny_models,
                                                ppa_models):
        """Two surrogate FITS share the registry name but not the cache
        key — and neither shares with the oracle."""
        from repro_torch.core import as_cost_model
        other = fit_ppa_models(enumerate_space(max_points=300, seed=2,
                                               device=CPU),
                               degrees=(1, 2), k=4, device=CPU)
        sig_a = backend_signature(as_cost_model(ppa_models))
        sig_b = backend_signature(as_cost_model(other))
        sig_o = backend_signature(as_cost_model(None))
        assert sig_a["name"] == sig_b["name"] == "surrogate"
        assert sig_a != sig_b
        assert sig_o["name"] == "oracle" and sig_o != sig_a
        srv_a = FrontServer(tiny_models, TINY_SPACE, chunk_size=CHUNK,
                            surrogate=ppa_models)
        srv_b = FrontServer(tiny_models, TINY_SPACE, chunk_size=CHUNK,
                            surrogate=other)
        assert srv_a.signature != srv_b.signature

    def test_front_rows_align_with_archive(self, tiny_models):
        """The superset entry's per-row budget columns are index-aligned
        with the archive (the superset-hit mask reads them row-wise)."""
        srv = FrontServer(tiny_models, TINY_SPACE, chunk_size=CHUNK)
        srv.submit(None)
        walk = None
        while srv._walk is None:
            srv.step()
        walk = srv._walk
        srv.run()
        feas, acc = _front_rows(walk.superset, walk.prefix)
        idx = walk.superset.indices
        lookup = {}
        for rec in walk.prefix:
            for j, i in enumerate(rec.idx):
                lookup[int(i)] = (rec.feas.area_mm2[j], rec.acc[j])
        for p, i in enumerate(idx):
            area, a = lookup[int(i)]
            assert feas.area_mm2[p] == area
            assert acc[p] == a


class TestChunkDominators:
    """The shared per-chunk domination prefilter the coalesced folds use
    must leave every archive bit-identical to the plain fold."""

    @given(seed=st.integers(0, 10_000), n=st.integers(1, 200),
           p_feasible=st.floats(0.0, 1.0))
    @settings(max_examples=25, deadline=None)
    def test_prefiltered_fold_is_exact(self, seed, n, p_feasible):
        from repro_torch.core import chunk_dominators, fold_budget_chunk
        rng = np.random.default_rng(seed)
        # duplicated rows + a small value alphabet force plenty of ties,
        # the regime where a sloppy (non-strict) domination test diverges
        obj = rng.integers(0, 4, size=(n, 3)).astype(np.float64)
        obj[rng.integers(0, n, size=n // 3 + 1)] = obj[0]
        mask = rng.random(n) < p_feasible

        class _Feas:  # duck-typed into Budget.feasibility via a stub
            pass

        class _MaskBudget:
            active = True

            def feasibility(self, result, accuracy=None):
                return mask.copy(), {}

        idx = np.arange(n, dtype=np.int64)
        plain, fast = ParetoArchive(3), ParetoArchive(3)
        fold_budget_chunk(plain, obj, idx, result=_Feas(),
                          budget=_MaskBudget())
        fold_budget_chunk(fast, obj, idx, result=_Feas(),
                          budget=_MaskBudget(), dom=chunk_dominators(obj))
        np.testing.assert_array_equal(plain.indices, fast.indices)
        np.testing.assert_array_equal(plain.objectives, fast.objectives)
        # unconstrained folds share the same prefilter
        plain_u, fast_u = ParetoArchive(3), ParetoArchive(3)
        fold_budget_chunk(plain_u, obj, idx)
        fold_budget_chunk(fast_u, obj, idx, dom=chunk_dominators(obj))
        np.testing.assert_array_equal(plain_u.indices, fast_u.indices)


class TestAdmissionPolicy:
    def test_bounded_queue_rejects(self, tiny_models):
        srv = FrontServer(tiny_models, TINY_SPACE, chunk_size=CHUNK,
                          max_queue=2)
        a, b = srv.submit(None), srv.submit(Budget(area_mm2=2.0))
        c = srv.submit(Budget(power_mw=250.0))
        assert c.state == REJECTED and c.response is None
        with pytest.raises(RuntimeError, match="queue full"):
            srv.query(None)
        srv.run()
        assert a.state == DONE and b.state == DONE

    def test_deadline_expires_before_admission(self, tiny_models,
                                               monkeypatch):
        """Deadlines against an injected clock (no sleeps, no load
        sensitivity): a query admitted past its deadline expires, one
        admitted within it is served."""
        import repro_torch.serve.frontserver as fs
        now = [100.0]

        def clock():          # every reading advances the clock 1 ms
            now[0] += 1e-3
            return now[0]

        monkeypatch.setattr(fs.time, "perf_counter", clock)
        srv = FrontServer(tiny_models, TINY_SPACE, chunk_size=CHUNK)
        q = srv.submit(Budget(area_mm2=2.0), deadline_s=0.5)
        ok = srv.submit(Budget(power_mw=250.0), deadline_s=5.0)
        now[0] += 1.0
        srv.run()
        assert q.state == EXPIRED and q.response is None
        assert ok.state == DONE
        with pytest.raises(TimeoutError):
            srv.query(None, deadline_s=0.0)

    def test_query_drains_synchronously(self, tiny_models, oracle_refs):
        srv = FrontServer(tiny_models, TINY_SPACE, chunk_size=CHUNK)
        resp = srv.query(Budget(area_mm2=2.0))
        _assert_bitident(resp, oracle_refs[2])


class TestTelemetry:
    def test_serving_histograms_and_counters(self, tiny_models,
                                             oracle_refs):
        with Tracer(rss_interval_s=0) as tr:
            srv = FrontServer(tiny_models, TINY_SPACE, chunk_size=CHUNK,
                              telemetry=tr)
            qs = [srv.submit(b) for b in (Budget(area_mm2=2.0), None)]
            srv.run()
            srv.query(Budget(area_mm2=2.0))  # cache repeat
        reg = tr.registry
        assert reg.histograms["serve.queue_s"].count == 3
        assert reg.histograms["serve.request_s"].count == 3
        assert reg.counters["serve.requests"].value == 3
        assert reg.counters["serve.front.queries"].value == 3
        assert reg.counters["serve.front.cache_hit"].value == 1
        assert reg.counters["serve.front.chunk_evals"].value == \
            srv.chunk_evals
        assert reg.counters["sweep.points"].value == 80
        # fronts are bit-identical with telemetry on
        _assert_bitident(qs[0].response, oracle_refs[2])
        _assert_bitident(qs[1].response, oracle_refs[0])


class TestCachePersistence:
    """FrontCache.save/load: warm fronts survive a process restart and
    serve repeat queries with zero chunk evaluations, signature-verified."""

    def test_round_trip_serves_cold_process(self, tiny_models, oracle_refs,
                                            tmp_path):
        d = str(tmp_path / "frontcache")
        srv = FrontServer(tiny_models, TINY_SPACE, chunk_size=CHUNK)
        b = BUDGET_CHOICES[2]
        q = srv.submit(b)
        srv.run()
        srv.cache.save(d)
        fresh = FrontServer(tiny_models, TINY_SPACE, chunk_size=CHUNK)
        assert fresh.cache.load(d) == len(srv.cache)
        resp = fresh.query(b)
        assert resp.served_from == "cache:repeat"
        assert fresh.chunk_evals == 0
        _assert_bitident(resp, oracle_refs[2])
        _assert_bitident(resp, q.response)

    def test_superset_hit_after_restore(self, tiny_models, tmp_path):
        d = str(tmp_path / "frontcache_sup")
        srv = FrontServer(tiny_models, TINY_SPACE, chunk_size=CHUNK)
        srv.query(None)  # stores the unconstrained superset + feas columns
        srv.cache.save(d)
        fresh = FrontServer(tiny_models, TINY_SPACE, chunk_size=CHUNK)
        fresh.cache.load(d)
        loose = Budget(area_mm2=50.0)  # every superset-front row feasible
        resp = fresh.query(loose)
        assert resp.served_from == "cache:superset"
        assert fresh.chunk_evals == 0
        ref = coexplore_front(tiny_models, TINY_SPACE, chunk_size=CHUNK,
                              budget=loose, prune=False)
        _assert_bitident(resp, ref)

    def test_load_empty_dir_is_noop(self, tiny_models, tmp_path):
        cache = FrontCache()
        assert cache.load(str(tmp_path / "nothing_here")) == 0
        assert len(cache) == 0

    def test_corrupted_signature_refuses(self, tiny_models, tmp_path):
        d = str(tmp_path / "frontcache_bad")
        srv = FrontServer(tiny_models, TINY_SPACE, chunk_size=CHUNK)
        srv.query(None)
        srv.cache.save(d)
        # tamper: re-file an entry under a key its signature can't produce
        victim = FrontCache()
        victim.load(d)
        (tkey, bkey), e = next(iter(victim._entries.items()))
        e.signature = dict(e.signature, kind="tampered")
        victim._entries[("0" * 16, bkey)] = e
        del victim._entries[(tkey, bkey)]
        victim.save(d)
        with pytest.raises(ValueError, match="corrupted"):
            FrontCache().load(d)

    def test_lru_capacity_enforced_on_load(self, tiny_models, tmp_path):
        d = str(tmp_path / "frontcache_cap")
        srv = FrontServer(tiny_models, TINY_SPACE, chunk_size=CHUNK)
        for b in (None, BUDGET_CHOICES[2], BUDGET_CHOICES[3]):
            srv.query(b)
        srv.cache.save(d)
        small = FrontCache(capacity=2)
        small.load(d)
        assert len(small) == 2


class TestAgainstReference:

    def test_coalesced_responses_match_jax(self, tiny_models):
        """One coalesced walk of each package over the same queries: the
        same fronts (index sets, objectives at rtol 1e-5), feasible
        counts and kills."""
        from repro.core import Budget as JBudget
        from repro.serve import FrontServer as JServer
        from repro_torch.coexplore_check import RTOL
        budgets = [b for b in BUDGET_CHOICES if _active(b) is not None]
        ours = FrontServer(tiny_models, TINY_SPACE, chunk_size=CHUNK)
        ref = JServer(H.jax_tiny_models(), TINY_SPACE, chunk_size=CHUNK)
        qs = [ours.submit(b) for b in budgets + [None]]
        rs = [ref.submit(None if b is None else JBudget(**b.spec()))
              for b in budgets + [None]]
        ours.run()
        ref.run()
        assert ours.chunk_evals == ref.chunk_evals
        for q, r in zip(qs, rs):
            H.assert_archive_close(q.response.archive, r.response.archive,
                                   RTOL)
            if q.response.budget_stats is not None:
                assert q.response.budget_stats.as_dict() == \
                    r.response.budget_stats.as_dict()

    def test_backend_signature_sees_one_bit(self, ppa_models):
        """The fingerprint hashes the host float32 bytes of the fitted
        parameters: a fit differing in one bit of one coefficient (as a
        CPU fit and a card fit may) gets another signature."""
        import copy
        from repro_torch.core import as_cost_model
        other = copy.deepcopy(ppa_models)
        other._params = other._cost_model = None
        m = other.models["int16"]["clock_ghz"]
        bits = m.coef.numpy().view(np.int32).copy()
        bits[0] ^= 1
        m.coef = torch.from_numpy(bits.view(np.float32))
        a = backend_signature(as_cost_model(ppa_models))
        b = backend_signature(as_cost_model(other))
        assert a["name"] == b["name"] and a != b
        assert backend_signature(as_cost_model(ppa_models)) == a
