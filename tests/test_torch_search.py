"""Budgeted search on the port (``repro_torch.core.search``), mirroring
``tests/test_search.py`` case by case: genome ops round-trip against
``space_points``, both drivers recover the enumerated
``coexplore_front`` front exactly when the budget spans the space
(both backends, pruned and unpruned), runs are bit-reproducible under a
fixed seed across shard counts, and driver state checkpoints and
resumes.  The reference's compile-count cases check instead that the
port reports no compile and, on a finished run, evaluates nothing.

Cross-package: the drivers propose exactly the reference's indices when
fed the same archives and screens, ``hypervolume`` and
``front_coverage`` equal the reference's exactly, and an end-to-end
search gives the reference's front while the archives agree."""

import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # CI images without hypothesis: deterministic fallback
    from _hypothesis_fallback import given, settings, st

from repro_torch.core import (Budget, EvolutionaryDriver, ParetoArchive,
                              SearchContext, SuccessiveHalvingDriver,
                              coexplore_front, front_coverage, hypervolume,
                              joint_digits, joint_indices, joint_radices,
                              joint_space_points, joint_space_size,
                              model_entry, resnet_cifar, search_driver,
                              search_front, space_points, transformer_gemm)
from repro_torch.core.arch import MAPPED_SPACE, MAPPING_CHOICES, space_radices
from repro_torch.core.search import ScreenResult
from repro_torch.obs import Tracer

import _torch_scale_helpers as H
from _torch_scale_helpers import CPU, TINY_SPACE, cpus

CHUNK = 32
N_MODELS = 3


@pytest.fixture(scope="module")
def tiny_models():
    return (model_entry(resnet_cifar(20, device=CPU)),
            model_entry(resnet_cifar(20, resolution=16, device=CPU)),
            model_entry(transformer_gemm(seq=128, d_model=128, n_layers=2,
                                         n_heads=4, d_ff=256, vocab=1024,
                                         device=CPU)))


@pytest.fixture(scope="module")
def jax_tiny_models():
    from repro.core import model_entry as j_entry
    from repro.core import resnet_cifar as j_resnet
    from repro.core import transformer_gemm as j_gemm
    return (j_entry(j_resnet(20)), j_entry(j_resnet(20, resolution=16)),
            j_entry(j_gemm(seq=128, d_model=128, n_layers=2, n_heads=4,
                           d_ff=256, vocab=1024)))


@pytest.fixture(scope="module")
def ppa_models():
    return H.ppa_models()


class TestGenomeOps:

    @given(seed=st.integers(0, 2**31 - 1))
    @settings(max_examples=20, deadline=None)
    def test_round_trip_and_decode_agreement(self, seed):
        rng = np.random.default_rng(seed)
        rad = joint_radices(TINY_SPACE, N_MODELS)
        n = joint_space_size(TINY_SPACE, N_MODELS)
        idx = rng.integers(0, n, size=64, dtype=np.int64)
        d = joint_digits(idx, rad)
        assert (d >= 0).all() and (d < rad[None, :]).all()
        np.testing.assert_array_equal(joint_indices(d, rad), idx)
        for i in (0, 17, 63):
            mid, cfg = joint_space_points(int(idx[i]), TINY_SPACE, N_MODELS,
                                          device=CPU)
            assert mid == d[i, 0]
            ref = space_points(idx[i] % joint_space_size(TINY_SPACE, 1),
                               TINY_SPACE, CPU)
            np.testing.assert_array_equal(cfg.pe_rows.numpy(),
                                          ref.pe_rows.numpy())

    @given(seed=st.integers(0, 2**31 - 1))
    @settings(max_examples=20, deadline=None)
    def test_mutated_crossed_digits_stay_valid(self, seed):
        rng = np.random.default_rng(seed)
        rad = joint_radices(TINY_SPACE, N_MODELS)
        n = joint_space_size(TINY_SPACE, N_MODELS)
        a = joint_digits(rng.integers(0, n, 32, dtype=np.int64), rad)
        b = joint_digits(rng.integers(0, n, 32, dtype=np.int64), rad)
        child = np.where(rng.random(a.shape) < 0.5, b, a)
        mut = rng.random(child.shape) < 0.3
        child = np.where(mut, rng.integers(0, rad[None, :], child.shape),
                         child)
        idx = joint_indices(child, rad)
        assert ((idx >= 0) & (idx < n)).all()
        uniq_digits = len({tuple(r) for r in child.tolist()})
        assert len(np.unique(idx)) == uniq_digits

    def test_out_of_bounds_digits_rejected(self):
        rad = joint_radices(TINY_SPACE, N_MODELS)
        bad = np.zeros((1, len(rad)), np.int64)
        bad[0, 0] = N_MODELS  # one past the model axis
        with pytest.raises(ValueError, match="out of range"):
            joint_indices(bad, rad)

    def test_mapping_axis_radices(self):
        assert space_radices(TINY_SPACE)[-1] == 1
        assert space_radices(MAPPED_SPACE)[-1] == MAPPING_CHOICES
        assert (joint_space_size(MAPPED_SPACE, 1)
                == MAPPING_CHOICES * joint_space_size(dict(MAPPED_SPACE,
                                                           mapping=(0.0,)), 1))


# Recovery must hold both when generation 0 sweeps the whole 120-point
# space (default population/rung exceed it) AND when the driver actually
# runs multi-generation crossover / halving rounds (population and rung
# far below the space) — the regime where child-dedup truncation once
# stranded visited-but-never-evaluated indices.  Factories, not shared
# instances: every test gets a fresh driver.
_RECOVERY_DRIVERS = {
    "evolve": lambda: "evolve",
    "halving": lambda: "halving",
    "evolve-pop30": lambda: EvolutionaryDriver(population=30),
    "halving-rung16": lambda: SuccessiveHalvingDriver(eta=2, rung=16),
}


def _assert_front_equal(got, ref):
    """Set-equality of joint indices + per-index objective equality."""
    gi, ri = got.archive.indices, ref.archive.indices
    assert set(gi.tolist()) == set(ri.tolist())
    np.testing.assert_array_equal(got.archive.objectives[np.argsort(gi)],
                                  ref.archive.objectives[np.argsort(ri)])


class TestFrontRecovery:
    """With max_evals >= the joint space size, each driver's front equals
    the enumerated coexplore_front exactly — indices and objectives —
    on both backends, pruned and unpruned."""

    @pytest.mark.parametrize("driver_spec", sorted(_RECOVERY_DRIVERS))
    def test_recovers_enumerated_front(self, tiny_models, driver_spec):
        n = joint_space_size(TINY_SPACE, len(tiny_models))
        ref = coexplore_front(tiny_models, TINY_SPACE, chunk_size=CHUNK)
        got = search_front(tiny_models, TINY_SPACE,
                           driver=_RECOVERY_DRIVERS[driver_spec](),
                           chunk_size=CHUNK, max_evals=n, seed=3)
        assert got.points_evaluated == n
        _assert_front_equal(got, ref)

    @pytest.mark.parametrize("seed", [0, 3, 4])
    def test_small_population_exhaustive_no_stranding(self, tiny_models,
                                                      seed):
        """Regression: child dedup used to mark ~2x oversampled children
        visited BEFORE truncating to the wanted batch, stranding the
        surplus — never evaluated, yet subtracted from the remaining
        space — so multi-generation runs stopped at 117-118/120 points
        on these very seeds.  With population << space, generations of
        crossover must still visit every point and equal enumeration."""
        n = joint_space_size(TINY_SPACE, len(tiny_models))
        ref = coexplore_front(tiny_models, TINY_SPACE, chunk_size=CHUNK)
        got = search_front(tiny_models, TINY_SPACE,
                           driver=EvolutionaryDriver(population=30),
                           chunk_size=CHUNK, max_evals=n, seed=seed)
        assert got.points_evaluated == n
        _assert_front_equal(got, ref)

    @pytest.mark.parametrize("driver_spec", sorted(_RECOVERY_DRIVERS))
    @pytest.mark.parametrize("prune", [False, True])
    def test_budgeted_recovery_both_prune_modes(self, tiny_models,
                                                driver_spec, prune):
        bud = Budget(area_mm2=60.0, min_accuracy=0.3)
        n = joint_space_size(TINY_SPACE, len(tiny_models))
        ref = coexplore_front(tiny_models, TINY_SPACE, chunk_size=CHUNK,
                              budget=bud, prune=prune)
        drv = search_driver(_RECOVERY_DRIVERS[driver_spec]())
        got = search_front(tiny_models, TINY_SPACE, driver=drv,
                           chunk_size=CHUNK, max_evals=n, seed=5, budget=bud)
        _assert_front_equal(got, ref)

    @pytest.mark.parametrize("driver_spec", sorted(_RECOVERY_DRIVERS))
    def test_recovery_on_surrogate_backend(self, tiny_models, ppa_models,
                                           driver_spec):
        n = joint_space_size(TINY_SPACE, len(tiny_models))
        ref = coexplore_front(tiny_models, TINY_SPACE, chunk_size=CHUNK,
                              surrogate=ppa_models)
        got = search_front(tiny_models, TINY_SPACE,
                           driver=_RECOVERY_DRIVERS[driver_spec](),
                           chunk_size=CHUNK, max_evals=n, seed=2,
                           surrogate=ppa_models)
        _assert_front_equal(got, ref)

    def test_compile_count_stays_at_bucket_count(self, tiny_models):
        """The reference counts XLA compiles here (none after the
        enumerated walk).  The port compiles nothing: a traced search
        reports no compile event, and its evaluations go through the
        walk's chunk evaluator one bucketed chunk at a time."""
        n = joint_space_size(TINY_SPACE, len(tiny_models))
        ref = coexplore_front(tiny_models, TINY_SPACE, chunk_size=CHUNK)
        assert len(ref.buckets) >= 1
        for driver, kw in (("evolve", dict(max_evals=n, seed=11)),
                           ("halving", dict(max_evals=60, seed=12,
                                            budget=Budget(area_mm2=60.0)))):
            with Tracer(rss_interval_s=0) as tr:
                got = search_front(tiny_models, TINY_SPACE, driver=driver,
                                   chunk_size=CHUNK, telemetry=tr, **kw)
            reg = tr.registry
            assert "sweep.compiles" not in reg.counters
            assert not [k for k in reg.histograms
                        if k.startswith("compile.")]
            assert reg.counters["search.evals"].value == \
                got.points_evaluated > 0

    def test_partial_budget_front_is_subset_quality(self, tiny_models):
        """A 50%-budget run yields a front whose points all lie on or
        inside the true front's dominated region (its archive only ever
        saw real evaluations), with sane hypervolume/coverage."""
        n = joint_space_size(TINY_SPACE, len(tiny_models))
        ref = coexplore_front(tiny_models, TINY_SPACE, chunk_size=CHUNK)
        got = search_front(tiny_models, TINY_SPACE, driver="evolve",
                           chunk_size=CHUNK, max_evals=n // 2, seed=0)
        assert got.points_evaluated == n // 2
        robj = ref.archive.objectives
        ref_pt = robj.min(axis=0) - 1.0
        hv_ref = hypervolume(robj, ref_pt)
        hv_got = hypervolume(got.archive.objectives, ref_pt)
        assert 0.0 < hv_got <= hv_ref + 1e-9
        cov = front_coverage(got.archive.objectives, robj)
        assert 0.0 < cov <= 1.0


class TestDeterminism:
    @pytest.mark.parametrize("driver_name", ["evolve", "halving"])
    def test_bit_reproducible_across_shard_counts(self, tiny_models,
                                                  driver_name):
        runs = []
        for shards in (None, 2, 8):
            kw = {} if shards is None else dict(shards=shards,
                                                devices=cpus(shards))
            f = search_front(tiny_models, TINY_SPACE, driver=driver_name,
                             chunk_size=CHUNK, max_evals=80, seed=7,
                             budget=Budget(area_mm2=60.0), **kw)
            runs.append(f)
        for f in runs[1:]:
            np.testing.assert_array_equal(runs[0].archive.indices,
                                          f.archive.indices)
            np.testing.assert_array_equal(runs[0].archive.objectives,
                                          f.archive.objectives)
            assert runs[0].points_evaluated == f.points_evaluated

    def test_same_seed_same_front_surrogate(self, tiny_models, ppa_models):
        a = search_front(tiny_models, TINY_SPACE, driver="evolve",
                         chunk_size=CHUNK, max_evals=60, seed=9,
                         surrogate=ppa_models)
        b = search_front(tiny_models, TINY_SPACE, driver="evolve",
                         chunk_size=CHUNK, max_evals=60, seed=9,
                         surrogate=ppa_models)
        np.testing.assert_array_equal(a.archive.indices, b.archive.indices)
        np.testing.assert_array_equal(a.archive.objectives,
                                      b.archive.objectives)

    def test_coexplore_driver_kwarg_delegates(self, tiny_models):
        n = joint_space_size(TINY_SPACE, len(tiny_models))
        via_kwarg = coexplore_front(tiny_models, TINY_SPACE,
                                    chunk_size=CHUNK, driver="evolve",
                                    max_points=n, seed=3)
        direct = search_front(tiny_models, TINY_SPACE, driver="evolve",
                              chunk_size=CHUNK, max_evals=n, seed=3)
        np.testing.assert_array_equal(via_kwarg.archive.indices,
                                      direct.archive.indices)


class TestCheckpointResume:
    def test_resume_extends_eval_budget(self, tiny_models, tmp_path):
        d = str(tmp_path / "search_ckpt")
        half = search_front(tiny_models, TINY_SPACE, driver="evolve",
                            chunk_size=CHUNK, max_evals=45, seed=5,
                            checkpoint_dir=d, checkpoint_every=1)
        assert half.points_evaluated == 45
        full = search_front(tiny_models, TINY_SPACE, driver="evolve",
                            chunk_size=CHUNK, max_evals=90, seed=5,
                            checkpoint_dir=d, checkpoint_every=1)
        assert full.points_evaluated == 90
        # the resumed half never re-evaluates: its visited set carried over
        assert set(half.archive.indices.tolist()) <= set(
            np.arange(joint_space_size(TINY_SPACE, len(tiny_models)))
            .tolist())

    def test_finished_run_replays_without_reevaluating(self, tiny_models,
                                                       tmp_path):
        d = str(tmp_path / "search_done")
        a = search_front(tiny_models, TINY_SPACE, driver="halving",
                         chunk_size=CHUNK, max_evals=60, seed=4,
                         checkpoint_dir=d, checkpoint_every=1)
        # the reference checks no recompile; the port checks that the
        # finished run is replayed from its checkpoint, evaluating nothing
        with Tracer(rss_interval_s=0) as tr:
            b = search_front(tiny_models, TINY_SPACE, driver="halving",
                             chunk_size=CHUNK, max_evals=60, seed=4,
                             checkpoint_dir=d, checkpoint_every=1,
                             telemetry=tr)
        assert "sweep.dispatch" not in tr.registry.histograms
        assert "search.evals" not in tr.registry.counters
        assert b.points_evaluated == a.points_evaluated
        np.testing.assert_array_equal(a.archive.indices, b.archive.indices)
        np.testing.assert_array_equal(a.archive.objectives,
                                      b.archive.objectives)

    def test_signature_mismatch_refuses(self, tiny_models, tmp_path):
        d = str(tmp_path / "search_sig")
        search_front(tiny_models, TINY_SPACE, driver="evolve",
                     chunk_size=CHUNK, max_evals=40, seed=5,
                     checkpoint_dir=d, checkpoint_every=1)
        with pytest.raises(ValueError, match="different sweep"):
            search_front(tiny_models, TINY_SPACE, driver="halving",
                         chunk_size=CHUNK, max_evals=40, seed=5,
                         checkpoint_dir=d, checkpoint_every=1)


class TestFrontMetrics:
    def test_hypervolume_2d_known_value(self):
        obj = np.array([[2.0, 1.0], [1.0, 2.0]])
        # two unit-overlapping squares above (0, 0): 2*1 + 1*2 - 1*1 = 3
        assert hypervolume(obj, np.zeros(2)) == pytest.approx(3.0)

    def test_hypervolume_3d_known_value(self):
        obj = np.array([[1.0, 1.0, 1.0]])
        assert hypervolume(obj, np.zeros(3)) == pytest.approx(1.0)
        two = np.array([[2.0, 1.0, 1.0], [1.0, 2.0, 1.0]])
        # union of 2x1x1 and 1x2x1 boxes sharing a 1x1x1 corner
        assert hypervolume(two, np.zeros(3)) == pytest.approx(3.0)

    def test_hypervolume_ignores_points_below_ref(self):
        obj = np.array([[1.0, 1.0, 1.0], [-1.0, 5.0, 5.0]])
        assert hypervolume(obj, np.zeros(3)) == pytest.approx(1.0)

    def test_front_coverage(self):
        ref = np.array([[1.0, 1.0], [2.0, 0.5]])
        assert front_coverage(ref, ref) == 1.0
        assert front_coverage(np.array([[2.0, 1.0]]), ref) == 1.0
        assert front_coverage(np.array([[0.5, 0.5]]), ref) == 0.0
        assert front_coverage(np.empty((0, 2)), ref) == 0.0
        assert front_coverage(np.empty((0, 2)), np.empty((0, 2))) == 1.0


class TestDriverValidation:
    def test_unknown_name(self):
        with pytest.raises(ValueError, match="unknown search driver"):
            search_driver("anneal")

    def test_bad_params(self):
        with pytest.raises(ValueError):
            EvolutionaryDriver(population=0)
        with pytest.raises(ValueError):
            EvolutionaryDriver(mutation=0.0)
        with pytest.raises(ValueError):
            SuccessiveHalvingDriver(eta=1)

    @pytest.mark.parametrize("kwargs", [dict(csv_path="front.csv"),
                                        dict(max_chunks=3),
                                        dict(mix_models=False)])
    def test_driver_rejects_enumeration_only_kwargs(self, tiny_models,
                                                    kwargs):
        """coexplore_front(driver=...) must refuse the enumeration-cursor
        knobs it cannot honor, not silently drop them."""
        with pytest.raises(ValueError, match="incompatible"):
            coexplore_front(tiny_models, TINY_SPACE, chunk_size=CHUNK,
                            driver="evolve", **kwargs)

    def test_state_dict_name_guard(self):
        d = EvolutionaryDriver()
        d.reset_args = None
        from repro_torch.core import SearchContext  # noqa: F401
        with pytest.raises(ValueError, match="driver state"):
            d.restore_state(dict(name="halving", generation=0,
                                 rng={}, visited=[]))


# ---------------------------------------------------------------------------
# Cross-package: the reference's drivers and metrics on the same inputs
# ---------------------------------------------------------------------------

def _screen(n_models, accel):
    """A deterministic numpy screen (a function of the index only), the
    same for both packages' halving drivers."""
    def screen(idx):
        idx = np.asarray(idx, np.int64)
        h = (idx * 2654435761) % 1000003 / 1000003.0
        proxy = np.stack([h, np.sin(idx * 0.37), -np.cos(idx * 0.11)], -1)
        return ScreenResult(feasible=(idx % 7) != 3, proxy=proxy,
                            area_mm2=1.0 + h)
    return screen


class TestAgainstReference:

    @pytest.mark.parametrize("kind", ["evolve", "evolve-pop30", "halving",
                                      "halving-rung16"])
    def test_proposals_exact_on_shared_archives(self, kind):
        """Fed the same context, archives and observations (numpy), both
        packages' drivers propose the same indices, generation after
        generation, and end in the same state."""
        import repro.core.search as J
        make = {"evolve": lambda m: m.EvolutionaryDriver(),
                "evolve-pop30": lambda m: m.EvolutionaryDriver(population=30),
                "halving": lambda m: m.SuccessiveHalvingDriver(),
                "halving-rung16": lambda m: m.SuccessiveHalvingDriver(
                    eta=2, rung=16)}[kind]
        import repro_torch.core.search as P
        space = dict(TINY_SPACE, pe_rows=(8, 12, 16, 24))
        accel = int(np.prod(space_radices(space)))
        n_models = 3
        rng = np.random.default_rng(0)
        acc = rng.random((n_models, 5))
        drivers = []
        for mod, ctx_cls in ((P, SearchContext), (J, J.SearchContext)):
            d = make(mod)
            d.reset(ctx_cls(space=space, num_models=n_models,
                            accel_size=accel,
                            total_points=n_models * accel, max_evals=200,
                            seed=4, acc_matrix=acc,
                            screen=_screen(n_models, accel)))
            drivers.append(d)
        from repro.core import ParetoArchive as JArchive
        archives = (ParetoArchive(3), JArchive(3))
        remaining = 200
        while remaining > 0:
            props = [d.propose(a, remaining)
                     for d, a in zip(drivers, archives)]
            np.testing.assert_array_equal(props[0], props[1])
            if not len(props[0]):
                break
            obj = np.stack([np.cos(props[0] * 0.01), np.sin(props[0] * 0.3),
                            -(props[0] % 11.0)], -1)
            for d, a in zip(drivers, archives):
                a.update(obj, props[0])
                d.observe(props[0], obj, np.ones(len(obj), bool))
            remaining -= len(props[0])
        ours, ref = drivers[0].state_dict(), drivers[1].state_dict()
        assert ours["rng"] == ref["rng"]
        np.testing.assert_array_equal(ours["visited"], ref["visited"])

    @given(seed=st.integers(0, 2**31 - 1))
    @settings(max_examples=10, deadline=None)
    def test_front_metrics_exact(self, seed):
        from repro.core import front_coverage as j_cov
        from repro.core import hypervolume as j_hv
        rng = np.random.default_rng(seed)
        for d in (2, 3):
            obj = rng.random((int(rng.integers(1, 30)), d))
            ref_pt = np.full(d, -0.1) if d == 2 else rng.random(d) * 0.2
            assert hypervolume(obj, ref_pt) == j_hv(obj, ref_pt)
            other = rng.random((int(rng.integers(0, 20)), d))
            assert front_coverage(other, obj) == j_cov(other, obj)

    @pytest.mark.parametrize("driver", ["evolve", "halving"])
    def test_search_front_matches_jax(self, tiny_models, jax_tiny_models,
                                      driver):
        """A half-budget search end to end: the same evaluated points and
        the reference's front (index set; objectives at rtol 1e-5), as
        long as no near tie reorders the archives."""
        from repro.core import search_front as j_search
        from repro_torch.coexplore_check import RTOL
        n = joint_space_size(TINY_SPACE, N_MODELS)
        kw = dict(driver=driver, chunk_size=CHUNK, max_evals=n // 2, seed=1)
        ref = j_search(jax_tiny_models, TINY_SPACE, **kw)
        got = search_front(tiny_models, TINY_SPACE, **kw)
        assert got.points_evaluated == ref.points_evaluated
        H.assert_archive_close(got.archive, ref.archive, RTOL)


class TestReferenceFile:
    """``tests/data/torch_scale_ref.json`` (written by
    ``tests/_torch_scale_ref.py`` with the JAX package, read by
    ``chip_smoke.py`` phase 9) has the layout and settings the smoke
    expects."""

    def test_layout_and_settings(self):
        import json
        from _torch_scale_ref import REF_PATH
        from repro_torch import scale_check as S
        from repro_torch.core import default_model_set
        ref = json.loads(REF_PATH.read_text())
        assert ref["models"] == [m.name for m in default_model_set(
            device=CPU)]
        assert ref["ref_space"]["points_evaluated"] == 486_000
        assert set(ref["search"]) == set(S.DRIVERS)
        for run in ref["search"].values():
            assert run["points_evaluated"] == S.SEARCH_EVALS
            assert sum(g["proposed"] for g in run["log"]) == S.SEARCH_EVALS
            assert 0.0 < run["hv_ratio"] and 0.0 <= run["coverage"] <= 1.0
        storm = ref["storm"]
        assert [r["budget"] for r in storm["responses"]] == \
            list(S.DISTINCT_BUDGETS)
        assert all(r["points_evaluated"] == 351_000
                   for r in storm["responses"])

    def test_recorder_is_a_driver_of_both_packages(self, tiny_models):
        """The smoke wraps the drivers in ``scale_check.Recorder``: it
        passes both packages' driver checks and leaves the run as it
        was."""
        import repro.core.search as J
        import repro_torch.core.search as P
        from repro_torch import scale_check as S
        assert isinstance(S.Recorder(P.EvolutionaryDriver()), P.SearchDriver)
        assert isinstance(S.Recorder(J.EvolutionaryDriver()), J.SearchDriver)
        kw = dict(chunk_size=CHUNK, max_evals=60, seed=3)
        rec = S.Recorder(P.EvolutionaryDriver(population=30))
        got = search_front(tiny_models, TINY_SPACE, driver=rec, **kw)
        want = search_front(tiny_models, TINY_SPACE,
                            driver=P.EvolutionaryDriver(population=30), **kw)
        np.testing.assert_array_equal(got.archive.indices,
                                      want.archive.indices)
        assert sum(g["proposed"] for g in rec.log) == 60
        problems, notes = S.compare_search(
            dict(log=rec.log, front=S.front_data(got.archive),
                 points_evaluated=60, hv_ratio=1.0, coverage=1.0),
            dict(log=rec.log, front=S.front_data(want.archive),
                 points_evaluated=60, hv_ratio=1.0, coverage=1.0))
        assert problems == [] and notes == []
