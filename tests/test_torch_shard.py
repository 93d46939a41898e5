"""The port's sharded, pipelined and checkpointed walks
(``repro_torch.core.shard``), mirroring ``tests/test_shard.py`` case by
case: sharded == single-process on all three walks (with and without
budgets, two-stage pruning, both backends), pipeline depth invariance,
kill / resume exactness, the template-free state checkpoints, and the
shared PPA design matrix with its per-target fallback.  Shards run on
``devices=["cpu"] * k`` here (the card tests, ``test_torch_scale_gpu.py``,
give each shard its own CUDA stream).

Cross-package: the port's fronts against the JAX package's (index sets,
objectives at rtol 1e-5), ``save_state`` files read by the other
package in both directions, equal space / workload signatures and CSV
fronts, and the per-target PPA fallback against the reference's
predictions at rtol 1e-6."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # CI images without hypothesis: deterministic fallback
    from _hypothesis_fallback import given, settings, st

from repro_torch.checkpoint import manager
from repro_torch.coexplore_check import RTOL
from repro_torch.core import (Budget, BudgetStats, ParetoArchive, WIDE_SPACE,
                              coexplore_front, enumerate_space,
                              evaluate_space_streaming, export_front_csv,
                              merge_archives, pareto_front_streaming,
                              resolve_shards, space_size,
                              workloads_signature)
from repro_torch.core.ppa import (PPAModels, config_features, design_matrix,
                                  fit_poly, monomial_exponents,
                                  surrogate_ppa)
from repro_torch.core.shard import _resolve_for, space_signature

import _torch_scale_helpers as H
from _torch_scale_helpers import CHUNK, CPU, METRICS, TINY_SPACE, cpus

SHARD_COUNTS = (1, 2, 8)
BUDGET = Budget(area_mm2=60.0, power_mw=1e5)
_assert_archives_equal = H.assert_archives_equal


@pytest.fixture(scope="module")
def workload():
    return H.workload()


@pytest.fixture(scope="module")
def tiny_models():
    return H.tiny_models()


@pytest.fixture(scope="module")
def ppa_models():
    return H.ppa_models()


def _sh(k):
    return dict(shards=k, devices=cpus(k))


# ---------------------------------------------------------------------------
# Sharded == single-process, bit-identically, on all three walks
# ---------------------------------------------------------------------------

class TestShardedPlainWalk:

    @pytest.mark.parametrize("shards", SHARD_COUNTS)
    def test_front_bit_identical(self, workload, shards):
        ref, _ = pareto_front_streaming(workload, TINY_SPACE,
                                        chunk_size=CHUNK, metrics=METRICS)
        got, _ = pareto_front_streaming(workload, TINY_SPACE,
                                        chunk_size=CHUNK, metrics=METRICS,
                                        **_sh(shards))
        _assert_archives_equal(ref, got)

    @pytest.mark.parametrize("prune", [True, False])
    @pytest.mark.parametrize("shards", SHARD_COUNTS)
    def test_budget_walks_match_with_stats(self, workload, shards, prune):
        s_ref, s_got = BudgetStats(), BudgetStats()
        ref, _ = pareto_front_streaming(
            workload, TINY_SPACE, chunk_size=CHUNK, metrics=METRICS,
            budget=BUDGET, budget_stats=s_ref, prune=prune)
        got, _ = pareto_front_streaming(
            workload, TINY_SPACE, chunk_size=CHUNK, metrics=METRICS,
            budget=BUDGET, budget_stats=s_got, prune=prune, **_sh(shards))
        _assert_archives_equal(ref, got)
        assert s_ref.as_dict() == s_got.as_dict()

    def test_surrogate_backend(self, workload, ppa_models):
        ref, _ = pareto_front_streaming(workload, TINY_SPACE,
                                        chunk_size=CHUNK, metrics=METRICS,
                                        surrogate=ppa_models)
        got, _ = pareto_front_streaming(workload, TINY_SPACE,
                                        chunk_size=CHUNK, metrics=METRICS,
                                        surrogate=ppa_models, **_sh(8))
        _assert_archives_equal(ref, got)

    def test_subsampled_point_set_shared(self, workload):
        ref, _ = pareto_front_streaming(workload, TINY_SPACE,
                                        chunk_size=CHUNK, metrics=METRICS,
                                        max_points=25, seed=7)
        got, _ = pareto_front_streaming(workload, TINY_SPACE,
                                        chunk_size=CHUNK, metrics=METRICS,
                                        max_points=25, seed=7, **_sh(2))
        _assert_archives_equal(ref, got)

    @given(depth=st.integers(min_value=1, max_value=4))
    @settings(max_examples=4, deadline=None)
    def test_pipeline_depth_invariant(self, workload, depth):
        ref, _ = pareto_front_streaming(workload, TINY_SPACE,
                                        chunk_size=CHUNK, metrics=METRICS)
        got, _ = pareto_front_streaming(workload, TINY_SPACE,
                                        chunk_size=CHUNK, metrics=METRICS,
                                        pipeline_depth=depth, **_sh(2))
        _assert_archives_equal(ref, got)

    def test_streaming_generator_matches(self, workload):
        def collect(**kw):
            rows = {}
            for res, idx in evaluate_space_streaming(
                    workload, TINY_SPACE, chunk_size=CHUNK, **kw):
                for j, i in enumerate(np.asarray(idx)):
                    rows[int(i)] = (float(res.latency_s[j]),
                                    float(res.energy_j[j]),
                                    float(res.area_mm2[j]))
            return rows
        assert collect() == collect(**_sh(4))
        s_ref, s_got = BudgetStats(), BudgetStats()
        assert (collect(budget=BUDGET, budget_stats=s_ref)
                == collect(budget=BUDGET, budget_stats=s_got, **_sh(3)))
        assert s_ref.as_dict() == s_got.as_dict()


class TestShardedJointWalks:

    @pytest.mark.parametrize("mix", [True, False])
    @pytest.mark.parametrize("shards", SHARD_COUNTS)
    def test_front_and_aggregates_match(self, tiny_models, shards, mix):
        ref = coexplore_front(tiny_models, TINY_SPACE, chunk_size=CHUNK,
                              mix_models=mix)
        got = coexplore_front(tiny_models, TINY_SPACE, chunk_size=CHUNK,
                              mix_models=mix, **_sh(shards))
        _assert_archives_equal(ref.archive, got.archive)
        assert ref.per_model_best == got.per_model_best
        assert ref.points_evaluated == got.points_evaluated
        assert ref.buckets == got.buckets

    @pytest.mark.parametrize("prune", [True, False])
    @pytest.mark.parametrize("mix", [True, False])
    def test_constrained_walks_match(self, tiny_models, mix, prune):
        bud = Budget(area_mm2=60.0, power_mw=1e5, min_accuracy=0.3)
        ref = coexplore_front(tiny_models, TINY_SPACE, chunk_size=CHUNK,
                              mix_models=mix, budget=bud, prune=prune)
        got = coexplore_front(tiny_models, TINY_SPACE, chunk_size=CHUNK,
                              mix_models=mix, budget=bud, prune=prune,
                              **_sh(4))
        _assert_archives_equal(ref.archive, got.archive)
        assert ref.per_model_best == got.per_model_best
        assert (ref.budget_stats.as_dict() == got.budget_stats.as_dict())

    def test_surrogate_joint(self, tiny_models, ppa_models):
        ref = coexplore_front(tiny_models, TINY_SPACE, chunk_size=CHUNK,
                              surrogate=ppa_models, max_points=150, seed=3)
        got = coexplore_front(tiny_models, TINY_SPACE, chunk_size=CHUNK,
                              surrogate=ppa_models, max_points=150, seed=3,
                              **_sh(8))
        _assert_archives_equal(ref.archive, got.archive)
        assert ref.per_model_best == got.per_model_best


# ---------------------------------------------------------------------------
# Durability: kill/resume reproduces the uninterrupted front exactly
# ---------------------------------------------------------------------------

class TestCheckpointResume:

    @given(kill_after=st.integers(min_value=1, max_value=4))
    @settings(max_examples=4, deadline=None)
    def test_plain_walk_resume(self, workload, tmp_path_factory, kill_after):
        """Resumed == uninterrupted at the same shard count, row order
        included."""
        ref, _ = pareto_front_streaming(workload, TINY_SPACE,
                                        chunk_size=CHUNK, metrics=METRICS,
                                        **_sh(2))
        ck = str(tmp_path_factory.mktemp("ck") / "walk")
        pareto_front_streaming(workload, TINY_SPACE, chunk_size=CHUNK,
                               metrics=METRICS, checkpoint_dir=ck,
                               checkpoint_every=1, max_chunks=kill_after,
                               **_sh(2))
        n_chunks = -(-space_size(TINY_SPACE) // CHUNK)
        assert manager.latest_step(ck) == min(kill_after, n_chunks)
        got, _ = pareto_front_streaming(workload, TINY_SPACE,
                                        chunk_size=CHUNK, metrics=METRICS,
                                        checkpoint_dir=ck,
                                        checkpoint_every=1, **_sh(2))
        H.assert_archives_identical(ref, got)

    def test_double_kill_then_resume(self, workload, tmp_path):
        ref, _ = pareto_front_streaming(workload, TINY_SPACE,
                                        chunk_size=CHUNK, metrics=METRICS,
                                        budget=BUDGET)
        ck = str(tmp_path / "ck")
        for _ in range(2):
            pareto_front_streaming(workload, TINY_SPACE, chunk_size=CHUNK,
                                   metrics=METRICS, budget=BUDGET,
                                   checkpoint_dir=ck, checkpoint_every=1,
                                   max_chunks=1, **_sh(2))
        s_got = BudgetStats()
        got, _ = pareto_front_streaming(workload, TINY_SPACE,
                                        chunk_size=CHUNK, metrics=METRICS,
                                        budget=BUDGET, budget_stats=s_got,
                                        checkpoint_dir=ck,
                                        checkpoint_every=1, **_sh(2))
        _assert_archives_equal(ref, got)
        s_ref = BudgetStats()
        pareto_front_streaming(workload, TINY_SPACE, chunk_size=CHUNK,
                               metrics=METRICS, budget=BUDGET,
                               budget_stats=s_ref)
        assert s_ref.as_dict() == s_got.as_dict()

    @pytest.mark.parametrize("mix", [True, False])
    def test_joint_pruned_resume(self, tiny_models, tmp_path, mix):
        """Mid-walk kill of the constrained PRUNED joint walk: survivor
        buffers, per-(model, PE) bests, counters and kill counts come
        back bit-exactly."""
        bud = Budget(area_mm2=60.0, power_mw=1e5, min_accuracy=0.3)
        ref = coexplore_front(tiny_models, TINY_SPACE, chunk_size=CHUNK,
                              mix_models=mix, budget=bud)
        ck = str(tmp_path / "ck")
        coexplore_front(tiny_models, TINY_SPACE, chunk_size=CHUNK,
                        mix_models=mix, budget=bud, checkpoint_dir=ck,
                        checkpoint_every=1, max_chunks=3, **_sh(2))
        got = coexplore_front(tiny_models, TINY_SPACE, chunk_size=CHUNK,
                              mix_models=mix, budget=bud, checkpoint_dir=ck,
                              checkpoint_every=1, **_sh(2))
        _assert_archives_equal(ref.archive, got.archive)
        assert ref.per_model_best == got.per_model_best
        assert ref.points_evaluated == got.points_evaluated
        assert ref.budget_stats.as_dict() == got.budget_stats.as_dict()

    def test_signature_mismatch_rejected(self, workload, tmp_path):
        ck = str(tmp_path / "ck")
        pareto_front_streaming(workload, TINY_SPACE, chunk_size=CHUNK,
                               metrics=METRICS, checkpoint_dir=ck,
                               checkpoint_every=1, max_chunks=1, **_sh(2))
        with pytest.raises(ValueError, match="different sweep"):
            pareto_front_streaming(workload, TINY_SPACE, chunk_size=CHUNK,
                                   metrics=METRICS, checkpoint_dir=ck,
                                   **_sh(4))

    def test_csv_export(self, workload, tmp_path):
        csv_path = str(tmp_path / "front.csv")
        archive, _ = pareto_front_streaming(workload, TINY_SPACE,
                                            chunk_size=CHUNK,
                                            metrics=METRICS,
                                            csv_path=csv_path, **_sh(2))
        lines = open(csv_path).read().splitlines()
        assert lines[0].startswith("index,perf_per_area,neg_energy_j,"
                                   "pe_type_name,")
        assert len(lines) == 1 + len(archive.indices)
        first = lines[1].split(",")
        assert int(first[0]) in set(np.asarray(archive.indices))


class TestStateRoundTrips:

    def test_save_load_state(self, tmp_path):
        state = dict(cursor=5,
                     arr=np.arange(6, dtype=np.int64).reshape(2, 3),
                     nested=[dict(x=np.float64(1.5), s="str", b=True,
                                  none=None), [1, 2.5]])
        manager.save_state(str(tmp_path), 5, state)
        step, back = manager.load_state(str(tmp_path))
        assert step == 5
        assert back["cursor"] == 5
        np.testing.assert_array_equal(back["arr"], state["arr"])
        assert back["arr"].dtype == np.int64
        assert back["nested"][0] == dict(x=1.5, s="str", b=True, none=None)
        assert back["nested"][1] == [1, 2.5]

    def test_save_state_keep_k(self, tmp_path):
        for step in range(5):
            manager.save_state(str(tmp_path), step, dict(step=step), keep=2)
        assert manager.all_steps(str(tmp_path)) == [3, 4]

    def test_reserved_key_rejected(self, tmp_path):
        with pytest.raises(ValueError, match="reserved"):
            manager.save_state(str(tmp_path), 0, {"__npy__": 1})

    def test_archive_state_round_trip(self):
        a = ParetoArchive(2)
        a.update(np.array([[1.0, 0.0], [0.0, 1.0], [0.5, 0.5]]),
                 np.array([3, 7, 9]))
        b = ParetoArchive.from_state(a.state_dict())
        _assert_archives_equal(a, b)
        assert b._seen == a._seen
        b.update(np.array([[2.0, 2.0]]), np.array([11]))
        assert list(np.sort(b.indices)) == [11]

    def test_merge_archives_pure_and_exact(self):
        rng = np.random.default_rng(0)
        obj = rng.random((40, 2))
        full = ParetoArchive(2)
        full.update(obj, np.arange(40))
        parts = []
        for s in range(4):
            p = ParetoArchive(2)
            p.update(obj[s::4], np.arange(40)[s::4])
            parts.append(p)
        sizes = [len(p.indices) for p in parts]
        merged = merge_archives(parts, 2)
        _assert_archives_equal(full, merged)
        assert [len(p.indices) for p in parts] == sizes  # inputs untouched

    def test_resolve_shards(self):
        """Default devices are the cards (none here: a clear error); a
        walk the caller put on the CPU shards on the CPU."""
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                resolve_shards(None, None)
        n, devs = resolve_shards(None, cpus(3))
        assert n == 3 and devs == (torch.device(CPU),) * 3
        n, devs = resolve_shards(8, cpus(1))
        assert n == 8 and len(devs) == 1
        assert _resolve_for(None, None, torch.device(CPU)) == \
            (1, (torch.device(CPU),))
        with pytest.raises(ValueError):
            resolve_shards(0, cpus(1))


# ---------------------------------------------------------------------------
# Satellites: shared PPA design matrix and its fallback, WIDE_SPACE, env
# ---------------------------------------------------------------------------

def _own_basis(x, m):
    """One target's prediction from its own design matrix, contracted as
    ``surrogate_ppa`` contracts (per-lane product and row sum)."""
    v = (design_matrix(x, m.exps, m.mu, m.sigma) * m.coef).sum(-1)
    return torch.exp(v) if m.log_target else v


class TestSharedDesignMatrix:

    def test_prefix_property(self):
        for f in (2, 7):
            e3 = monomial_exponents(f, 3)
            for d in (0, 1, 2):
                ed = monomial_exponents(f, d)
                np.testing.assert_array_equal(ed, e3[:len(ed)])

    def test_params_share_one_basis_per_type(self, ppa_models):
        params = ppa_models.ppa_params()
        for entry in params["types"]:
            assert "targets" in entry  # fit_ppa_models output always shares
            assert set(entry["targets"]) == {"power_mw", "clock_ghz",
                                             "area_mm2"}

    @given(seed=st.integers(min_value=0, max_value=5))
    @settings(max_examples=6, deadline=None)
    def test_predictions_bit_identical(self, ppa_models, seed):
        """Sliced shared-basis predictions == each target's own design
        matrix, bitwise, on random config batches."""
        from repro_torch.core import PE_TYPE_NAMES
        cfg = enumerate_space(max_points=64, seed=seed, device=CPU)
        x = config_features(cfg)
        preds = {(name, t): _own_basis(x, m).numpy()
                 for name, ms in ppa_models.models.items()
                 for t, m in ms.items()}
        power, clock, area = surrogate_ppa(ppa_models.ppa_params(), cfg)
        got = {"power_mw": power.numpy(), "clock_ghz": clock.numpy(),
               "area_mm2": area.numpy()}
        pt = cfg.pe_type.numpy().astype(int)
        for t, col in got.items():
            for lane, code in enumerate(pt):
                name = PE_TYPE_NAMES[code]
                assert col[lane] == preds[(name, t)][lane], (t, name, lane)

    def test_legacy_fallback_for_unshareable(self):
        """Hand-assembled models with mismatched standardization take the
        per-target layout and predict each target from its own basis."""
        x = config_features(enumerate_space(max_points=80, seed=2,
                                            device=CPU))
        y = x.sum(dim=1) + 1.0
        m1 = fit_poly(x, y, 1)
        m2 = fit_poly(x[:40], y[:40], 2)  # different mu/sigma
        models = PPAModels(models={"fp32": dict(power_mw=m1, clock_ghz=m1,
                                                area_mm2=m2)})
        params = models.ppa_params()
        (entry,) = params["types"]
        assert "targets" not in entry
        cfg = enumerate_space(_ONE_TYPE, device=CPU)
        power, clock, area = surrogate_ppa(params, cfg)
        assert np.isfinite(power.numpy()).all()
        x = config_features(cfg)
        np.testing.assert_array_equal(area.numpy(), _own_basis(x, m2).numpy())
        np.testing.assert_array_equal(power.numpy(),
                                      _own_basis(x, m1).numpy())


_ONE_TYPE = dict(pe_rows=(8, 16), pe_cols=(8, 14), gbuf_kb=(54.0, 216.0),
                 spad_ifmap=(12,), spad_filter=(112,), spad_psum=(16,),
                 pe_type=(0,), bandwidth_gbps=(25.6,))


def test_wide_space_is_giga_scale():
    assert space_size(WIDE_SPACE) >= 10_000_000


def test_xla_flags_preserved():
    """The reference's test guards XLA_FLAGS in its launch runners.  The
    port has no launch layer and sets no flag: importing every module
    of it leaves the environment exactly as it was."""
    code = (
        "import os, importlib, pathlib\n"
        "os.environ['XLA_FLAGS'] = '--xla_dump_to=/tmp/x'\n"
        "before = dict(os.environ)\n"
        "root = pathlib.Path('src')\n"
        "for p in sorted((root / 'repro_torch').rglob('*.py')):\n"
        "    m = '.'.join(p.relative_to(root).with_suffix('').parts)\n"
        "    importlib.import_module(m.removesuffix('.__init__'))\n"
        "assert dict(os.environ) == before\n"
        "print('ok')\n")
    root = os.path.join(os.path.dirname(__file__), "..")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         env=dict(os.environ, PYTHONPATH="src"),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "ok" in out.stdout


# ---------------------------------------------------------------------------
# Cross-package: the JAX package on the same inputs
# ---------------------------------------------------------------------------

class TestAgainstReference:

    def test_sharded_plain_front_matches_jax(self, workload):
        from repro.core import pareto_front_streaming as j_front
        from repro.core import resnet_cifar as j_resnet
        ref, _ = j_front(j_resnet(20), TINY_SPACE, chunk_size=CHUNK,
                         metrics=METRICS, budget=BUDGET)
        got, _ = pareto_front_streaming(workload, TINY_SPACE,
                                        chunk_size=CHUNK, metrics=METRICS,
                                        budget=BUDGET, **_sh(3))
        H.assert_archive_close(got, ref, RTOL)

    def test_sharded_joint_front_matches_jax(self, tiny_models):
        from repro.core import coexplore_front as j_coexplore
        bud = Budget(area_mm2=60.0, power_mw=1e5, min_accuracy=0.3)
        from repro.core import Budget as JBudget
        ref = j_coexplore(H.jax_tiny_models(), TINY_SPACE, chunk_size=CHUNK,
                          budget=JBudget(**bud.spec()))
        got = coexplore_front(tiny_models, TINY_SPACE, chunk_size=CHUNK,
                              budget=bud, **_sh(2))
        H.assert_archive_close(got.archive, ref.archive, RTOL)
        assert got.budget_stats.as_dict() == ref.budget_stats.as_dict()

    def test_signatures_match_jax(self, tiny_models):
        from repro.core import workloads_signature as j_sig
        from repro.core.shard import space_signature as j_space_sig
        assert workloads_signature(tiny_models) == \
            j_sig(H.jax_tiny_models())
        assert space_signature(TINY_SPACE) == j_space_sig(TINY_SPACE)
        assert space_signature(None) == j_space_sig(None)

    def test_csv_front_matches_jax(self, tiny_models, tmp_path):
        from repro.core import ParetoArchive as JArchive
        from repro.core import export_front_csv as j_csv
        front = coexplore_front(tiny_models, TINY_SPACE, chunk_size=CHUNK)
        jarch = JArchive(3)
        jarch.update(front.archive.objectives, front.archive.indices)
        ours, ref = str(tmp_path / "port.csv"), str(tmp_path / "ref.csv")
        export_front_csv(ours, front.archive, front.metrics, TINY_SPACE,
                         tiny_models)
        j_csv(ref, jarch, front.metrics, TINY_SPACE, H.jax_tiny_models())
        assert open(ours).read() == open(ref).read()

    def test_ppa_fallback_matches_jax(self):
        """The per-target layout predicts what the reference's does, from
        the same fitted polynomials: the polynomial's value (these
        targets are fitted as logs) at rtol 1e-6, the columns after exp
        at rtol 1e-5.  Both fits are degree 1: a degree-2 fit on 40
        points nearly interpolates, and its cancellation turns float32
        contraction order into ~1e-3 away from the sample in either
        package."""
        from repro.core import enumerate_space as j_enumerate
        from repro.core.ppa import (PPAModels as JPPAModels,
                                    config_features as j_features,
                                    fit_poly as j_fit_poly,
                                    surrogate_ppa as j_surrogate_ppa)
        from repro_torch.core.ppa import PolyModel
        jx = j_features(j_enumerate(max_points=80, seed=2))
        jy = np.asarray(jx).sum(axis=1) + 1.0
        jm1, jm2 = j_fit_poly(jx, jy, 1), j_fit_poly(jx[:40], jy[:40], 1)
        jmodels = JPPAModels(models={"fp32": dict(
            power_mw=jm1, clock_ghz=jm1, area_mm2=jm2)})
        as_t = lambda a: torch.tensor(np.asarray(a))  # noqa: E731
        port = lambda m: PolyModel(  # noqa: E731
            degree=m.degree, exps=np.asarray(m.exps), mu=as_t(m.mu),
            sigma=as_t(m.sigma), coef=as_t(m.coef),
            log_target=bool(m.log_target))
        models = PPAModels(models={"fp32": dict(
            power_mw=port(jm1), clock_ghz=port(jm1), area_mm2=port(jm2))})
        (entry,) = models.ppa_params()["types"]
        assert "targets" not in entry
        got = surrogate_ppa(models.ppa_params(),
                            enumerate_space(_ONE_TYPE, device=CPU))
        want = j_surrogate_ppa(jmodels.ppa_params(), j_enumerate(_ONE_TYPE))
        for g, w in zip(got, want):
            np.testing.assert_allclose(np.log(g.numpy()), np.log(np.asarray(w)),
                                       rtol=1e-6, atol=0)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                       atol=0)

    def test_state_files_cross_read(self, tmp_path):
        """``save_state`` files of either package load in the other."""
        from repro.checkpoint import manager as j_manager
        state = dict(cursor=3, archive=dict(
            objectives=np.arange(6.0).reshape(3, 2),
            indices=np.array([4, 9, 1], np.int64), seen=12),
            names=["a", "b"], flag=True, none=None)
        port_dir, ref_dir = str(tmp_path / "port"), str(tmp_path / "ref")
        manager.save_state(port_dir, 3, dict(
            state, t=torch.arange(4, dtype=torch.int32)))
        j_manager.save_state(ref_dir, 3, dict(
            state, t=np.arange(4, dtype=np.int32)))
        for load, path in ((j_manager.load_state, port_dir),
                           (manager.load_state, ref_dir)):
            step, back = load(path)
            assert step == 3 and back["cursor"] == 3
            assert back["names"] == ["a", "b"] and back["flag"] is True
            assert back["none"] is None
            np.testing.assert_array_equal(back["archive"]["objectives"],
                                          state["archive"]["objectives"])
            assert back["archive"]["indices"].dtype == np.int64
            assert back["t"].dtype == np.int32
        assert sorted(os.listdir(os.path.join(port_dir, "step_3"))) == \
            sorted(os.listdir(os.path.join(ref_dir, "step_3")))


class TestPlacement:
    """A shard on another device than the walk's tensors evaluates on
    copies of the workload and of the fitted cost model (``_Shard``);
    forced here on the CPU, the copies give the walk's result."""

    def test_copies_evaluate_like_the_originals(self, workload, ppa_models):
        from repro_torch.core import as_cost_model, evaluate_chunk
        from repro_torch.core.shard import _PlacedCostModel, _Shard
        sh = _Shard(torch.device(CPU), torch.device(CPU))
        assert sh.placed(workload) is workload       # local: no copy
        sh.local = False
        model = as_cost_model(ppa_models)
        wl, placed = sh.placed(workload), sh.placed(model)
        assert wl is not workload and sh.placed(workload) is wl
        assert isinstance(placed, _PlacedCostModel)
        assert placed.name == model.name
        cfg = enumerate_space(TINY_SPACE, device=CPU)
        for a, b in zip(evaluate_chunk(cfg, wl, placed, pad_to=64),
                        evaluate_chunk(cfg, workload, model, pad_to=64)):
            np.testing.assert_array_equal(a, b)
        with pytest.raises(ValueError, match="not a known PE type"):
            placed.validate(enumerate_space(dict(TINY_SPACE, pe_type=(9,)),
                                            device=CPU))
