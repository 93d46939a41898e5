"""repro_torch's deployment budgets against repro's, on the CPU (mirrors
``tests/test_constraints.py``): the ``Budget`` spec compiles to the
reference's constraints, streaming feasibility masks equal post-hoc
filtering bit for bit on the plain walk and on both joint walks, and the
port's budget counts equal the reference's exactly."""

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # CI images without hypothesis: deterministic fallback
    from _hypothesis_fallback import given, settings, st

from repro.core import (Budget as JBudget, BudgetStats as JBudgetStats,
                        coexplore_front as j_coexplore_front,
                        model_entry as j_model_entry,
                        resnet_cifar as j_resnet_cifar,
                        transformer_gemm as j_transformer_gemm)
from repro_torch.core import (PAPER_WORKLOADS, AccuracySurrogate, Budget,
                              BudgetColumns, BudgetStats, DseResult,
                              apply_budget, coexplore_front, coexplore_report,
                              evaluate_chunk, evaluate_space_streaming,
                              iter_joint_space_chunks, mask_result,
                              model_entry, pareto_front_streaming,
                              pareto_mask_dense, resnet_cifar, space_size,
                              transformer_gemm)
from repro_torch.core.coexplore import _joint_objectives
from repro_torch.core.dse import _objective_columns

CPU = "cpu"
# 2*2*1*1*2*1*5*1 = 40 accelerator points keeps every walk here cheap.
TINY_SPACE = dict(
    pe_rows=(8, 12), pe_cols=(8, 14), gbuf_kb=(54.0,), spad_ifmap=(12,),
    spad_filter=(112, 224), spad_psum=(16,),
    pe_type=tuple(range(5)), bandwidth_gbps=(25.6,),
)
CHUNK = 16
METRICS = ("perf_per_area", "neg_energy_j")


def _concat_results(chunks) -> DseResult:
    return DseResult(*[np.concatenate([r[i] for r in chunks])
                       for i in range(len(DseResult._fields))])


@pytest.fixture(scope="module")
def workload():
    return PAPER_WORKLOADS["resnet20-cifar10"](device=CPU)


@pytest.fixture(scope="module")
def full_result(workload) -> DseResult:
    return _concat_results([r for r, _ in evaluate_space_streaming(
        workload, TINY_SPACE, chunk_size=CHUNK)])


def _tiny_models():
    return (model_entry(resnet_cifar(20, device=CPU)),
            model_entry(transformer_gemm(seq=128, d_model=128, n_layers=2,
                                         n_heads=4, d_ff=256, vocab=1024,
                                         device=CPU)))


@pytest.fixture(scope="module")
def tiny_models():
    return _tiny_models()


@pytest.fixture(scope="module")
def full_joint(tiny_models):
    """(full DseResult, per-lane accuracy, joint indices) of the whole
    unconstrained per-model walk."""
    acc = AccuracySurrogate()
    acc_matrix = np.stack([acc.predict_per_type(m.name, m.macs, m.base_acc)
                           for m in tiny_models])
    res_chunks, lane_accs, idxs = [], [], []
    for m, cfg, idx in iter_joint_space_chunks(
            TINY_SPACE, num_models=len(tiny_models), chunk_size=CHUNK,
            group_by_model=True, device=CPU):
        res_chunks.append(evaluate_chunk(cfg, tiny_models[m].workload,
                                         pad_to=CHUNK))
        lane_accs.append(acc_matrix[m][cfg.pe_type.numpy().astype(np.int64)])
        idxs.append(idx)
    return (_concat_results(res_chunks), np.concatenate(lane_accs),
            np.concatenate(idxs))


def _posthoc_front(obj: np.ndarray, mask: np.ndarray):
    feas = np.flatnonzero(mask)
    if not len(feas):
        return feas.astype(np.int64), np.empty((0, obj.shape[1]))
    keep = pareto_mask_dense(torch.as_tensor(obj[mask])).numpy()
    return feas[keep], obj[mask][keep]


def _assert_front_equal(indices, objectives, ref_idx, ref_obj):
    np.testing.assert_array_equal(np.sort(indices), np.sort(ref_idx))
    order, ref_order = np.argsort(indices), np.argsort(ref_idx)
    np.testing.assert_array_equal(np.asarray(objectives)[order],
                                  np.asarray(ref_obj)[ref_order])


class TestBudgetSpec:
    @pytest.mark.parametrize("kwargs", [
        dict(area_mm2=8.0, min_accuracy=0.9),
        dict(power_mw=250.0, latency_s=1e-3, energy_j=2e-4),
        dict(min_utilization=0.5, area_mm2=2.0), dict()])
    def test_constraints_equal_reference(self, kwargs):
        mine, ref = Budget(**kwargs), JBudget(**kwargs)
        assert [tuple(c) for c in mine.constraints()] \
            == [tuple(c) for c in ref.constraints()]
        assert mine.spec() == ref.spec() and mine.active == ref.active
        assert [c.name for c in mine.config_constraints()] \
            == [c.name for c in ref.config_constraints()]

    def test_constraints_compile_active_fields_only(self):
        cons = Budget(area_mm2=8.0, min_accuracy=0.9).constraints()
        assert [(c.column, c.kind, c.bound, c.stage) for c in cons] == [
            ("area_mm2", "max", 8.0, "config"),
            ("accuracy", "min", 0.9, "config")]
        assert [c.name for c in cons] == ["area_mm2<=8", "accuracy>=0.9"]

    def test_empty_budget_is_inactive_and_filters_nothing(self, full_result):
        mask, kills = Budget().feasibility(full_result)
        assert mask.all() and kills == {}

    @pytest.mark.parametrize("kwargs", [
        dict(area_mm2=-1.0), dict(power_mw=float("nan")),
        dict(latency_s=float("inf")), dict(min_accuracy=1.5),
        dict(min_utilization=-0.1),
    ])
    def test_invalid_bounds_rejected_at_construction(self, kwargs):
        with pytest.raises(ValueError):
            Budget(**kwargs)

    def test_min_accuracy_needs_joint_walk(self, full_result):
        with pytest.raises(ValueError, match="co-exploration"):
            Budget(min_accuracy=0.5).feasibility(full_result)

    @pytest.mark.parametrize("bad_val", [np.nan, np.inf])
    def test_non_finite_constrained_column_raises(self, full_result,
                                                  bad_val):
        cols = {f: np.array(getattr(full_result, f))
                for f in DseResult._fields}
        cols["latency_s"][3] = bad_val
        corrupt = DseResult(**cols)
        with pytest.raises(ValueError, match="non-finite"):
            Budget(latency_s=1.0).feasibility(corrupt)
        mask, _ = Budget(area_mm2=1e6).feasibility(corrupt)
        assert mask.all()

    def test_kill_counts_are_independent_per_constraint(self, full_result):
        area, lat = full_result.area_mm2, full_result.latency_s
        b = Budget(area_mm2=float(np.median(area)),
                   latency_s=float(np.median(lat)))
        mask, kills = b.feasibility(full_result)
        assert kills[f"area_mm2<={np.median(area):g}"] \
            == int((area > np.median(area)).sum())
        assert kills[f"latency_s<={np.median(lat):g}"] \
            == int((lat > np.median(lat)).sum())
        np.testing.assert_array_equal(
            mask, (area <= np.median(area)) & (lat <= np.median(lat)))
        cols = BudgetColumns.from_result(full_result)
        m2, k2 = b.feasibility(cols.take(np.arange(len(area))))
        np.testing.assert_array_equal(m2, mask)
        assert k2 == kills

    def test_mask_result_and_apply_budget(self, full_result):
        mask = np.zeros(len(full_result.latency_s), bool)
        mask[[1, 5]] = True
        sub = mask_result(full_result, mask)
        for f in DseResult._fields:
            np.testing.assert_array_equal(getattr(sub, f),
                                          getattr(full_result, f)[mask])
        idx = np.arange(len(full_result.latency_s))
        stats = BudgetStats()
        res, out = apply_budget(full_result, idx, Budget(area_mm2=1e6),
                                stats=stats)
        assert res is full_result
        assert stats.feasible == stats.evaluated == len(idx)

    def test_budget_stats_accumulate(self):
        stats = BudgetStats()
        assert stats.feasible_fraction == 0.0
        stats.record(np.array([True, False, False]), {"a<=1": 2})
        stats.record(np.array([True, True]), {"a<=1": 0, "b>=2": 0})
        assert stats.evaluated == 5 and stats.feasible == 3
        assert stats.kills == {"a<=1": 2, "b>=2": 0}
        assert stats.as_dict()["feasible_fraction"] == pytest.approx(0.6)
        assert BudgetStats.from_dict(stats.as_dict()) == stats


class TestConstrainedDseWalk:
    @given(q_area=st.floats(0.0, 1.0), q_power=st.floats(0.0, 1.0),
           prune=st.booleans())
    @settings(max_examples=12, deadline=None)
    def test_front_equals_posthoc_filtering(self, workload, full_result,
                                            q_area, q_power, prune):
        budget = Budget(
            area_mm2=float(np.quantile(full_result.area_mm2, q_area)),
            power_mw=float(np.quantile(full_result.power_mw, q_power)))
        mask, _ = budget.feasibility(full_result)
        ref_idx, ref_obj = _posthoc_front(
            _objective_columns(full_result, METRICS), mask)
        stats = BudgetStats()
        archive, _ = pareto_front_streaming(
            workload, TINY_SPACE, metrics=METRICS, chunk_size=CHUNK,
            budget=budget, budget_stats=stats, prune=prune)
        _assert_front_equal(archive.indices, archive.objectives,
                            ref_idx, ref_obj)
        assert stats.evaluated == space_size(TINY_SPACE)
        assert stats.feasible == int(mask.sum())

    def test_empty_feasible_set_yields_empty_front(self, workload):
        stats = BudgetStats()
        archive, cfgs = pareto_front_streaming(
            workload, TINY_SPACE, metrics=METRICS, chunk_size=CHUNK,
            budget=Budget(area_mm2=0.0), budget_stats=stats)
        assert len(archive) == 0 and tuple(cfgs.pe_rows.shape) == (0,)
        assert stats.feasible == 0
        assert stats.evaluated == space_size(TINY_SPACE)

    @pytest.mark.parametrize("prune", [True, False])
    def test_streaming_chunks_are_prefiltered(self, workload, full_result,
                                              prune):
        bound = float(np.median(full_result.area_mm2))
        seen = 0
        for res, idx in evaluate_space_streaming(
                workload, TINY_SPACE, chunk_size=7,
                budget=Budget(area_mm2=bound), prune=prune):
            assert (res.area_mm2 <= bound).all() and len(idx) > 0
            seen += len(idx)
        assert seen == int((full_result.area_mm2 <= bound).sum())


class TestConstrainedJointWalks:
    @given(q_area=st.floats(0.0, 1.0), q_acc=st.floats(0.0, 1.0),
           mix=st.booleans(), prune=st.booleans())
    @settings(max_examples=10, deadline=None)
    def test_front_equals_posthoc_filtering_both_walks(
            self, tiny_models, full_joint, q_area, q_acc, mix, prune):
        full, lane_acc, idx = full_joint
        budget = Budget(
            area_mm2=float(np.quantile(full.area_mm2, q_area)),
            min_accuracy=float(np.quantile(lane_acc, q_acc)))
        mask, kills = budget.feasibility(full, accuracy=lane_acc)
        ref_idx, ref_obj = _posthoc_front(_joint_objectives(full, lane_acc),
                                          mask)
        front = coexplore_front(tiny_models, TINY_SPACE, chunk_size=CHUNK,
                                mix_models=mix, budget=budget, prune=prune)
        _assert_front_equal(front.archive.indices, front.archive.objectives,
                            idx[ref_idx], ref_obj)
        assert front.points_evaluated == len(idx)
        assert front.budget_stats.evaluated == len(idx)
        assert front.budget_stats.feasible == int(mask.sum())
        assert front.budget_stats.kills == kills

    def test_all_feasible_matches_unconstrained_bitwise(self, tiny_models):
        free = coexplore_front(tiny_models, TINY_SPACE, chunk_size=CHUNK)
        bounded = coexplore_front(
            tiny_models, TINY_SPACE, chunk_size=CHUNK,
            budget=Budget(area_mm2=1e6, power_mw=1e9, min_accuracy=0.0))
        _assert_front_equal(bounded.archive.indices,
                            bounded.archive.objectives,
                            free.archive.indices, free.archive.objectives)
        assert bounded.per_model_best == free.per_model_best

    def test_empty_feasible_set_reports_cleanly(self, tiny_models):
        rep = coexplore_report(coexplore_front(
            tiny_models, TINY_SPACE, chunk_size=CHUNK,
            budget=Budget(area_mm2=0.0)))
        assert rep["front_size"] == 0 and rep["points"] == []
        assert rep["budget"]["feasible"] == 0
        assert rep["claim"]["holds"] is False
        assert rep["claim"]["indeterminate"] == len(tiny_models)

    def test_report_budget_section(self, tiny_models, full_joint):
        full, _, _ = full_joint
        bound = float(np.median(full.area_mm2))
        front = coexplore_front(tiny_models, TINY_SPACE, chunk_size=CHUNK,
                                budget=Budget(area_mm2=bound))
        b = coexplore_report(front)["budget"]
        assert b["spec"] == dict(area_mm2=bound)
        assert b["evaluated"] == front.points_evaluated
        assert 0 < b["feasible"] < b["evaluated"]
        assert b["pruned"] == b["evaluated"] - b["feasible"]
        assert b["kills"] == {f"area_mm2<={bound:g}":
                              b["evaluated"] - b["feasible"]}


@pytest.mark.parametrize("mix", [True, False])
def test_budget_counts_equal_reference(tiny_models, mix):
    """The same subsampled constrained joint walk in both packages: the
    same budget counts exactly and the same front index set."""
    budget = dict(area_mm2=1.5, power_mw=400.0)
    jmodels = (j_model_entry(j_resnet_cifar(20)),
               j_model_entry(j_transformer_gemm(seq=128, d_model=128,
                                                n_layers=2, n_heads=4,
                                                d_ff=256, vocab=1024)))
    want = j_coexplore_front(jmodels, TINY_SPACE, chunk_size=CHUNK,
                             max_points=60, seed=4, mix_models=mix,
                             budget=JBudget(**budget))
    got = coexplore_front(tiny_models, TINY_SPACE, chunk_size=CHUNK,
                          max_points=60, seed=4, mix_models=mix,
                          budget=Budget(**budget))
    assert isinstance(want.budget_stats, JBudgetStats)
    assert got.budget_stats.as_dict() == want.budget_stats.as_dict()
    assert sorted(got.archive.indices) == sorted(want.archive.indices)
    assert got.points_evaluated == want.points_evaluated == 60
