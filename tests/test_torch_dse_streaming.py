"""repro_torch's streaming DSE against repro's, on the CPU (mirrors
``tests/test_dse_streaming.py``): the streaming walk against the one-shot
evaluation and the reference's walk, the non-dominated archive against
the dense oracle, the shared chunk-dominator prefilter, and the knobs
the port refuses."""

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # CI images without hypothesis: deterministic fallback
    from _hypothesis_fallback import given, settings, st

from repro.core import (PAPER_WORKLOADS as J_WORKLOADS,
                        evaluate_space_streaming as j_streaming,
                        pareto_front_streaming as j_front_streaming)
from repro_torch.coexplore_check import RTOL
from repro_torch.core import (PAPER_WORKLOADS, Budget, ParetoArchive,
                              TwoStagePruner, chunk_dominators,
                              enumerate_space, evaluate_space,
                              evaluate_space_streaming, fold_budget_chunk,
                              pareto_front_streaming, pareto_mask_dense)
from repro_torch.core.arch import AcceleratorConfig

from _torch_helpers import assert_columns_close

CPU = "cpu"
# A small space (2*2*2*1*2*1*5*1 = 80 points) keeps evaluation cheap.
SMALL_SPACE = dict(
    pe_rows=(8, 12), pe_cols=(8, 14), gbuf_kb=(54.0, 108.0),
    spad_ifmap=(12,), spad_filter=(112, 224), spad_psum=(16,),
    pe_type=tuple(range(5)), bandwidth_gbps=(25.6,),
)


def _config_matrix(cfg: AcceleratorConfig) -> np.ndarray:
    return np.stack([torch.as_tensor(getattr(cfg, f)).double().numpy()
                     for f in AcceleratorConfig._fields], axis=-1)


@pytest.fixture(scope="module")
def workload():
    return PAPER_WORKLOADS["resnet20-cifar10"](device=CPU)


@pytest.fixture(scope="module")
def one_shot(workload):
    space = enumerate_space(SMALL_SPACE, device=CPU)
    return space, evaluate_space(space, workload)


class TestStreamingEvaluation:
    @pytest.mark.parametrize("chunk", [7, 13, 16, 80, 100])
    def test_streaming_equals_one_shot_bitwise(self, one_shot, workload,
                                               chunk):
        _, ref = one_shot
        chunks = list(evaluate_space_streaming(workload, SMALL_SPACE,
                                               chunk_size=chunk))
        for f, field in enumerate(ref._fields):
            got = np.concatenate([res[f] for res, _ in chunks])
            np.testing.assert_array_equal(ref[f], got, err_msg=field)
        np.testing.assert_array_equal(
            np.concatenate([i for _, i in chunks]), np.arange(80))

    @pytest.mark.parametrize("max_points", [None, 33])
    def test_streaming_matches_reference(self, workload, max_points):
        jwl = J_WORKLOADS["resnet20-cifar10"]()
        want = list(j_streaming(jwl, SMALL_SPACE, chunk_size=13,
                                max_points=max_points, seed=2))
        got = list(evaluate_space_streaming(workload, SMALL_SPACE,
                                            chunk_size=13,
                                            max_points=max_points, seed=2))
        assert len(got) == len(want)
        for (gr, gi), (wr, wi) in zip(got, want):
            np.testing.assert_array_equal(gi, wi)
            assert_columns_close(wr, gr, RTOL)

    def test_walk_follows_workload_device(self, workload):
        res, idx = next(evaluate_space_streaming(workload, SMALL_SPACE,
                                                 chunk_size=8))
        assert len(idx) == 8 and res.latency_s.dtype == np.float64


def _random_objectives(rng, n, d, dupes=True):
    pts = rng.normal(size=(n, d))
    if dupes:
        pts = np.round(pts, 1)
        pts[rng.integers(0, n, n // 4)] = pts[rng.integers(0, n, n // 4)]
    return pts


def _dense(pts) -> set:
    return set(np.flatnonzero(
        pareto_mask_dense(torch.as_tensor(pts)).numpy()).tolist())


class TestParetoArchive:
    @given(seed=st.integers(0, 100), n=st.integers(1, 200),
           chunk=st.integers(1, 64), d=st.integers(2, 3))
    @settings(max_examples=25, deadline=None)
    def test_streamed_front_equals_dense(self, seed, n, chunk, d):
        pts = _random_objectives(np.random.default_rng(seed), n, d)
        archive = ParetoArchive(d)
        for lo in range(0, n, chunk):
            archive.update(pts[lo:lo + chunk],
                           np.arange(lo, min(lo + chunk, n)))
        assert set(archive.indices.tolist()) == _dense(pts)
        np.testing.assert_array_equal(archive.objectives,
                                      pts[archive.indices])

    def test_order_invariance(self):
        pts = _random_objectives(np.random.default_rng(1), 120, 3)
        a1, a2 = ParetoArchive(3), ParetoArchive(3)
        a1.update(pts, np.arange(120))
        perm = np.random.default_rng(2).permutation(120)
        for lo in range(0, 120, 37):
            sel = perm[lo:lo + 37]
            a2.update(pts[sel], sel)
        assert set(a1.indices.tolist()) == set(a2.indices.tolist())

    def test_state_round_trip_continues_bitwise(self):
        pts = _random_objectives(np.random.default_rng(3), 90, 3)
        whole = ParetoArchive(3)
        whole.update(pts[:40])
        restored = ParetoArchive.from_state(whole.state_dict())
        for a in (whole, restored):
            a.update(pts[40:])
        np.testing.assert_array_equal(whole.indices, restored.indices)
        np.testing.assert_array_equal(whole.objectives, restored.objectives)

    def test_rejects_wrong_width(self):
        with pytest.raises(ValueError):
            ParetoArchive(2).update(np.zeros((4, 3)))

    @pytest.mark.parametrize("bad_val", [np.nan, np.inf, -np.inf])
    def test_rejects_non_finite_rows(self, bad_val):
        archive = ParetoArchive(2)
        archive.update(np.array([[1.0, 1.0]]))
        with pytest.raises(ValueError, match="non-finite"):
            archive.update(np.array([[2.0, 2.0], [bad_val, 0.0]]))
        np.testing.assert_array_equal(archive.indices, [0])

    def test_preserves_float64_precision(self):
        archive = ParetoArchive(2)
        archive.update(np.array([[1.0 + 1e-12, 0.0], [1.0, 1.0]]))
        assert set(archive.indices.tolist()) == {0, 1}


class TestChunkDominators:
    @given(seed=st.integers(0, 50), n=st.integers(1, 120),
           q=st.floats(0.0, 1.0))
    @settings(max_examples=15, deadline=None)
    def test_prefilter_is_exact(self, seed, n, q):
        """Folding with the shared dominator prefilter gives the archive
        of the fold without it, under any feasibility mask."""
        rng = np.random.default_rng(seed)
        obj = _random_objectives(rng, n, 3)
        area = rng.uniform(0.0, 1.0, n)
        res = type("Cols", (), dict(area_mm2=area))()
        budget = Budget(area_mm2=float(q))
        plain, pre = ParetoArchive(3), ParetoArchive(3)
        idx = np.arange(n)
        fold_budget_chunk(plain, obj, idx, result=res, budget=budget)
        fold_budget_chunk(pre, obj, idx, result=res, budget=budget,
                          dom=chunk_dominators(obj, block=16))
        assert set(plain.indices.tolist()) == set(pre.indices.tolist())


class TestStreamingFront:
    def test_end_to_end_matches_dense(self, one_shot, workload):
        space, res = one_shot
        obj = np.stack([res.perf_per_area, -res.energy_j], -1)
        archive, front_cfg = pareto_front_streaming(workload, SMALL_SPACE,
                                                    chunk_size=13)
        assert set(archive.indices.tolist()) == _dense(obj)
        np.testing.assert_array_equal(_config_matrix(front_cfg),
                                      _config_matrix(space)[archive.indices])

    @pytest.mark.parametrize("budget", [None, dict(area_mm2=1.2)])
    def test_front_matches_reference(self, workload, budget):
        from repro.core import Budget as JBudget
        jwl = J_WORKLOADS["resnet20-cifar10"]()
        want, _ = j_front_streaming(
            jwl, SMALL_SPACE, chunk_size=13,
            budget=None if budget is None else JBudget(**budget))
        got, _ = pareto_front_streaming(
            workload, SMALL_SPACE, chunk_size=13,
            budget=None if budget is None else Budget(**budget))
        assert sorted(got.indices.tolist()) == sorted(want.indices.tolist())
        np.testing.assert_allclose(got.objectives[np.argsort(got.indices)],
                                   want.objectives[np.argsort(want.indices)],
                                   rtol=RTOL, atol=0)


class TestNotPorted:
    @pytest.mark.parametrize("kw", [dict(shards=2), dict(devices=["cpu"]),
                                    dict(pipeline_depth=2),
                                    dict(checkpoint_dir="x"),
                                    dict(csv_path="x.csv"),
                                    dict(max_chunks=1)])
    def test_scale_out_knobs_raise(self, workload, kw, tmp_path):
        """The scale-out knobs are ported (``core/shard.py``): each one
        gives the plain walk's front bit for bit, ``max_chunks`` the
        front of the chunks it walked."""
        kw = {k: str(tmp_path / v) if k in ("checkpoint_dir", "csv_path")
              else v for k, v in kw.items()}
        want, _ = pareto_front_streaming(workload, SMALL_SPACE, chunk_size=13)
        if "max_chunks" in kw:
            res, idx = next(evaluate_space_streaming(workload, SMALL_SPACE,
                                                     chunk_size=13))
            want = ParetoArchive(2)
            want.update(np.stack([res.perf_per_area, -res.energy_j], -1), idx)
        got, _ = pareto_front_streaming(workload, SMALL_SPACE, chunk_size=13,
                                        **kw)
        # a merged front's row order is the merge's: compare by index
        go, wo = np.argsort(got.indices), np.argsort(want.indices)
        np.testing.assert_array_equal(got.indices[go], want.indices[wo])
        np.testing.assert_array_equal(got.objectives[go],
                                      want.objectives[wo])

    def test_pruner_needs_a_config_stage_bound(self):
        with pytest.raises(ValueError, match="config-stage"):
            TwoStagePruner(Budget(power_mw=1.0), 16)

    def test_pruner_refuses_oversized_chunks(self, workload):
        pruner = TwoStagePruner(Budget(area_mm2=1.0), 4)
        cfg = enumerate_space(SMALL_SPACE, max_points=8, device=CPU)
        with pytest.raises(ValueError, match="chunk"):
            list(pruner.feed(cfg, np.arange(8), workload))
