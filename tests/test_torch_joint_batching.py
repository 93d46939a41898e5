"""repro_torch's mixed-model lanes against repro's, on the CPU: layer
padding inert, layer-count bucketing, stacked-workload evaluation, the
archive's NaN guard and chunk-front reduction (mirrors
``tests/test_joint_batching.py``).

Within the port the contracts hold bit for bit: a padded evaluation
equals the unpadded one in every column, and a mixed chunk equals each
lane's per-model evaluation.  Against the reference the columns are held
at ``coexplore_check.RTOL``: the reference's own mixed lanes differ from
its per-model ones in the last float32 bit (ROADMAP queue C).
"""

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # CI images without hypothesis: deterministic fallback
    from _hypothesis_fallback import given, settings, st

from repro.core import (enumerate_space as j_enumerate_space,
                        evaluate_chunk as j_evaluate_chunk,
                        resnet_cifar as j_resnet_cifar,
                        stack_workloads as j_stack_workloads)
from repro_torch import convert
from repro_torch.coexplore_check import RTOL
from repro_torch.core import (RESULT_DTYPES, DseResult, ParetoArchive,
                              StackedWorkload, coexplore_front,
                              enumerate_space, evaluate_chunk,
                              evaluate_space, layer_bucket, make_config,
                              model_entry, pad_workload, pareto_mask_dense,
                              resnet_cifar, stack_workloads, synthesize,
                              transformer_gemm, vgg16, workload_layers,
                              workload_macs)
from repro_torch.core.dataflow import network_cost
from repro_torch.core.dse import _dominated_by
from repro_torch.core.workloads import _stack

from _torch_helpers import assert_columns_close, port_config

CPU = "cpu"

# 2*2*2*2*2*1*5*2 = 320 accelerator points covering every PE type and a
# spread of every capacity knob.
SPACE = dict(
    pe_rows=(8, 12), pe_cols=(8, 14), gbuf_kb=(54.0, 108.0),
    spad_ifmap=(12, 24), spad_filter=(112, 224), spad_psum=(16,),
    pe_type=tuple(range(5)), bandwidth_gbps=(12.8, 25.6),
)


def _random_workload(rng, n_layers):
    """Random-but-legal conv/GEMM layer stack (H >= R, W >= S, count >= 1)."""
    rows = []
    for _ in range(n_layers):
        r = int(rng.integers(1, 4))
        s = int(rng.integers(1, 4))
        rows.append(dict(H=int(rng.integers(r, 17)), W=int(rng.integers(s, 17)),
                         C=int(rng.integers(1, 9)), K=int(rng.integers(1, 9)),
                         R=r, S=s, stride=int(rng.integers(1, 3)),
                         batch=int(rng.integers(1, 3)),
                         count=int(rng.integers(1, 4))))
    return _stack(rows, "rand", [f"l{i}" for i in range(n_layers)], CPU)


def _assert_results_equal(a: DseResult, b: DseResult):
    for f in DseResult._fields:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f"column {f}")


class TestPaddingBitIdentity:
    @given(seed=st.integers(0, 50), n_layers=st.integers(1, 24),
           pad=st.integers(1, 40))
    @settings(max_examples=15, deadline=None)
    def test_network_cost_padded_equals_unpadded(self, seed, n_layers, pad):
        rng = np.random.default_rng(seed)
        wl = _random_workload(rng, n_layers)
        cfgs = enumerate_space(SPACE, max_points=32, seed=seed, device=CPU)
        clock = synthesize(cfgs).clock_ghz
        ref = network_cost(wl.layers, cfgs, clock)
        got = network_cost(pad_workload(wl, n_layers + pad).layers, cfgs,
                           clock)
        for f, a, b in zip(ref._fields, ref, got):
            assert torch.equal(a, b), f

    @pytest.mark.parametrize("wl_fn,bucket", [
        (lambda: resnet_cifar(20, device=CPU), 32),
        (lambda: vgg16("cifar10", device=CPU), 16),
        (lambda: transformer_gemm(seq=64, d_model=64, n_layers=2, n_heads=2,
                                  d_ff=128, vocab=512, device=CPU), 16),
    ])
    def test_evaluate_chunk_padded_equals_unpadded(self, wl_fn, bucket):
        """Eager torch has no shape-dependent code generation: every
        column is bit for bit the same (the reference holds only the
        objective columns so)."""
        wl = wl_fn()
        cfgs = enumerate_space(SPACE, max_points=64, seed=3, device=CPU)
        _assert_results_equal(evaluate_chunk(cfgs, wl),
                              evaluate_chunk(cfgs, pad_workload(wl, bucket)))

    @pytest.mark.parametrize("pad_to", [None, 70])
    def test_mixed_lanes_equal_per_model_evaluation(self, pad_to):
        wls = (resnet_cifar(20, device=CPU),
               resnet_cifar(20, resolution=16, device=CPU))
        stacked = stack_workloads(wls)
        cfgs = enumerate_space(SPACE, max_points=64, seed=7, device=CPU)
        mids = np.arange(64) % 2
        mixed = evaluate_chunk(cfgs, stacked, model_ids=mids, pad_to=pad_to)
        refs = [evaluate_chunk(cfgs, wl, pad_to=pad_to) for wl in wls]
        for f in DseResult._fields:
            want = np.where(mids == 0, getattr(refs[0], f),
                            getattr(refs[1], f))
            np.testing.assert_array_equal(getattr(mixed, f), want,
                                          err_msg=f"column {f}")

    def test_mixed_lanes_match_reference(self):
        """The same mixed chunk through both packages: columns within
        RTOL (the reference's stack handed across as numpy arrays)."""
        jwls = (j_resnet_cifar(20), j_resnet_cifar(20, resolution=16))
        jstacked = j_stack_workloads(jwls)
        jcfgs = j_enumerate_space(SPACE, max_points=64, seed=7)
        mids = np.arange(64) % 2
        want = j_evaluate_chunk(jcfgs, jstacked, model_ids=mids)
        stacked = convert.stacked_workload_from_numpy(
            jstacked.names, {f: np.asarray(getattr(jstacked.layers, f))
                             for f in jstacked.layers._fields},
            jstacked.n_layers, CPU)
        mine = stack_workloads((resnet_cifar(20, device=CPU),
                                resnet_cifar(20, resolution=16, device=CPU)))
        for f in stacked.layers._fields:
            assert torch.equal(getattr(stacked.layers, f),
                               getattr(mine.layers, f)), f
        got = evaluate_chunk(port_config(jcfgs), stacked, model_ids=mids)
        assert_columns_close(want, got, RTOL)

    def test_padding_is_inert_metadata(self):
        wl = resnet_cifar(20, device=CPU)
        n = workload_layers(wl)
        padded = pad_workload(wl, n + 7)
        assert workload_layers(padded) == n + 7
        assert padded.name == wl.name
        assert padded.layer_names[:n] == wl.layer_names
        assert workload_macs(padded) == workload_macs(wl)
        assert pad_workload(wl, n) is wl
        with pytest.raises(ValueError):
            pad_workload(wl, n - 1)


class TestLayerBucketing:
    @pytest.mark.parametrize("n,want", [(1, 8), (8, 8), (9, 16), (15, 16),
                                        (22, 32), (58, 64)])
    def test_next_pow2_policy(self, n, want):
        from repro.core import layer_bucket as j_layer_bucket
        assert layer_bucket(n) == want == j_layer_bucket(n)

    def test_explicit_buckets(self):
        assert layer_bucket(10, buckets=(12, 48)) == 12
        assert layer_bucket(13, buckets=(12, 48)) == 48
        assert layer_bucket(50, buckets=(12, 48)) == 64

    def test_invalid_count_rejected(self):
        with pytest.raises(ValueError):
            layer_bucket(0)


class TestStackWorkloads:
    def test_shapes_names_and_depths(self):
        wls = (resnet_cifar(20, device=CPU), vgg16("cifar10", device=CPU))
        stacked = stack_workloads(wls)
        counts = tuple(workload_layers(w) for w in wls)
        depth = layer_bucket(max(counts))
        assert isinstance(stacked, StackedWorkload)
        assert stacked.names == tuple(w.name for w in wls)
        assert stacked.n_layers == counts
        for f in stacked.layers:
            assert tuple(f.shape) == (2, depth)

    def test_pad_to_override_and_row_content(self):
        wl = resnet_cifar(20, device=CPU)
        stacked = stack_workloads([wl], pad_to=40)
        n = workload_layers(wl)
        assert torch.equal(stacked.layers.H[0, :n], wl.layers.H)
        assert bool((stacked.layers.count[0, n:] == 0.0).all())

    def test_empty_rejected(self):
        with pytest.raises(ValueError):
            stack_workloads([])

    def test_model_ids_contract_enforced(self):
        wl = resnet_cifar(20, device=CPU)
        stacked = stack_workloads([wl])
        cfgs = enumerate_space(SPACE, max_points=8, seed=0, device=CPU)
        with pytest.raises(ValueError):            # stacked needs model_ids
            evaluate_chunk(cfgs, stacked)
        with pytest.raises(ValueError):            # plain forbids model_ids
            evaluate_chunk(cfgs, wl, model_ids=np.zeros(8, int))
        with pytest.raises(ValueError):            # wrong length
            evaluate_chunk(cfgs, stacked, model_ids=np.zeros(5, int))
        with pytest.raises(ValueError):            # id out of range
            evaluate_chunk(cfgs, stacked, model_ids=np.ones(8, int))


class TestResultDtypes:
    def test_empty_space_columns_correctly_dtyped(self):
        wl = resnet_cifar(20, device=CPU)
        empty = type(make_config(device=CPU))(
            *[torch.zeros((0,)) for _ in range(9)])
        res = evaluate_space(empty, wl)
        for f in DseResult._fields:
            col = getattr(res, f)
            assert col.shape == (0,) and col.dtype == RESULT_DTYPES[f], f

    def test_chunked_and_single_columns_match(self):
        wl = resnet_cifar(20, device=CPU)
        cfgs = enumerate_space(SPACE, max_points=20, seed=5, device=CPU)
        one, chunked = (evaluate_space(cfgs, wl),
                        evaluate_space(cfgs, wl, chunk_size=7))
        for res in (one, chunked):
            for f in DseResult._fields:
                assert getattr(res, f).dtype == RESULT_DTYPES[f], f
        _assert_results_equal(one, chunked)


class TestArchiveNaNGuard:
    def test_nan_rows_rejected_with_clear_error(self):
        archive = ParetoArchive(3)
        archive.update(np.zeros((2, 3)))
        with pytest.raises(ValueError, match="NaN"):
            archive.update(np.array([[1.0, 2.0, 3.0], [np.nan, 0.0, 0.0]]))

    def test_archive_state_unchanged_after_rejection(self):
        archive = ParetoArchive(2)
        archive.update(np.array([[1.0, 1.0]]))
        before = (archive.objectives.copy(), archive.indices.copy())
        with pytest.raises(ValueError):
            archive.update(np.array([[np.nan, 5.0]]))
        np.testing.assert_array_equal(archive.objectives, before[0])
        np.testing.assert_array_equal(archive.indices, before[1])
        archive.update(np.array([[2.0, 2.0]]))
        assert len(archive) == 1


class TestChunkFrontMask:
    @given(seed=st.integers(0, 100), n=st.integers(1, 600),
           d=st.integers(3, 4), block=st.integers(16, 128))
    @settings(max_examples=20, deadline=None)
    def test_matches_dense_oracle(self, seed, n, d, block):
        rng = np.random.default_rng(seed)
        pts = np.round(rng.normal(size=(n, d)), 1)   # ties + duplicates
        pts[rng.integers(0, n, n // 4)] = pts[rng.integers(0, n, n // 4)]
        dense = pareto_mask_dense(torch.as_tensor(pts)).numpy()
        np.testing.assert_array_equal(
            ParetoArchive._chunk_front_mask(pts, block=block), dense)

    def test_dominated_by_helper(self):
        front = np.array([[2.0, 2.0], [0.0, 3.0]])
        pts = np.array([[1.0, 1.0], [2.0, 2.0], [3.0, 0.0], [-1.0, 2.5]])
        np.testing.assert_array_equal(
            _dominated_by(pts, front), [True, False, False, True])
        assert _dominated_by(pts, np.empty((0, 2))).sum() == 0


def test_fully_mixed_stream_equals_per_model_dense_front():
    """The mixed stream decodes to exactly the per-model front, whose
    members are mutually non-dominated."""
    models = (model_entry(resnet_cifar(20, device=CPU)),
              model_entry(vgg16("cifar10", width_mult=0.5, device=CPU)),
              model_entry(transformer_gemm(seq=64, d_model=64, n_layers=2,
                                           n_heads=2, d_ff=128, vocab=512,
                                           device=CPU)))
    mixed = coexplore_front(models, SPACE, chunk_size=64)
    oracle = coexplore_front(models, SPACE, chunk_size=64, mix_models=False)
    np.testing.assert_array_equal(np.sort(mixed.archive.indices),
                                  np.sort(oracle.archive.indices))
    order = np.argsort(oracle.archive.indices)
    objs = oracle.archive.objectives[order]
    assert pareto_mask_dense(torch.as_tensor(objs)).numpy().all()
