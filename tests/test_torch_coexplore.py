"""repro_torch's joint co-exploration against repro's, on the CPU
(mirrors ``tests/test_coexplore.py``): the joint space index for index,
the accuracy surrogate exactly, the streaming 3-objective front against
the dense oracle and against the reference's front, the port's bitwise
mixed / per-model and pruned / single-stage contracts, the LightPE claim,
and ``tests/data/torch_coexplore_ref.json`` kept honest."""

import itertools
import json

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # CI images without hypothesis: deterministic fallback
    from _hypothesis_fallback import given, settings, st

from repro.core import accuracy as ja, arch as jarch, coexplore as jc, \
    workloads as jw
from repro.core.pe import ACC_DELTA_PP as J_ACC_DELTA_PP
from repro_torch import coexplore_check as check
from repro_torch.core import (AccuracySurrogate, Budget, ModelEntry,
                              PE_TYPE_CODES, PE_TYPE_NAMES, capacity_scale,
                              coexplore_front, coexplore_report,
                              default_model_set, enumerate_space,
                              evaluate_space_streaming,
                              iter_joint_space_chunks, joint_space_points,
                              joint_space_size, lightpe_claim, llm_decode,
                              llm_moe, model_entry, pareto_mask_dense,
                              resnet_cifar, seeded_base_accuracy, space_size,
                              transformer_gemm, vgg16, workload_macs)
from repro_torch.configs import reduced
from repro_torch.core.arch import AcceleratorConfig
from repro_torch.core.pe import ACC_DELTA_BY_NAME, ACC_DELTA_PP

import _torch_coexplore_ref

CPU = "cpu"
# 2*2*1*1*2*1*5*1 = 40 accelerator points: joint sweeps stay fast.
TINY_SPACE = dict(
    pe_rows=(8, 12), pe_cols=(8, 14), gbuf_kb=(54.0,), spad_ifmap=(12,),
    spad_filter=(112, 224), spad_psum=(16,),
    pe_type=tuple(range(5)), bandwidth_gbps=(25.6,),
)


def _config_matrix(cfg: AcceleratorConfig) -> np.ndarray:
    return np.stack([torch.as_tensor(getattr(cfg, f)).double().numpy()
                     for f in AcceleratorConfig._fields], axis=-1)


def _jax_matrix(cfg) -> np.ndarray:
    return np.stack([np.asarray(getattr(cfg, f), np.float64)
                     for f in cfg._fields], axis=-1)


@pytest.fixture(scope="module")
def tiny_models():
    return (model_entry(resnet_cifar(20, device=CPU)),
            model_entry(resnet_cifar(20, resolution=16, device=CPU)),
            model_entry(transformer_gemm(seq=128, d_model=128, n_layers=2,
                                         n_heads=4, d_ff=256, vocab=1024,
                                         device=CPU)))


@pytest.fixture(scope="module")
def serving_models():
    """Decode and MoE members on the phase-aware IR beside a CNN lane."""
    return (
        model_entry(llm_decode(reduced("qwen3-32b"), context=256,
                               device=CPU), acc_classes=True),
        model_entry(llm_moe(reduced("deepseek-moe-16b"), seq=64,
                            mode="decode", device=CPU), acc_classes=True),
        model_entry(resnet_cifar(20, device=CPU)),
    )


class TestJointSpace:
    def test_size(self):
        assert joint_space_size(TINY_SPACE, 3) == 3 * space_size(TINY_SPACE)
        with pytest.raises(ValueError):
            joint_space_size(TINY_SPACE, 0)

    def test_decode_matches_nested_product(self):
        a = space_size(TINY_SPACE)
        accel = _config_matrix(enumerate_space(TINY_SPACE, device=CPU))
        ref = [(m, tuple(accel[i])) for m, i in
               itertools.product(range(3), range(a))]
        mids, cfg = joint_space_points(np.arange(3 * a), TINY_SPACE, 3,
                                       device=CPU)
        assert list(zip(mids.tolist(), map(tuple, _config_matrix(cfg)))) \
            == ref

    def test_decode_out_of_range_raises(self):
        with pytest.raises(ValueError):
            joint_space_points(np.array([3 * space_size(TINY_SPACE)]),
                               TINY_SPACE, 3, device=CPU)

    @pytest.mark.parametrize("kw", [
        dict(), dict(group_by_model=True), dict(model_groups=((2, 0), (1,))),
        dict(max_points=25, seed=5), dict(max_points=40, seed=9,
                                          group_by_model=True),
        dict(start_chunk=3), dict(max_points=25, seed=5, start_chunk=2,
                                  model_groups=((1,), (0, 2)))])
    def test_chunks_equal_reference(self, kw):
        """Index for index, the reference's chunk stream."""
        want = list(jarch.iter_joint_space_chunks(
            TINY_SPACE, num_models=3, chunk_size=7, **kw))
        got = list(iter_joint_space_chunks(TINY_SPACE, num_models=3,
                                           chunk_size=7, device=CPU, **kw))
        assert len(got) == len(want)
        for (gm, gc, gi), (wm, wc, wi) in zip(got, want):
            np.testing.assert_array_equal(gm, wm)
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(_config_matrix(gc), _jax_matrix(wc))
            assert gc.pe_type.dtype == torch.int32

    @given(chunk=st.integers(1, 50), num_models=st.integers(1, 4))
    @settings(max_examples=10, deadline=None)
    def test_grouped_chunks_never_mix_models(self, chunk, num_models):
        a = space_size(TINY_SPACE)
        seen = []
        for m, cfg, idx in iter_joint_space_chunks(
                TINY_SPACE, num_models=num_models, chunk_size=chunk,
                group_by_model=True, device=CPU):
            assert 0 < len(idx) <= chunk
            np.testing.assert_array_equal(idx // a, m)
            seen.append(idx)
        np.testing.assert_array_equal(np.concatenate(seen),
                                      np.arange(num_models * a))

    @given(chunk=st.integers(1, 50), num_models=st.integers(1, 4))
    @settings(max_examples=10, deadline=None)
    def test_mixed_chunks_cover_space_densely(self, chunk, num_models):
        a = space_size(TINY_SPACE)
        n = num_models * a
        seen, sizes = [], []
        for mids, cfg, idx in iter_joint_space_chunks(
                TINY_SPACE, num_models=num_models, chunk_size=chunk,
                device=CPU):
            np.testing.assert_array_equal(mids, idx // a)
            seen.append(idx)
            sizes.append(len(idx))
        np.testing.assert_array_equal(np.concatenate(seen), np.arange(n))
        assert all(s == chunk for s in sizes[:-1])

    def test_model_groups_validated(self):
        with pytest.raises(ValueError):
            list(iter_joint_space_chunks(TINY_SPACE, num_models=2,
                                         model_groups=((0, 2),), device=CPU))
        with pytest.raises(ValueError):
            list(iter_joint_space_chunks(TINY_SPACE, num_models=2,
                                         model_groups=((0,), (0, 1)),
                                         device=CPU))


class TestAccuracySurrogate:
    def test_delta_tables_equal_reference(self):
        assert ACC_DELTA_BY_NAME == ja.ACC_DELTA_BY_NAME
        np.testing.assert_array_equal(ACC_DELTA_PP.numpy(),
                                      np.asarray(J_ACC_DELTA_PP))
        for code, name in enumerate(PE_TYPE_NAMES):
            assert float(ACC_DELTA_PP[code]) == pytest.approx(
                ACC_DELTA_BY_NAME[name])

    def test_delta_array_is_float32_on_the_device(self):
        s = AccuracySurrogate()
        got = s.delta_array(macs=1e9, device=CPU)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(ja.AccuracySurrogate().delta_array(
                macs=1e9)))

    @pytest.mark.parametrize("macs", [1.0, 1e6, 4.1e7, 1e9, 3.3e10, 1e12])
    def test_capacity_and_base_equal_reference(self, macs):
        assert capacity_scale(macs) == ja.capacity_scale(macs)
        for name in ("resnet20-cifar10-w2", "mystery-net", "vgg16-imagenet"):
            assert seeded_base_accuracy(name, macs) \
                == ja.seeded_base_accuracy(name, macs)

    def test_predictions_equal_reference(self):
        mine, ref = AccuracySurrogate(), ja.AccuracySurrogate()
        for s in (mine, ref):
            s.calibrate("resnet20-cifar10", "fp32", 0.880)
        mix = (0.1, 0.5, 0.3, 0.1)
        for model in ("resnet20-cifar10", "resnet56-cifar10", "x-net"):
            for m in (None, 4.1e7, 2e9):
                np.testing.assert_array_equal(
                    mine.predict_per_type(model, m, class_mix=mix),
                    ref.predict_per_type(model, m, class_mix=mix))

    def test_calibration_overrides_seeds(self):
        s = AccuracySurrogate()
        s.calibrate("resnet20-cifar10", "lightpe1", 0.873)
        assert s.predict("resnet20-cifar10", "lightpe1") == 0.873
        s.calibrate("resnet20-cifar10", "fp32", 0.880)
        assert s.predict("resnet20-cifar10", "int16", macs=4.1e7) \
            == pytest.approx(0.880 - 0.1 / 100.0)
        assert s.predict("resnet56-cifar10", "fp32") \
            == seeded_base_accuracy("resnet56-cifar10")

    def test_unknown_pe_rejected(self):
        with pytest.raises(KeyError):
            AccuracySurrogate().delta_pp("bf16")
        with pytest.raises(KeyError):
            AccuracySurrogate(deltas_pp={"bf16": -1.0})
        for name, code in PE_TYPE_CODES.items():
            assert AccuracySurrogate().delta_pp(name) \
                == AccuracySurrogate().delta_pp(code)

    def test_load_qat_results(self, tmp_path):
        table = {"fp32": {"top1_mean": 0.41, "top1_std": 0.01},
                 "lightpe1": {"top1_mean": 0.39, "top1_std": 0.02},
                 "not_a_pe": {"top1_mean": 0.5}}
        p = tmp_path / "qat_pareto.json"
        p.write_text(json.dumps(table))
        s = AccuracySurrogate()
        assert s.load_qat_results(str(p), model_name="resnet8-syn") == 2
        assert s.predict("resnet8-syn", "lightpe1") == 0.39
        assert s.predict("resnet8-syn", "fp32") == 0.41


class TestModelFamilies:
    def test_scaling(self):
        base = workload_macs(resnet_cifar(20, device=CPU))
        assert workload_macs(resnet_cifar(20, width_mult=2.0, device=CPU)) \
            / base == pytest.approx(4.0, rel=0.15)
        assert base / workload_macs(resnet_cifar(20, resolution=16,
                                                 device=CPU)) \
            == pytest.approx(4.0, rel=0.4)
        assert resnet_cifar(20, width_mult=2.0, device=CPU).name \
            == "resnet20-cifar10-w2"
        assert vgg16("cifar10", width_mult=0.5, device=CPU).name \
            == "vgg16-cifar10-w0.5"

    def test_degenerate_resolutions_rejected(self):
        with pytest.raises(ValueError):
            vgg16("cifar10", resolution=8, device=CPU)
        with pytest.raises(ValueError):
            resnet_cifar(20, resolution=2, device=CPU)

    def test_default_model_set(self):
        models = default_model_set(device=CPU)
        assert len(models) == 13
        assert len({m.name for m in models}) == 13
        assert all(isinstance(m, ModelEntry) and m.macs > 0
                   and 0.0 < m.base_acc <= 1.0 for m in models)

    def test_model_entry_capacity_is_batch_invariant(self):
        e1 = model_entry(resnet_cifar(20, batch=1, device=CPU))
        e8 = model_entry(resnet_cifar(20, batch=8, device=CPU))
        assert e8.macs == pytest.approx(e1.macs)
        assert e8.base_acc == e1.base_acc


class TestJointFrontEquivalence:
    def test_streamed_joint_front_equals_dense(self, tiny_models):
        acc = AccuracySurrogate()
        a = space_size(TINY_SPACE)
        codes_all = enumerate_space(TINY_SPACE, device=CPU).pe_type.numpy()
        objs = []
        for entry in tiny_models:
            acc_col = acc.predict_per_type(entry.name, entry.macs,
                                           entry.base_acc)
            for res, idx in evaluate_space_streaming(
                    entry.workload, TINY_SPACE, chunk_size=16):
                macs = res.macs
                objs.append(np.stack([
                    acc_col[codes_all[idx].astype(int)],
                    macs / np.maximum(res.latency_s, 1e-12)
                    / np.maximum(res.area_mm2, 1e-9),
                    -(res.energy_j / np.maximum(macs, 1.0) * 1e12)], -1))
        dense_obj = np.concatenate(objs)
        assert dense_obj.shape == (3 * a, 3)
        dense = set(np.flatnonzero(pareto_mask_dense(
            torch.as_tensor(dense_obj)).numpy()).tolist())
        front = coexplore_front(tiny_models, TINY_SPACE, chunk_size=16)
        assert front.points_evaluated == 3 * a
        assert set(front.archive.indices.tolist()) == dense

    @pytest.mark.parametrize("axis", ["tiny", "serving"])
    @pytest.mark.parametrize("chunk", [7, 16])
    def test_mixed_front_equals_per_model_front_bitwise(
            self, tiny_models, serving_models, axis, chunk):
        models = tiny_models if axis == "tiny" else serving_models
        mixed = coexplore_front(models, TINY_SPACE, chunk_size=chunk)
        oracle = coexplore_front(models, TINY_SPACE, chunk_size=chunk,
                                 mix_models=False)
        assert check.identical(mixed, oracle) == []
        assert mixed.buckets and not oracle.buckets

    @pytest.mark.parametrize("mix", [True, False])
    def test_pruned_walk_equals_single_stage_bitwise(self, serving_models,
                                                     mix):
        budget = Budget(area_mm2=1.6, min_accuracy=0.5)
        a = coexplore_front(serving_models, TINY_SPACE, chunk_size=7,
                            budget=budget, mix_models=mix)
        b = coexplore_front(serving_models, TINY_SPACE, chunk_size=7,
                            budget=budget, mix_models=mix, prune=False)
        assert check.identical(a, b) == []
        assert a.budget_stats.pruned > 0 == b.budget_stats.pruned

    def test_subsample_front_is_subset_of_full(self, tiny_models):
        full = coexplore_front(tiny_models, TINY_SPACE, chunk_size=16)
        sub = coexplore_front(tiny_models, TINY_SPACE, chunk_size=16,
                              max_points=60, seed=2)
        assert sub.points_evaluated == 60
        for o in sub.archive.objectives:
            assert not (o > full.archive.objectives).all(axis=-1).any()


@pytest.fixture(scope="module")
def reference_pair():
    """A decode member and two CNNs on the paper grid at 3,000 subsampled
    joint points: the JAX package's front and the port's."""
    from repro.configs import reduced as jax_reduced
    kw = dict(max_points=3000, seed=1, chunk_size=512)
    want = jc.coexplore_front((
        jc.model_entry(jw.llm_decode(jax_reduced("qwen3-32b"), context=256),
                       acc_classes=True),
        jc.model_entry(jw.resnet_cifar(20)),
        jc.model_entry(jw.vgg16("cifar10", width_mult=0.5))), **kw)
    got = coexplore_front((
        model_entry(llm_decode(reduced("qwen3-32b"), context=256,
                               device=CPU), acc_classes=True),
        model_entry(resnet_cifar(20, device=CPU)),
        model_entry(vgg16("cifar10", width_mult=0.5, device=CPU))), **kw)
    return want, got


def test_front_matches_reference(reference_pair):
    """Index set (near ties allowed), objectives at RTOL, per-(model, PE)
    bests and the claim's per-model verdicts exactly."""
    want, got = reference_pair
    problems, _ = check.compare(
        check.summary(got, coexplore_report(got)),
        json.loads(json.dumps(check.summary(want, jc.coexplore_report(want)))))
    assert problems == []
    assert sorted(got.archive.indices) == sorted(want.archive.indices)
    assert got.points_evaluated == want.points_evaluated == 3000


class TestCoexploreReport:
    @pytest.fixture(scope="class")
    def report(self, tiny_models):
        return coexplore_report(
            coexplore_front(tiny_models, TINY_SPACE, chunk_size=16))

    def test_points_decode_to_named_models_and_pes(self, report,
                                                   tiny_models):
        names = {m.name for m in tiny_models}
        assert report["front_size"] == len(report["points"]) > 0
        for p in report["points"]:
            assert p["model"] in names and p["pe_type"] in PE_TYPE_NAMES
            assert set(p["config"]) == set(AcceleratorConfig._fields)
            assert p["energy_per_mac_pj"] > 0 and 0 < p["accuracy"] <= 1.0
        assert sum(report["front_counts"]["by_model"].values()) \
            == report["front_size"]

    def test_lightpe_claim_holds_on_seeded_surrogate(self, report):
        claim = report["claim"]
        assert claim["holds"] is True and claim["indeterminate"] == 0
        for verdict in claim["per_model"].values():
            for lp in ("lightpe1", "lightpe2"):
                assert verdict[lp]["within_1pp"] is True
                assert verdict[lp]["beats_int16_bests"] is True

    def test_claim_indeterminate_without_reference_pes(self, tiny_models):
        no_ref = dict(TINY_SPACE, pe_type=(PE_TYPE_CODES["lightpe1"],
                                           PE_TYPE_CODES["lightpe2"]))
        claim = lightpe_claim(coexplore_front(tiny_models[:1], no_ref,
                                              chunk_size=16))
        assert claim["holds"] is False and claim["indeterminate"] == 1
        (verdict,) = claim["per_model"].values()
        assert verdict["ok"] is None and "indeterminate" in verdict["note"]

    def test_empty_model_axis_rejected(self):
        with pytest.raises(ValueError):
            coexplore_front((), TINY_SPACE)

    @pytest.mark.parametrize("kw,item", [
        (dict(shards=2), "A7"), (dict(checkpoint_dir="ck"), "A7"),
        (dict(max_chunks=1), "A7"), (dict(driver="evolve"), "A8")])
    def test_unported_knobs_raise(self, tiny_models, kw, item, tmp_path):
        """The knobs of ROADMAP A7 / A8 are ported: the sharded and
        checkpointed walks give the plain walk's front bit for bit,
        ``max_chunks`` stops after that many chunks, and a search with
        the whole space as its budget recovers the enumerated front."""
        if "checkpoint_dir" in kw:
            kw = dict(checkpoint_dir=str(tmp_path / kw["checkpoint_dir"]))
        want = coexplore_front(tiny_models, TINY_SPACE, chunk_size=16)
        got = coexplore_front(tiny_models, TINY_SPACE, chunk_size=16, **kw)
        if "max_chunks" in kw:
            assert got.points_evaluated == 16
            return
        if item == "A8":
            assert sorted(got.archive.indices.tolist()) == \
                sorted(want.archive.indices.tolist())
            return
        # a merged front's row order is the merge's: compare by index
        go, wo = np.argsort(got.archive.indices), np.argsort(
            want.archive.indices)
        np.testing.assert_array_equal(got.archive.indices[go],
                                      want.archive.indices[wo])
        np.testing.assert_array_equal(got.archive.objectives[go],
                                      want.archive.objectives[wo])
        assert got.per_model_best == want.per_model_best


class TestReferenceFile:
    """``tests/data/torch_coexplore_ref.json`` is what the JAX package
    computes, and the port's 4,500-point walk is held to it."""

    @pytest.fixture(scope="class")
    def ref(self):
        return json.loads(_torch_coexplore_ref.REF_PATH.read_text())

    def test_subsampled_run_rebuilds_exactly(self, ref):
        rebuilt = json.loads(json.dumps(
            _torch_coexplore_ref.build_reference(runs=["budget_4500"])))
        assert rebuilt["runs"]["budget_4500"] == ref["runs"]["budget_4500"]
        assert rebuilt["accuracy_matrix"] == ref["accuracy_matrix"]
        assert rebuilt["models"] == ref["models"]

    def test_port_subsampled_run_matches_file(self, ref):
        spec = check.RUNS["budget_4500"]
        front = coexplore_front(default_model_set(device=CPU),
                                max_points=spec["max_points"],
                                budget=Budget(**spec["budget"]))
        problems, _ = check.compare(
            check.summary(front, coexplore_report(front)),
            ref["runs"]["budget_4500"])
        assert problems == []

    def test_file_layout(self, ref):
        assert set(ref["runs"]) == set(check.RUNS)
        full = ref["runs"]["unconstrained"]
        assert full["points_evaluated"] == full["space_size"] == 351_000
        assert full["claim"]["holds"] is True
        assert ref["runs"]["area_0.9"]["budget"]["feasible"] == 60_216
