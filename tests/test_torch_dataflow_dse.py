"""repro_torch's workloads, dataflow cost model and DSE against repro's,
on the CPU."""

import jax
import numpy as np
import pytest
import torch

from repro.core import arch as ja, dataflow as jdf, dse as jd, \
    workloads as jw
from repro_torch import quickstart
from repro_torch.core import arch as ta, dataflow as tdf, dse as td, \
    workloads as tw

from _torch_helpers import (assert_columns_close, jax_models_equal_per_type,
                            port_config, port_models, port_workload)

# DseResult columns agree to ~8e-6: XLA fuses the synthesis-noise
# argument's products into FMAs, and sin/cos of arguments in the
# thousands turn that into ~1e-5 relative in area and clock.  The energy
# columns differ at f32 ulp even between two of the reference's own
# evaluators (ROADMAP queue C).
RTOL = quickstart.RTOL

WORKLOADS = {"vgg16-cifar10": (lambda: jw.vgg16("cifar10"),
                               lambda: tw.vgg16("cifar10", device="cpu")),
             "resnet20-cifar10": (lambda: jw.resnet_cifar(20),
                                  lambda: tw.resnet_cifar(20, device="cpu"))}


@pytest.fixture(scope="module")
def grid():
    jcfg = ja.enumerate_space()
    return jcfg, port_config(jcfg)


@pytest.fixture(scope="module")
def models():
    jm = jax_models_equal_per_type()
    return jm, port_models(jm)


@pytest.fixture(scope="module")
def results(grid, models):
    """(jax result, port result) per (workload, backend) on the paper grid."""
    jcfg, tcfg = grid
    out = {}
    for wl, (jmk, tmk) in WORKLOADS.items():
        jwl, twl = jmk(), tmk()
        for backend, jsur, tsur in (("oracle", None, None),
                                    ("surrogate", *models)):
            out[wl, backend] = (jd.evaluate_space(jcfg, jwl, surrogate=jsur),
                                td.evaluate_space(tcfg, twl, surrogate=tsur))
    return out


CASES = [(wl, b) for wl in WORKLOADS for b in ("oracle", "surrogate")]


@pytest.mark.parametrize("wl,backend", CASES)
def test_result_columns(results, wl, backend):
    jres, tres = results[wl, backend]
    assert all(c.dtype == np.float64 for c in tres)
    assert_columns_close(jres, tres, RTOL)


@pytest.mark.parametrize("wl,backend", CASES)
def test_pareto_front_membership(results, wl, backend):
    """Front index sets agree; a flip is tolerated only at a near-tie
    (the point's status changes under an RTOL perturbation)."""
    jres, tres = results[wl, backend]
    want = np.flatnonzero(np.asarray(jd.pareto_front(jres)))
    got = np.flatnonzero(np.asarray(td.pareto_front(tres)))
    ties, bad = quickstart.front_flips(quickstart._objectives(tres), got,
                                       want, RTOL)
    assert not bad, f"front flips away from a near-tie: {bad}"
    assert len(ties) <= 1, ties


@pytest.mark.parametrize("wl,backend", CASES)
def test_normalized_report_and_spread(grid, results, wl, backend):
    jres, tres = results[wl, backend]
    jrep = jd.report_pe_types(jd.normalized_report(jres, grid[0]))
    trep = td.normalized_report(tres, grid[1])
    problems, _ = quickstart._report_problems(tres, trep, jrep, RTOL, wl)
    assert not problems, problems
    assert td.report_pe_types(trep).keys() == jrep.keys()
    for key, val in jd.spread(jres).items():
        assert np.isclose(td.spread(tres)[key], val, rtol=RTOL, atol=0), key


@pytest.mark.parametrize("backend", ["oracle", "surrogate"])
def test_chunked_equals_unchunked_bitwise(grid, models, backend):
    tcfg, twl = grid[1], tw.vgg16("cifar10", device="cpu")
    sur = None if backend == "oracle" else models[1]
    whole = td.evaluate_space(tcfg, twl, surrogate=sur)
    chunked = td.evaluate_space(tcfg, twl, surrogate=sur, chunk_size=4096)
    for f, a, b in zip(whole._fields, whole, chunked):
        np.testing.assert_array_equal(b, a, err_msg=f)


def test_mapped_space_prices_every_mapping_code():
    jcfg = ja.enumerate_space(ja.MAPPED_SPACE, max_points=3000, seed=5)
    jres = jd.evaluate_space(jcfg, jw.vgg16("cifar10"))
    tres = td.evaluate_space(port_config(jcfg),
                             tw.vgg16("cifar10", device="cpu"))
    assert len(np.unique(np.asarray(jcfg.mapping))) == ta.MAPPING_CHOICES
    assert_columns_close(jres, tres, RTOL)


def test_layer_cost_with_ir_kinds():
    """Per-layer costs of streamed-KV and gated-expert layers on mapped
    design points, against the reference's vmapped layer_cost."""
    rows = [jw.gemm(1, 512, 4096, kind=jw.KIND_ATTN_KV, stream_words=65536.0,
                    batch=4),
            jw.gemm(8, 1024, 2048, kind=jw.KIND_MOE_EXPERT, active_frac=0.25,
                    count=3),
            jw.conv(14, 14, 256, 256, 3, stride=2, batch=2),
            dict(jw.gemm(1, 8, 8), count=0)]
    names = [f"l{i}" for i in range(len(rows))]
    jwl = jw._stack(rows, "ir", names)
    twl = tw._stack(rows, "ir", names, device="cpu")
    carried = port_workload(jwl)
    assert carried.layer_names == twl.layer_names
    for f, a, b in zip(tw.LayerSpec._fields, carried.layers, twl.layers):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=f)
    jcfg = ja.enumerate_space(ja.MAPPED_SPACE, max_points=64, seed=2)
    clock = np.linspace(0.3, 1.2, 64, dtype=np.float32)
    jcost = jax.vmap(jdf.network_cost, in_axes=(None, 0, 0))(
        jwl.layers, jcfg, clock)
    tcost = tdf.network_cost(twl.layers, port_config(jcfg),
                             torch.as_tensor(clock))
    for f in jdf.LayerCost._fields:
        np.testing.assert_allclose(getattr(tcost, f).numpy(),
                                   np.asarray(getattr(jcost, f)),
                                   rtol=RTOL, err_msg=f)
    one = tdf.network_cost(twl.layers, ta.make_config(device="cpu"),
                           torch.tensor(0.5))
    assert one.macs.ndim == 0


@pytest.mark.parametrize("fn,args,kw", [
    ("vgg16", ("cifar10",), {}), ("vgg16", ("imagenet",), {}),
    ("vgg16", ("cifar100",), dict(width_mult=0.5, resolution=48)),
    ("resnet_cifar", (20,), {}), ("resnet_cifar", (56, "cifar100"), {})])
def test_workloads_identical(fn, args, kw):
    jwl = getattr(jw, fn)(*args, **kw)
    twl = getattr(tw, fn)(*args, **kw, device="cpu")
    assert (twl.name, twl.layer_names) == (jwl.name, jwl.layer_names)
    for f in jw.LayerSpec._fields:
        np.testing.assert_array_equal(getattr(twl.layers, f).numpy(),
                                      np.asarray(getattr(jwl.layers, f)))
    assert tw.workload_macs(twl) == jw.workload_macs(jwl)
    assert tw.workload_macs(twl, True) == jw.workload_macs(jwl, True)


def test_vgg16_weight_shapes():
    shapes = tw.weight_shapes(tw.vgg16("cifar10", device="cpu"))
    assert len(shapes) == 15 and shapes[0] == (27, 64) and \
        shapes[-1] == (512, 10)
    assert sum(k * n for k, n in shapes) == 14_977_728


@pytest.mark.parametrize("n,d", [(300, 2), (257, 3), (40, 4)])
def test_pareto_masks_match_reference(n, d):
    rng = np.random.default_rng(n)
    obj = rng.integers(0, 12, (n, d)).astype(np.float64)  # many duplicates
    want = np.asarray(jd.pareto_mask_dense(obj))
    t = torch.as_tensor(obj)
    np.testing.assert_array_equal(td.pareto_mask_dense(t).numpy(), want)
    np.testing.assert_array_equal(td.pareto_mask_tiled(t, 64).numpy(), want)
    np.testing.assert_array_equal(td.pareto_mask(obj).numpy(), want)
    if d == 2:
        np.testing.assert_array_equal(td.pareto_mask_2d(obj), want)
    with pytest.raises(ValueError):
        td.pareto_mask(obj, method="nope")


def test_empty_and_single_point():
    twl = tw.vgg16("cifar10", device="cpu")
    empty = td.evaluate_space(ta.space_points(np.arange(0), device="cpu"), twl)
    assert all(c.shape == (0,) and c.dtype == np.float64 for c in empty)
    jres = jd.evaluate_chunk(ja.make_config(pe_type="lightpe2"),
                             jw.vgg16("cifar10"))
    tres = td.evaluate_chunk(ta.make_config(pe_type="lightpe2", device="cpu"),
                             twl)
    assert_columns_close(jres, tres, RTOL)


def test_best_index_falls_back_without_the_type(results, grid):
    _, tres = results["vgg16-cifar10", "oracle"]
    pt = grid[1].pe_type
    assert td.best_index(tres, pt, 2) == jd.best_index(
        tres, np.asarray(grid[0].pe_type), 2)
    only_fp32 = torch.zeros_like(pt)
    assert td.best_index(tres, only_fp32, 3) == int(
        np.argmax(tres.perf_per_area))
