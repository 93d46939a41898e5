"""The port's DSE-at-scale walks on the card: the bitwise contracts with
several CUDA streams.

Every test is marked ``gpu`` and skips without a card; imports no JAX,
so it runs on a machine without it:

  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_scale_gpu.py

On the card every shard runs its chunks on its own stream (pinned
uploads, the copy back into a pinned buffer, an event a chunk), and the
walk stays bitwise what the single-stream walk gives: sharded ==
single-process, resumed == uninterrupted, telemetry on == off, a front
server response == a standalone walk, search shards 1 == 4.
"""

import numpy as np
import pytest
import torch

from repro_torch import coexplore_check as check
from repro_torch.core import (Budget, coexplore_front, default_model_set,
                              dispatch_chunk, enumerate_space, finish_chunk,
                              pareto_front_streaming, resnet_cifar,
                              search_front)
from repro_torch.core.arch import MAPPED_SPACE
from repro_torch.obs import Tracer, chrome_trace, trace_lanes
from repro_torch.serve import FrontServer

POINTS = 20_000


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the walks run on the card")
    return torch.device("cuda")


def _rows_equal(a, b):
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.objectives, b.objectives)


@pytest.mark.gpu
def test_pinned_dispatch_equals_device_configs(card):
    """A chunk decoded on the host and staged through pinned memory gives
    the columns of the same chunk built on the card, bit for bit."""
    wl = resnet_cifar(20, device=card)
    host_cfg = enumerate_space(max_points=3000, seed=1, device="cpu")
    dev_cfg = enumerate_space(max_points=3000, seed=1, device=card)
    a = finish_chunk(dispatch_chunk(host_cfg, wl, pad_to=4096))
    b = finish_chunk(dispatch_chunk(dev_cfg, wl, pad_to=4096))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [1, 2, 4])
def test_sharded_joint_walk_on_streams(card, depth):
    models = default_model_set(device=card)
    ref = coexplore_front(models, max_points=POINTS)
    with Tracer() as tr:
        got = coexplore_front(models, max_points=POINTS, shards=4,
                              pipeline_depth=depth, telemetry=tr)
    assert check.identical(got, ref) == []
    lanes = trace_lanes(chrome_trace(tr))
    assert {f"shard{i}" for i in range(4)} <= set(lanes)


@pytest.mark.gpu
def test_sharded_pruned_walk_on_streams(card):
    models = default_model_set(device=card)
    bud = Budget(area_mm2=0.9, min_accuracy=0.7)
    ref = coexplore_front(models, max_points=POINTS, budget=bud)
    got = coexplore_front(models, max_points=POINTS, budget=bud, shards=3)
    assert check.identical(got, ref) == []
    assert got.budget_stats.pruned == ref.budget_stats.pruned > 0


@pytest.mark.gpu
def test_plain_walk_across_devices_list(card):
    wl = resnet_cifar(20, device=card)
    ref, _ = pareto_front_streaming(wl, max_points=POINTS, chunk_size=1000)
    got, _ = pareto_front_streaming(wl, max_points=POINTS, chunk_size=1000,
                                    shards=5, devices=["cuda"] * 2)
    o1, o2 = np.argsort(ref.indices), np.argsort(got.indices)
    np.testing.assert_array_equal(ref.indices[o1], got.indices[o2])
    np.testing.assert_array_equal(ref.objectives[o1], got.objectives[o2])


@pytest.mark.gpu
def test_sharded_walk_across_cards(card):
    """Shards on every card (``cuda:{s % n}``): the workloads and the
    fitted surrogate are copied to each card and the front is the
    single-card walk's.  Needs two cards or more."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two cards or more")
    from repro_torch import quickstart
    from repro_torch.core import arch, fit_ppa_models
    models = default_model_set(device=card)
    sample = arch.enumerate_space(max_points=quickstart.FIT_POINTS,
                                  seed=quickstart.SEED, device=card)
    surrogate = fit_ppa_models(sample, degrees=quickstart.DEGREES,
                               k=quickstart.FOLDS, device=card)
    for kw in (dict(), dict(surrogate=surrogate),
               dict(budget=Budget(area_mm2=0.9))):
        ref = coexplore_front(models, max_points=POINTS, **kw)
        got = coexplore_front(models, max_points=POINTS, shards=2 * n, **kw)
        assert check.identical(got, ref) == []


@pytest.mark.gpu
def test_resumed_and_traced_walks_bitwise(card, tmp_path):
    models = default_model_set(device=card)
    kw = dict(max_points=POINTS, shards=4, pipeline_depth=2)
    whole = coexplore_front(models, **kw)
    ck = str(tmp_path / "ck")
    coexplore_front(models, checkpoint_dir=ck, checkpoint_every=1,
                    max_chunks=2, **kw)
    resumed = coexplore_front(models, checkpoint_dir=ck, **kw)
    _rows_equal(resumed.archive, whole.archive)
    assert resumed.per_model_best == whole.per_model_best
    with Tracer() as tr:
        traced = coexplore_front(models, telemetry=tr, **kw)
    _rows_equal(traced.archive, whole.archive)


@pytest.mark.gpu
def test_front_server_equals_standalone_on_card(card):
    models = default_model_set(device=card)
    budgets = (Budget(area_mm2=2.0), Budget(power_mw=250.0), None)
    srv = FrontServer(models, max_points=POINTS)
    qs = [srv.submit(b) for b in budgets]
    srv.run()
    for q, b in zip(qs, budgets):
        alone = coexplore_front(models, max_points=POINTS, budget=b,
                                prune=False)
        _rows_equal(q.response.archive, alone.archive)


@pytest.mark.gpu
@pytest.mark.parametrize("driver", ["evolve", "halving"])
def test_search_shard_counts_bitwise_on_card(card, driver):
    models = default_model_set(device=card)[:3]
    runs = [search_front(models, space=MAPPED_SPACE, driver=driver,
                         max_evals=9000, seed=2, shards=s)
            for s in (None, 4)]
    _rows_equal(runs[0].archive, runs[1].archive)
    assert runs[0].points_evaluated == runs[1].points_evaluated == 9000
