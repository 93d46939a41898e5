"""The port's joint co-exploration walk on the card.

Every test is marked ``gpu`` and skips without a card; imports no JAX,
so it runs on a machine without it:

  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_coexplore_gpu.py

On the card, as on the CPU, mixed-model lanes equal per-model lanes and
the two-stage walk equals the single-stage one, bit for bit; and the
card's walk equals the CPU port's at ``coexplore_check.RTOL``.
"""

import numpy as np
import pytest
import torch

from repro_torch import coexplore_check as check
from repro_torch import quickstart
from repro_torch.core import (Budget, arch, coexplore_front, coexplore_report,
                              default_model_set, fit_ppa_models)

POINTS = check.SUBSAMPLE


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the walk runs on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["oracle", "surrogate"])
def test_mixed_equals_per_model_on_card(card, backend):
    models = default_model_set(device=card)
    surrogate = None
    if backend == "surrogate":
        sample = arch.enumerate_space(max_points=quickstart.FIT_POINTS,
                                      seed=quickstart.SEED, device=card)
        surrogate = fit_ppa_models(sample, degrees=quickstart.DEGREES,
                                   k=quickstart.FOLDS, device=card)
    for chunk in (4096, 1000):
        mixed = coexplore_front(models, surrogate=surrogate,
                                max_points=POINTS, chunk_size=chunk)
        per = coexplore_front(models, surrogate=surrogate,
                              max_points=POINTS, chunk_size=chunk,
                              mix_models=False)
        assert check.identical(mixed, per) == []


@pytest.mark.gpu
def test_pruned_equals_single_stage_on_card(card):
    models = default_model_set(device=card)
    budget = Budget(area_mm2=0.9, min_accuracy=0.7)
    for mix in (True, False):
        pruned = coexplore_front(models, max_points=5 * POINTS,
                                 budget=budget, mix_models=mix)
        single = coexplore_front(models, max_points=5 * POINTS,
                                 budget=budget, mix_models=mix, prune=False)
        assert check.identical(pruned, single) == []
        assert pruned.budget_stats.pruned > 0


@pytest.mark.gpu
def test_card_front_equals_cpu_front(card):
    """Same points, same front index set, objectives and bests at RTOL,
    the same claim and budget counts."""
    budget = Budget(**check.RUNS["budget_4500"]["budget"])
    fronts = [coexplore_front(default_model_set(device=d), max_points=POINTS,
                              budget=budget) for d in (card, "cpu")]
    got, want = (check.summary(f, coexplore_report(f)) for f in fronts)
    problems, _ = check.compare(got, want)
    assert problems == []
    assert sorted(fronts[0].archive.indices) == sorted(
        fronts[1].archive.indices)
    np.testing.assert_array_equal(fronts[0].archive.objectives[:, 0][
        np.argsort(fronts[0].archive.indices)],
        fronts[1].archive.objectives[:, 0][np.argsort(
            fronts[1].archive.indices)])
