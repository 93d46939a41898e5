"""``chip_smoke.py`` phase 20.1's bounds on the CPU: the twin runs
(``tp_check.train_run``'s ``nudge``) and how a split training run is held
against the one-rank run within the larger of a fixed tolerance and twice
the twins' spread.  The phase itself needs the card."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from repro_torch import tp_check


def test_twin_moves_the_embedding_alone():
    """``tp_check.train_run``'s ``nudge`` (``chip_smoke.py`` 20.1's twins)
    scales the embedding by 1 + nudge before the first step and leaves
    every other leaf as drawn."""
    from repro_torch.configs import reduced
    cfg = reduced("rwkv6-1.6b").replace(dtype="float32", pe_type="fp32")
    nudge = float(np.finfo(np.float32).eps)
    base = tp_check.train_run(cfg, 1, 2, 8, "cpu")
    twin = tp_check.train_run(cfg, 1, 2, 8, "cpu", nudge=nudge)
    for k, v in base["start"].items():
        want = v * np.float32(1 + nudge) if k == "embed" else v
        np.testing.assert_array_equal(twin["start"][k], want, err_msg=k)


@pytest.fixture(scope="module")
def smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run(rows, start, final):
    return ({"rows": rows, "launches": [{}]},
            {**{f"start/{k}": np.asarray(v, np.float32)
                for k, v in start.items()},
             **{f"final/{k}": np.asarray(v, np.float32)
                for k, v in final.items()}})


@pytest.mark.parametrize("twin_rows,split_rows,held", [
    # well conditioned: the twins within 1e-7, the fixed 1e-4 the bound
    ([[10.0, 20.000001], [9.0, 30.0]], [[10.0, 20.0005], [9.0, 30.0]], True),
    ([[10.0, 20.000001], [9.0, 30.0]], [[10.0, 20.004], [9.0, 30.0]], False),
    # the twins' gradient norm 50% off at the first step: the bound twice
    # that at both steps (the spread carried on)
    ([[10.0, 30.0], [9.0, 30.0]], [[10.0, 20.0], [9.0, 58.0]], True),
    ([[10.0, 30.0], [9.0, 30.0]], [[10.0, 20.0], [9.0, 62.0]], False),
    # the loss held by its own spread, not the gradient norm's
    ([[10.0, 30.0], [9.0, 30.0]], [[10.01, 20.0], [9.0, 30.0]], False),
])
def test_smoke_holds_split_runs_within_the_twins_spread(
        smoke, twin_rows, split_rows, held):
    """``chip_smoke.py`` 20.1's bounds: a step's loss and gradient norm
    within the larger of the fixed tolerance and twice the twins' largest
    relative spread up to that step; the params' change gap of a twin
    taken from its own (nudged) start."""
    start = {"w": [1.0, 2.0, 3.0, 4.0]}
    final = {"w": [1.1, 1.9, 3.1, 3.9]}
    one = _run([[10.0, 20.0], [9.0, 30.0]], start, final)
    twin = _run(twin_rows, {"w": [1.5, 2.5, 3.5, 4.5]},
                {"w": [1.6, 2.4, 3.6, 4.4]})
    floor = smoke._ssm_floor(one, [twin, twin], 1e-4, 0.03)
    assert floor["twin_gaps"] == [pytest.approx(0.0, abs=1e-6)] * 2
    assert floor["gap"] == 0.03
    meta, arr = _run(split_rows, start, final)
    h = smoke._ssm_train_held(dict(meta, launches=one[0]["launches"]), arr,
                              one, arr, floor)
    assert h["held"]["ok"] is held, h["held"]
    assert h["param_gap"] == 0.0 and h["ranks_differ"] == []
