"""The port's quickstart loop against the JAX package's, and the committed
full-size reference results against a fresh JAX run."""

import json

import numpy as np
import pytest

from repro_torch import quickstart

from _torch_helpers import port_config
from _torch_quickstart_ref import REF_PATH, build_reference, jax_models


@pytest.fixture(scope="module")
def jax_fit():
    """The JAX quickstart's surrogate fit: 2000 points, degrees (1, 2),
    k=4 (shared: it is the slowest step of the module)."""
    return jax_models()


@pytest.fixture(scope="module")
def port_run():
    return quickstart.run(max_points=2000, device="cpu",
                          presets=("lightpe1", "lightpe2"))


def test_quickstart_matches_jax(jax_fit, port_run):
    """Front, normalized report, chosen LightPE-1 config, surrogate
    degrees and R^2 of examples/quickstart.py's settings."""
    ref = build_reference(max_points=2000, models=jax_fit)
    problems, notes = quickstart.compare(port_run, ref)
    assert not problems, problems
    assert len(notes) <= 1, notes
    got = quickstart.summary(port_run)
    assert len(got["front"]) == len(ref["front"])
    assert got["best_lightpe1"] == ref["best_lightpe1"]


def test_independent_fit_same_degrees_and_predictions(jax_fit, port_run):
    """An independent fit on the same sample picks the same degree for
    every (PE type, target) and predicts within FIT_RTOL (float32 ridge
    normal equations, solved by LAPACK here and by XLA there)."""
    for pe, targets in jax_fit.models.items():
        for t, m in targets.items():
            assert port_run.models.models[pe][t].degree == m.degree, (pe, t)
    from repro.core import enumerate_space
    jspace = enumerate_space(max_points=2000, seed=0)
    want, got = jax_fit.predict(jspace), port_run.models.predict(
        port_config(jspace))
    for f in want._fields:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=quickstart.FIT_RTOL, err_msg=f)


def _assert_same_tree(got, want, path="ref"):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, float):
        # a rebuild on another CPU may round XLA's last bits differently
        assert np.isclose(got, want, rtol=1e-9, atol=0), (path, got, want)
    else:
        assert got == want, path


def test_reference_file_is_current(jax_fit):
    """tests/data/torch_quickstart_ref.json is what the JAX package gives
    for the full-size loop today (chip_smoke.py holds the card to it)."""
    want = json.loads(REF_PATH.read_text())
    got = json.loads(json.dumps(build_reference(models=jax_fit)))
    _assert_same_tree(got, want)


def test_full_size_port_matches_reference_file():
    """The full-size loop on the CPU, held to the file as chip_smoke.py
    holds the card."""
    res = quickstart.run(max_points=None, device="cpu")
    problems, _ = quickstart.compare(res, json.loads(REF_PATH.read_text()))
    assert not problems, problems
    assert res.best_index == res.report["lightpe1"]["index_best_ppa"]


def test_step6_numerics(port_run):
    """LightPE-1 weights are signed powers of two within an 8-level
    window per output channel; LightPE-2 weights are sums of two."""
    for w, q in zip(port_run.weights, port_run.quantized["lightpe1"]):
        q = q.numpy()
        e = np.log2(np.abs(q))
        np.testing.assert_array_equal(e, np.round(e))
        span = e.max(axis=0) - e.min(axis=0)
        assert span.max() <= 7
        assert np.array_equal(np.sign(q), np.sign(w.numpy()))
    for w, q1, q2 in zip(port_run.weights, port_run.quantized["lightpe1"],
                         port_run.quantized["lightpe2"]):
        w, q1, q2 = w.numpy(), q1.numpy(), q2.numpy()
        assert np.all(np.abs(q2 - w) <= np.abs(q1 - w))
