"""repro_torch's PE/energy tables, synthesis oracle and PPA surrogate
against repro's, on the CPU."""

import numpy as np
import pytest
import torch

from repro.core import arch as ja, energy as je, pe as jpe, ppa as jp, \
    synth as js
from repro_torch.core import arch as ta, costmodel as tcm, energy as te, \
    pe as tpe, ppa as tp, synth as ts

from _torch_helpers import jax_models_equal_per_type, port_config, port_models

# Eager XLA and torch's CPU kernels round log2/sin/cos differently in the
# last ulp; the oracle's outputs agree to ~4e-7 relative.
ORACLE_RTOL = 1e-6
# The same fitted coefficients predict to ~6e-6 apart: the basis powers
# and exp differ by an ulp and the fitted polynomials cancel a little.
CARRIED_RTOL = 1e-5


@pytest.fixture(scope="module")
def grid():
    jcfg = ja.enumerate_space()
    return jcfg, port_config(jcfg)


@pytest.fixture(scope="module")
def carried():
    jm = jax_models_equal_per_type()
    return jm, port_models(jm)


@pytest.mark.parametrize("name", ["ACT_BITS", "WEIGHT_BITS", "PSUM_BITS",
                                  "MAC_ENERGY_PJ", "MAC_AREA_UM2",
                                  "MAC_DELAY_NS"])
def test_pe_tables_equal(name):
    got, want = getattr(tpe, name), np.asarray(getattr(jpe, name))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_pe_accessors_and_energy_functions():
    codes = np.array([0, 1, 2, 3, 4, 2, 0], np.int32)
    tcodes = torch.as_tensor(codes)
    for fn in ("act_bits", "weight_bits", "psum_bits", "mac_energy_pj",
               "mac_area_um2", "mac_delay_ns"):
        np.testing.assert_array_equal(getattr(tpe, fn)(tcodes).numpy(),
                                      np.asarray(getattr(jpe, fn)(codes)))
    rng = np.random.default_rng(0)
    spads = [rng.integers(6, 449, 7).astype(np.float32) for _ in range(3)]
    np.testing.assert_allclose(
        tpe.pe_area_um2(tcodes, *map(torch.as_tensor, spads)).numpy(),
        np.asarray(jpe.pe_area_um2(codes, *spads)), rtol=ORACLE_RTOL)
    kb = rng.uniform(27, 1728, 50).astype(np.float32)
    bits = rng.uniform(4, 32, 50).astype(np.float32)
    for fn, args in (("gbuf_energy_per_bit", (kb,)), ("gbuf_area_um2", (kb,)),
                     ("rf_access_energy", (bits, bits * kb)),
                     ("dram_energy_pj", (bits,)), ("noc_energy_pj", (bits,))):
        np.testing.assert_allclose(
            getattr(te, fn)(*map(torch.as_tensor, args)).numpy(),
            np.asarray(getattr(je, fn)(*args)), rtol=ORACLE_RTOL, err_msg=fn)


def test_oracle_over_full_paper_grid(grid):
    jcfg, tcfg = grid
    jres, tres = js.synthesize(jcfg), ts.synthesize(tcfg)
    for f in js.SynthResult._fields:
        np.testing.assert_allclose(getattr(tres, f).numpy(),
                                   np.asarray(getattr(jres, f)),
                                   rtol=ORACLE_RTOL, err_msg=f)
    power, clock, area = ts.oracle_ppa((), tcfg)
    assert torch.equal(power, tres.power_mw) and torch.equal(area, tres.area_mm2)
    assert ts.LEAKAGE_MW_PER_MM2 == js.LEAKAGE_MW_PER_MM2


def test_surrogate_from_carried_coefficients(grid, carried):
    jcfg, tcfg = grid
    jm, tm = carried
    jpred, tpred = jm.predict(jcfg), tm.predict(tcfg)
    for f in js.SynthResult._fields:
        np.testing.assert_allclose(getattr(tpred, f).numpy(),
                                   np.asarray(getattr(jpred, f)),
                                   rtol=CARRIED_RTOL, err_msg=f)


def test_design_matrix_and_poly_predict(carried):
    jm, tm = carried
    jmodel, tmodel = jm.models["int8"]["power_mw"], tm.models["int8"]["power_mw"]
    x = np.random.default_rng(1).uniform(4, 400, (64, 7)).astype(np.float32)
    np.testing.assert_allclose(
        tp.design_matrix(torch.as_tensor(x), tmodel.exps, tmodel.mu,
                         tmodel.sigma).numpy(),
        np.asarray(jp.design_matrix(x, jmodel.exps, jmodel.mu, jmodel.sigma)),
        rtol=CARRIED_RTOL, atol=1e-6)
    np.testing.assert_array_equal(tp.monomial_exponents(7, 3),
                                  jp.monomial_exponents(7, 3))


def test_fit_and_kfold_on_one_type(grid):
    """fit_poly and kfold_mse on the same sample: same coefficients to
    float32 solve accuracy, same cross-validated degree."""
    jcfg, tcfg = grid
    rows = np.flatnonzero(np.asarray(jcfg.pe_type) == 2)[::20]
    jx = jp.config_features(jcfg)[rows]
    jy = js.synthesize(jcfg).area_mm2[rows]
    tx = tp.config_features(tcfg)[torch.as_tensor(rows)]
    ty = ts.synthesize(tcfg).area_mm2[torch.as_tensor(rows)]
    jmse = [jp.kfold_mse(jx, jy, d, k=4) for d in (1, 2)]
    tmse = [tp.kfold_mse(tx, ty, d, k=4) for d in (1, 2)]
    np.testing.assert_allclose(tmse, jmse, rtol=1e-2)
    degree = 1 + int(np.argmin(jmse))
    tfit = tp.select_and_fit(tx, ty, (1, 2), k=4)
    assert tfit.degree == degree
    jfit = jp.fit_poly(jx, jy, degree)
    np.testing.assert_allclose(tfit.predict(tx).numpy(),
                               np.asarray(jfit.predict(jx)), rtol=1e-4)


def test_validate_refuses_unfitted_types(grid, carried):
    _, tm = carried
    partial = tp.PPAModels(models={k: v for k, v in tm.models.items()
                                   if k != "lightpe2"})
    with pytest.raises(ValueError, match="lightpe2"):
        partial.predict(grid[1])
    bad = ta.make_config(pe_type=7, device="cpu")
    with pytest.raises(ValueError, match="outside"):
        tm.validate(bad)
    with pytest.raises(ValueError, match="no fitted"):
        tp.PPAModels().ppa_params()


def test_fit_quality_metrics_match():
    rng = np.random.default_rng(2)
    y = rng.uniform(1, 10, 100)
    p = y * rng.uniform(0.95, 1.05, 100)
    assert tp.r2(torch.as_tensor(y), torch.as_tensor(p)) == jp.r2(y, p)
    assert tp.mape(torch.as_tensor(y), torch.as_tensor(p)) == jp.mape(y, p)


def test_cost_model_registry(carried):
    _, tm = carried
    assert tcm.as_cost_model(None).name == "oracle"
    sur = tcm.as_cost_model(tm)
    assert sur.name == "surrogate" and tcm.as_cost_model(tm) is sur
    assert tcm.cost_model("surrogate", models=tm).ppa_params is not None
    with pytest.raises(ValueError, match="needs the fitted"):
        tcm.cost_model("surrogate")
    with pytest.raises(ValueError, match="already registered"):
        tcm.register_cost_model("oracle", tcm.OracleCostModel)
    with pytest.raises(TypeError):
        tcm.as_cost_model(3.0)
