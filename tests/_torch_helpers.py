"""Shared helpers of the tests that hold ``repro_torch`` to ``repro``.

Inputs cross between the packages as numpy arrays only.
"""

import numpy as np

from repro_torch import convert


def jax_config_arrays(cfg) -> dict:
    return {f: np.asarray(getattr(cfg, f)) for f in cfg._fields}


def port_config(jax_cfg, device="cpu"):
    """The port's copy of a JAX AcceleratorConfig."""
    return convert.config_from_numpy(jax_config_arrays(jax_cfg), device)


def port_workload(jax_wl, device="cpu"):
    arrays = {f: np.asarray(getattr(jax_wl.layers, f))
              for f in jax_wl.layers._fields}
    return convert.workload_from_numpy(jax_wl.name, arrays, jax_wl.layer_names,
                                       device)


def port_models(jax_models, device="cpu"):
    """The port's PPAModels holding the JAX fit's own coefficients."""
    return convert.ppa_models_from_numpy(
        {pe: {t: dict(degree=m.degree, exps=np.asarray(m.exps),
                      mu=np.asarray(m.mu), sigma=np.asarray(m.sigma),
                      coef=np.asarray(m.coef), log_target=m.log_target)
              for t, m in targets.items()}
         for pe, targets in jax_models.models.items()}, device)


def jax_models_equal_per_type(n_per_type=240, degree=2, seed=0):
    """A JAX PPAModels fit with ``fit_poly`` on ``n_per_type`` paper-grid
    points of every PE type.  Equal per-type sample sizes give equal array
    shapes, so JAX compiles each operation once for all 15 fits."""
    from repro.core import enumerate_space, synthesize
    from repro.core.arch import PE_TYPE_NAMES
    from repro.core.ppa import PPAModels, TARGETS, config_features, fit_poly
    space = enumerate_space()
    pt = np.asarray(space.pe_type)
    rng = np.random.default_rng(seed)
    idx = np.sort(np.concatenate([
        rng.choice(np.flatnonzero(pt == c), n_per_type, replace=False)
        for c in range(len(PE_TYPE_NAMES))]))
    sample = type(space)(*[np.asarray(f)[idx] for f in space])
    x, truth, spt = config_features(sample), synthesize(sample), pt[idx]
    return PPAModels(models={
        name: {t: fit_poly(x[spt == c], getattr(truth, t)[spt == c], degree)
               for t in TARGETS}
        for c, name in enumerate(PE_TYPE_NAMES)})


def assert_columns_close(jax_result, port_result, rtol):
    for f in jax_result._fields:
        np.testing.assert_allclose(
            getattr(port_result, f), np.asarray(getattr(jax_result, f)),
            rtol=rtol, atol=0, err_msg=f)


def log2_ties(v: np.ndarray, ulps: float = 2.0) -> np.ndarray:
    """Where log2|v| lies within ``ulps`` float32 ulps of a half-integer.

    There ``round(log2|v|)`` depends on the last bit of log2, and XLA's
    CPU log2 is not correctly rounded (it differs from torch's in about a
    third of float32 inputs), so the pow2 code may differ by one between
    the packages.  Computed in float64.
    """
    lg = np.log2(np.maximum(np.abs(np.asarray(v, np.float64)), 1e-12))
    frac = np.abs(lg - np.floor(lg) - 0.5)
    return frac <= ulps * np.spacing(np.abs(lg).astype(np.float32))


def assert_pow2_close(port, ref, x, atol=1e-6, residual=None):
    """``port`` equals ``ref`` within ``atol`` except at log2 ties of the
    input ``x`` (or of the pow2x2 ``residual``), where the two results may
    be the two neighbouring codes; returns how many ties were tolerated."""
    port, ref = np.asarray(port), np.asarray(ref)
    off = np.abs(port - ref) > atol
    tie = log2_ties(x)
    if residual is not None:
        tie |= log2_ties(residual)
    assert not np.any(off & ~tie), (
        f"{int(np.sum(off & ~tie))} elements differ away from a log2 tie")
    ratio = np.abs(port[off]) / np.maximum(np.abs(ref[off]), 1e-30)
    # one code step: a factor 2 (or 1/2); pow2x2 also sums two such terms
    assert np.all((ratio > 0.2) & (ratio < 5.0)), ratio
    return int(np.sum(off))
