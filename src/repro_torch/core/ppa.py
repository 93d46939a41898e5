"""Polynomial-regression PPA surrogate models (port of ``repro.core.ppa``,
the paper's Sec. III-C).

Per-PE-type polynomials of power, clock and area over the standardized
config knobs, ridge-regularized least squares, degree chosen per target
by k-fold cross-validation.  The folds come from numpy's
``default_rng(0)`` as in the reference, so both packages fit on the same
splits.  ``surrogate_ppa`` is the batched ``(params, cfg) -> (power,
clock, area)`` stage of the surrogate backend.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, Sequence

import numpy as np
import torch

from repro_torch.core.arch import AcceleratorConfig, PE_TYPE_NAMES
from repro_torch.core.synth import LEAKAGE_MW_PER_MM2, SynthResult, synthesize
from repro_torch.device import host, resolve_device

# Regression features: every knob except pe_type (models are per PE type).
FEATURE_FIELDS = ("pe_rows", "pe_cols", "gbuf_kb", "spad_ifmap",
                  "spad_filter", "spad_psum", "bandwidth_gbps")
TARGETS = ("power_mw", "clock_ghz", "area_mm2")


def config_features(cfg: AcceleratorConfig) -> torch.Tensor:
    """(N, F) raw feature matrix from a batched config."""
    return torch.stack([torch.atleast_1d(getattr(cfg, f)).to(torch.float32)
                        for f in FEATURE_FIELDS], dim=-1)


def monomial_exponents(n_features: int, degree: int) -> np.ndarray:
    """All exponent tuples with total degree in [0, degree], ordered by
    (total degree, lex): a lower-degree basis is a prefix of a higher one."""
    exps = [e for e in itertools.product(range(degree + 1), repeat=n_features)
            if sum(e) <= degree]
    exps.sort(key=lambda e: (sum(e), e))
    return np.array(exps, dtype=np.int32)


def design_matrix(x: torch.Tensor, exps, mu: torch.Tensor,
                  sigma: torch.Tensor) -> torch.Tensor:
    """Monomial basis on standardized features. x: (N, F) -> (N, M)."""
    z = (x - mu) / sigma
    e = torch.as_tensor(exps, dtype=x.dtype, device=x.device)
    return torch.prod(z[:, None, :] ** e[None, :, :], dim=-1)


@dataclass
class PolyModel:
    """One fitted polynomial y ~ poly(x) for one (pe_type, target)."""
    degree: int
    exps: np.ndarray
    mu: torch.Tensor
    sigma: torch.Tensor
    coef: torch.Tensor
    log_target: bool = True   # fit log(y): PPA spans decades

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        y = design_matrix(x, self.exps, self.mu, self.sigma) @ self.coef
        return torch.exp(y) if self.log_target else y


def _fit_coef(a: torch.Tensor, y: torch.Tensor, ridge: float = 1e-6):
    m = a.shape[1]
    ata = a.T @ a + ridge * torch.eye(m, dtype=a.dtype, device=a.device)
    # solve_ex: a singular fold gives non-finite coefficients (its CV
    # error then loses the degree selection), as XLA's solve does,
    # instead of raising
    return torch.linalg.solve_ex(ata, a.T @ y)[0]


def fit_poly(x: torch.Tensor, y: torch.Tensor, degree: int,
             log_target: bool = True, ridge: float = 1e-6) -> PolyModel:
    mu = torch.mean(x, dim=0)
    sigma = torch.clamp_min(torch.std(x, dim=0, correction=0), 1e-6)
    exps = monomial_exponents(x.shape[1], degree)
    a = design_matrix(x, exps, mu, sigma)
    t = torch.log(torch.clamp_min(y, 1e-12)) if log_target else y
    coef = _fit_coef(a, t, ridge)
    return PolyModel(degree=degree, exps=exps, mu=mu, sigma=sigma, coef=coef,
                     log_target=log_target)


def kfold_mse(x: torch.Tensor, y: torch.Tensor, degree: int, k: int = 5,
              log_target: bool = True) -> float:
    """k-fold CV mean squared error (in log space if log_target); the
    error itself is taken on the host, as in the reference."""
    n = int(x.shape[0])
    if n < 2:
        raise ValueError(f"kfold_mse needs >= 2 samples to hold one out, "
                         f"got {n}")
    k = min(k, n)
    idx = np.arange(n)
    rng = np.random.default_rng(0)
    rng.shuffle(idx)
    folds = np.array_split(idx, k)
    errs = []
    for f in folds:
        mask = np.ones(n, bool)
        mask[f] = False
        train = torch.as_tensor(mask, device=x.device)
        held = torch.as_tensor(f, device=x.device)
        model = fit_poly(x[train], y[train], degree, log_target)
        pred = host(model.predict(x[held]))
        yf = host(y[held])
        t, p = (np.log(np.maximum(yf, 1e-12)), np.log(np.maximum(pred, 1e-12))) \
            if log_target else (yf, pred)
        errs.append(float(np.mean((t - p) ** 2)))
    return float(np.mean(errs))


def select_and_fit(x: torch.Tensor, y: torch.Tensor,
                   degrees: Sequence[int] = (1, 2, 3), k: int = 5,
                   log_target: bool = True) -> PolyModel:
    """Model selection by k-fold CV (the paper's methodology), then refit."""
    best_d, best_mse = degrees[0], float("inf")
    for d in degrees:
        mse = kfold_mse(x, y, d, k, log_target)
        if mse < best_mse:
            best_d, best_mse = d, mse
    return fit_poly(x, y, best_d, log_target)


def surrogate_ppa(params, cfg: AcceleratorConfig):
    """PPA stage of the surrogate backend: ``(params, cfg) -> (power_mw,
    clock_ghz, area_mm2)``.

    ``params`` is ``PPAModels.ppa_params()``.  Each fitted PE type's
    max-degree design matrix is evaluated once over all lanes; each
    target contracts its leading ``len(coef)`` columns (a lower degree's
    basis is a prefix of the max-degree one), and each lane then takes
    its own type's prediction.  Every lane's value depends on its own
    config only, never on its position in the chunk.  Lanes of unfitted
    types must be refused beforehand by ``PPAModels.validate``.

    A type whose targets cannot share one basis (the per-target layout
    of ``_pack_type_entry``) evaluates each target's own design matrix.
    """
    x = config_features(cfg)
    pos = params["pos"][torch.atleast_1d(cfg.pe_type).long()]
    shared = [design_matrix(x, e["exps"], e["mu"], e["sigma"])
              if "targets" in e else None
              for e in params["types"]]
    out = []
    for t in TARGETS:
        preds = []
        for entry, a in zip(params["types"], shared):
            if a is not None:
                coef, log = entry["targets"][t]
                a = a[:, :coef.shape[0]]
            else:
                exps, mu, sigma, coef, log = entry[t]
                a = design_matrix(x, exps, mu, sigma)
            # a per-lane product and row sum, not a matrix-vector
            # product: a BLAS GEMV blocks rows by position (on the CPU a
            # lane's value changed with its place in a ragged chunk),
            # and the joint walks need a lane's result wherever it sits
            v = (a * coef).sum(-1)
            preds.append(torch.exp(v) if log else v)
        out.append(torch.gather(torch.stack(preds), 0, pos[None, :])[0])
    power, clock, area = out                        # TARGETS order
    return power, clock, area


def _pack_type_entry(ms: Dict[str, PolyModel]) -> dict:
    """One PE type's targets as a ``surrogate_ppa`` params entry.

    The shared layout (``exps``/``mu``/``sigma`` of one max-degree basis
    and each target's ``(coef, log_target)``) when every target is
    standardized identically and each exponent set is a prefix of the
    widest, which ``fit_ppa_models`` always gives (one fit sample per
    type).  Hand-assembled models that break either property get the
    per-target layout, ``{target: (exps, mu, sigma, coef, log_target)}``,
    each target with its own basis.
    """
    mx = max(ms.values(), key=lambda m: len(m.exps))
    shareable = all(
        torch.equal(m.mu, mx.mu)
        and torch.equal(m.sigma, mx.sigma)
        and np.array_equal(m.exps, mx.exps[:len(m.exps)])
        for m in ms.values())
    if not shareable:
        return {t: (torch.as_tensor(m.exps, dtype=torch.float32,
                                    device=m.mu.device),
                    m.mu, m.sigma, m.coef, bool(m.log_target))
                for t, m in ms.items()}
    return {"exps": torch.as_tensor(mx.exps, dtype=torch.float32,
                                    device=mx.mu.device),
            "mu": mx.mu, "sigma": mx.sigma,
            "targets": {t: (m.coef, bool(m.log_target))
                        for t, m in ms.items()}}


def _entry_device(entry: dict) -> torch.device:
    """The device of a packed type entry (either layout)."""
    return (entry["mu"] if "mu" in entry else next(iter(entry.values()))[1]).device


@dataclass
class PPAModels:
    """Per-PE-type surrogates for power / clock / area."""
    models: Dict[str, Dict[str, PolyModel]] = field(default_factory=dict)
    _params: dict | None = field(default=None, init=False, repr=False,
                                 compare=False)

    def validate(self, cfg: AcceleratorConfig) -> None:
        """Raise unless every PE type present in ``cfg`` has a fitted model
        (an unfitted type would silently price at zero power/clock/area)."""
        codes = np.unique(np.atleast_1d(host(cfg.pe_type)).astype(int))
        invalid = codes[(codes < 0) | (codes >= len(PE_TYPE_NAMES))]
        if invalid.size:
            raise ValueError(
                f"pe_type codes {invalid.tolist()} are outside "
                f"[0, {len(PE_TYPE_NAMES)}) — not a known PE type")
        missing = sorted({PE_TYPE_NAMES[c] for c in codes
                          if PE_TYPE_NAMES[c] not in self.models})
        if missing:
            raise ValueError(
                f"PPAModels has no fitted model for PE type(s) "
                f"{missing} present in the config batch (fitted: "
                f"{sorted(self.models)}); fit on a design sample covering "
                f"every PE type the DSE sweeps")

    def ppa_params(self) -> dict:
        """The fitted polynomials packed for ``surrogate_ppa`` (cached):
        ``pos`` maps a PE-type code to its row among the fitted types,
        ``types`` holds one ``_pack_type_entry`` per fitted type."""
        if self._params is None:
            fitted = [(code, name) for code, name in enumerate(PE_TYPE_NAMES)
                      if name in self.models]
            if not fitted:
                raise ValueError("PPAModels has no fitted models")
            pos = np.zeros(len(PE_TYPE_NAMES), np.int64)
            types = []
            for row, (code, name) in enumerate(fitted):
                pos[code] = row
                types.append(_pack_type_entry(self.models[name]))
            device = _entry_device(types[0])
            self._params = {"pos": torch.as_tensor(pos, device=device),
                            "types": tuple(types)}
        return self._params

    def predict(self, cfg: AcceleratorConfig) -> SynthResult:
        """Surrogate SynthResult for a batched config (mixed PE types OK)."""
        self.validate(cfg)
        power, clock, area = surrogate_ppa(self.ppa_params(), cfg)
        return SynthResult(area_mm2=area,
                           crit_path_ns=1.0 / torch.clamp_min(clock, 1e-6),
                           clock_ghz=clock, power_mw=power,
                           leakage_mw=LEAKAGE_MW_PER_MM2 * area)


def fit_ppa_models(cfg: AcceleratorConfig,
                   degrees: Sequence[int] = (1, 2, 3), k: int = 5,
                   device: str | torch.device | None = None) -> PPAModels:
    """Fit per-PE-type PPA surrogates against the synthesis oracle, on
    ``device`` (the config is moved there first)."""
    device = resolve_device(device)
    cfg = AcceleratorConfig(*[torch.as_tensor(f).to(device) for f in cfg])
    truth = synthesize(cfg)
    x = config_features(cfg)
    pt = np.atleast_1d(host(cfg.pe_type))
    ys = {"power_mw": truth.power_mw, "clock_ghz": truth.clock_ghz,
          "area_mm2": truth.area_mm2}
    models: Dict[str, Dict[str, PolyModel]] = {}
    for code, name in enumerate(PE_TYPE_NAMES):
        sel = pt == code
        if not sel.any():
            continue
        rows = torch.as_tensor(np.flatnonzero(sel), device=device)
        models[name] = {
            t: select_and_fit(x[rows], torch.atleast_1d(ys[t])[rows],
                              degrees, k)
            for t in TARGETS}
    return PPAModels(models=models)


# ---- fit-quality metrics ---------------------------------------------------

def r2(y_true, y_pred) -> float:
    y_true = host(y_true).astype(np.float64)
    y_pred = host(y_pred).astype(np.float64)
    ss_res = np.sum((y_true - y_pred) ** 2)
    ss_tot = np.sum((y_true - y_true.mean()) ** 2)
    return float(1.0 - ss_res / max(ss_tot, 1e-12))


def mape(y_true, y_pred) -> float:
    y_true = host(y_true).astype(np.float64)
    y_pred = host(y_pred).astype(np.float64)
    return float(np.mean(np.abs((y_pred - y_true) /
                                np.maximum(np.abs(y_true), 1e-12))))
