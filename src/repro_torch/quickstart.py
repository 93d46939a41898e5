"""The QADAM quickstart loop on the port, steps 1-6.

1. enumerate the accelerator design space,
2. synthesize it with the oracle and fit the polynomial PPA surrogates,
3. run the DSE on a paper workload (VGG-16/CIFAR-10) under the oracle
   and under the surrogate,
4. take the Pareto front and the paper's INT16-normalized report,
5. pick the best LightPE-1 design,
6. apply the numerics that design implies: ``fake_quant_weights`` on the
   workload's real weight shapes, drawn from a seed.

``run`` drives the loop on one device; ``summary`` reduces a run to the
JSON-able numbers that ``compare`` holds against the JAX package's
results for the same loop.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import arch, dse, ppa, workloads
from repro_torch.core.synth import synthesize
from repro_torch.device import resolve_device
from repro_torch.quant import fake_quant_weights, preset

# examples/quickstart.py's settings: seed 0, surrogates fit on a
# 2000-point sample with degrees (1, 2) chosen by 4-fold CV.
SEED = 0
FIT_POINTS = 2000
DEGREES = (1, 2)
FOLDS = 4

# Relative tolerance between the two packages on the same inputs: the
# synthesis noise takes sin/cos of arguments in the thousands, whose
# float32 rounding (XLA fuses the argument's products into FMAs) moves
# area and clock by up to ~8e-6.
RTOL = 1e-5
# Between two independent surrogate fits: the float32 ridge normal
# equations are poorly conditioned, so LAPACK (or cuSOLVER) and XLA's
# solve give coefficients that predict up to ~1e-3 apart.
FIT_RTOL = 5e-3
# R^2 of the two fits against the oracle agree to ~2e-6 on the paper grid.
R2_ATOL = 1e-4


def draw_weights(shapes, seed: int = 0, device=None) -> list[torch.Tensor]:
    """One float32 weight matrix per shape, N(0, 0.1^2), from numpy's
    ``default_rng(seed)``."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    return [torch.as_tensor((rng.standard_normal(s) * 0.1).astype(np.float32),
                            device=device) for s in shapes]


@dataclass
class QuickstartResult:
    space: arch.AcceleratorConfig
    models: ppa.PPAModels
    r2: dict
    oracle: dse.DseResult
    surrogate: dse.DseResult
    front: np.ndarray
    front_surrogate: np.ndarray
    report: dict
    report_surrogate: dict
    best_index: int
    best_config: dict
    weights: list
    quantized: dict
    timings: dict = field(default_factory=dict)


def run(max_points: int | None = 2000, presets=("lightpe1",),
        device=None) -> QuickstartResult:
    """Steps 1-6 on ``device`` (CUDA unless told otherwise).

    The DSE walks ``max_points`` points of the paper grid (None = all
    27,000); the surrogates are fit on the FIT_POINTS subsample of the
    same seed, which is the DSE's own space at the default size (the JAX
    quickstart's setting).  Step 6 quantizes under each preset named.
    """
    device = resolve_device(device)
    timings = {}

    def step(name, fn):
        t0 = time.perf_counter()
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        timings[name] = time.perf_counter() - t0
        return out

    # 1-2. space + oracle + surrogate fit
    space = step("enumerate", lambda: arch.enumerate_space(
        max_points=max_points, seed=SEED, device=device))
    sample = arch.enumerate_space(max_points=FIT_POINTS, seed=SEED,
                                  device=device)
    models = step("fit", lambda: ppa.fit_ppa_models(
        sample, degrees=DEGREES, k=FOLDS, device=device))
    truth, pred = synthesize(space), models.predict(space)
    r2 = {t: ppa.r2(getattr(truth, t), getattr(pred, t))
          for t in ("area_mm2", "power_mw", "clock_ghz")}

    # 3. DSE under both backends
    wl = workloads.vgg16("cifar10", device=device)
    oracle = step("dse_oracle", lambda: dse.evaluate_space(space, wl))
    surrogate = step("dse_surrogate", lambda: dse.evaluate_space(
        space, wl, surrogate=models))

    # 4. Pareto + normalized report
    front = step("pareto", lambda: np.asarray(dse.pareto_front(oracle)))
    front_s = np.asarray(dse.pareto_front(surrogate))
    report = dse.normalized_report(oracle, space)
    report_s = dse.normalized_report(surrogate, space)

    # 5. the best LightPE-1 design point
    best = report["lightpe1"]["index_best_ppa"]
    best_config = next(arch.config_rows(arch.AcceleratorConfig(
        *[f[best:best + 1] for f in space])))

    # 6. the numerics that hardware implies, on the real weight shapes
    weights = draw_weights(workloads.weight_shapes(wl), SEED, device)
    quantized = step("fake_quant", lambda: {
        p: fake_quant_weights(weights, preset(p)) for p in presets})
    return QuickstartResult(
        space=space, models=models, r2=r2, oracle=oracle, surrogate=surrogate,
        front=front, front_surrogate=front_s, report=report,
        report_surrogate=report_s, best_index=best, best_config=best_config,
        weights=weights, quantized=quantized, timings=timings)


def summary(res: QuickstartResult) -> dict:
    """The JSON-able numbers of a run, in the layout of the JAX
    package's reference file."""
    return dict(
        n_points=int(len(res.oracle.energy_j)),
        spread=dse.spread(res.oracle),
        front=np.flatnonzero(res.front).tolist(),
        report=dse.report_pe_types(res.report),
        best_lightpe1=dict(index=res.best_index, config=res.best_config),
        degrees={pe: {t: m.degree for t, m in ts.items()}
                 for pe, ts in res.models.models.items()},
        r2=res.r2,
        surrogate=dict(front=np.flatnonzero(res.front_surrogate).tolist(),
                       report=dse.report_pe_types(res.report_surrogate)))


def _objectives(result: dse.DseResult) -> np.ndarray:
    return dse._objective_columns(result, ("perf_per_area", "neg_energy_j"))


def front_flips(obj: np.ndarray, mine, ref, rtol: float):
    """Front indices in one set and not the other, split into near-ties
    (allowed) and real disagreements.

    A point is a near-tie when perturbing the objectives by ``rtol`` can
    change its status: no other point dominates it by more than ``rtol``
    in every objective, and some point comes within ``rtol`` of
    dominating it.
    """
    tol = rtol * np.abs(obj)
    ties, bad = [], []
    for i in sorted(set(mine) ^ set(ref)):
        others = np.delete(np.arange(len(obj)), i)
        robustly_dominated = np.any(
            np.all(obj[others] >= obj[i] + tol[i], axis=1))
        nearly_dominated = np.any(
            np.all(obj[others] >= obj[i] - tol[i], axis=1))
        (ties if nearly_dominated and not robustly_dominated
         else bad).append(int(i))
    return ties, bad


def _report_problems(result, report, ref_report, rtol, tag):
    problems, notes = [], []
    for pe, want in ref_report.items():
        got = report.get(pe)
        if got is None:
            problems.append(f"{tag}: PE type {pe} missing")
            continue
        for key, val in want.items():
            if key.startswith("index_"):
                metric = ("perf_per_area" if key == "index_best_ppa"
                          else "energy_j")
                col = getattr(result, metric)
                if got[key] == val:
                    continue
                if np.isclose(col[got[key]], col[val], rtol=rtol, atol=0):
                    notes.append(f"{tag}: {pe}.{key} {got[key]} vs {val} "
                                 f"(near-tie in {metric})")
                else:
                    problems.append(f"{tag}: {pe}.{key} {got[key]} != {val}")
            elif not np.isclose(got[key], val, rtol=rtol, atol=0):
                problems.append(f"{tag}: {pe}.{key} {got[key]!r} vs {val!r}")
    return problems, notes


def compare(res: QuickstartResult, ref: dict) -> tuple[list, list]:
    """Hold a run to the reference summary at RTOL (oracle), FIT_RTOL
    (surrogate) and R2_ATOL.  Returns ``(problems, notes)``: problems are
    disagreements beyond the tolerances; notes record what was tolerated
    (front flips and best-index changes at near-ties)."""
    rtol, fit_rtol = RTOL, FIT_RTOL
    got = summary(res)
    problems, notes = [], []
    if got["n_points"] != ref["n_points"]:
        problems.append(f"n_points {got['n_points']} != {ref['n_points']}")
        return problems, notes
    for key, val in ref["spread"].items():
        if not np.isclose(got["spread"][key], val, rtol=rtol, atol=0):
            problems.append(f"spread.{key} {got['spread'][key]!r} vs {val!r}")
    for tag, result, front, want, tol in (
            ("oracle", res.oracle, got["front"], ref["front"], rtol),
            ("surrogate", res.surrogate, got["surrogate"]["front"],
             ref["surrogate"]["front"], fit_rtol)):
        ties, bad = front_flips(_objectives(result), front, want, tol)
        notes += [f"{tag} front: index {i} flips at a near-tie" for i in ties]
        problems += [f"{tag} front: index {i} differs" for i in bad]
    p, n = _report_problems(res.oracle, res.report, ref["report"], rtol,
                            "oracle report")
    problems, notes = problems + p, notes + n
    p, n = _report_problems(res.surrogate, res.report_surrogate,
                            ref["surrogate"]["report"], fit_rtol,
                            "surrogate report")
    problems, notes = problems + p, notes + n
    if got["degrees"] != ref["degrees"]:
        problems.append(f"surrogate degrees {got['degrees']} != "
                        f"{ref['degrees']}")
    for t, val in ref["r2"].items():
        if not np.isclose(got["r2"][t], val, rtol=0, atol=R2_ATOL):
            problems.append(f"r2.{t} {got['r2'][t]!r} vs {val!r}")
    return problems, notes
