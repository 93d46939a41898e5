"""The JAX package's results for the port's quickstart loop.

``build_reference`` runs steps 1-5 of ``repro_torch.quickstart.run`` with
the JAX package and returns them in the layout of
``repro_torch.quickstart.summary``.  ``tests/data/torch_quickstart_ref.json``
holds its full-size result (the 27,000-point paper grid, VGG-16/CIFAR-10),
which ``chip_smoke.py`` holds the port to on a machine without JAX;
``tests/test_torch_quickstart.py`` rebuilds it to keep the file honest.

  PYTHONPATH=src python tests/_torch_quickstart_ref.py   # rewrite the file
"""

import json
from pathlib import Path

import numpy as np

REF_PATH = Path(__file__).resolve().parent / "data" / "torch_quickstart_ref.json"


def jax_models():
    """The JAX fit of the port quickstart's sample and settings."""
    from repro.core import enumerate_space, fit_ppa_models
    from repro_torch.quickstart import DEGREES, FIT_POINTS, FOLDS, SEED
    sample = enumerate_space(max_points=FIT_POINTS, seed=SEED)
    return fit_ppa_models(sample, degrees=DEGREES, k=FOLDS)


def build_reference(max_points=None, models=None):
    """Steps 1-5 with the JAX package; ``models`` reuses ``jax_models()``."""
    from repro.core import (enumerate_space, evaluate_space, normalized_report,
                            pareto_front, r2, report_pe_types, spread,
                            synthesize, vgg16)
    from repro.core.arch import config_rows
    from repro_torch.quickstart import SEED
    models = jax_models() if models is None else models
    space = enumerate_space(max_points=max_points, seed=SEED)
    truth, pred = synthesize(space), models.predict(space)
    wl = vgg16("cifar10")
    res = evaluate_space(space, wl)
    res_s = evaluate_space(space, wl, surrogate=models)
    report = normalized_report(res, space)
    best = report["lightpe1"]["index_best_ppa"]
    rows = config_rows(space)
    for _ in range(best):
        next(rows)
    return dict(
        n_points=int(len(res.energy_j)),
        spread=spread(res),
        front=np.flatnonzero(np.asarray(pareto_front(res))).tolist(),
        report=report_pe_types(report),
        best_lightpe1=dict(index=best, config=next(rows)),
        degrees={pe: {t: m.degree for t, m in ts.items()}
                 for pe, ts in models.models.items()},
        r2={t: r2(getattr(truth, t), getattr(pred, t))
            for t in ("area_mm2", "power_mw", "clock_ghz")},
        surrogate=dict(
            front=np.flatnonzero(np.asarray(pareto_front(res_s))).tolist(),
            report=report_pe_types(normalized_report(res_s, space))))


if __name__ == "__main__":
    REF_PATH.parent.mkdir(parents=True, exist_ok=True)
    REF_PATH.write_text(json.dumps(build_reference(), indent=1) + "\n")
    print(f"wrote {REF_PATH}")
