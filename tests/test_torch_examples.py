"""The port's two examples that mirror ``examples/dse_pareto.py`` and
``examples/llm_serving_front.py``, run on the CPU at a subsample beside
the reference's (each in its own working directory): the same Pareto
points and columns (rtol 1e-5, the port's DSE tolerance against the
reference), the same front size and claim."""

import csv
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def _run(script, cwd, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, str(ROOT / "examples" / script),
                          *args], cwd=cwd, env=env, check=True, timeout=300,
                         capture_output=True, text=True)
    return out.stdout


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def test_torch_dse_pareto_matches_the_reference_example(tmp_path):
    (tmp_path / "jax").mkdir()
    _run("dse_pareto.py", tmp_path / "jax", "--max-points", "1500")
    out = _run("torch_dse_pareto.py", tmp_path, "--device", "cpu",
               "--max-points", "1500", "--out", str(tmp_path / "port.csv"))
    assert "Pareto points of 1500" in out
    want = _rows(tmp_path / "jax" / "results" / "dse" /
                 "resnet20-cifar10.csv")
    got = _rows(tmp_path / "port.csv")
    assert len(got) == len(want) == 1500
    assert [r["pareto"] for r in got] == [r["pareto"] for r in want]
    for col in ("pe_type", "pe_rows", "pe_cols", "gbuf_kb", "bandwidth_gbps"):
        assert [r[col] for r in got] == [r[col] for r in want], col
    for col in ("perf_per_area", "energy_j", "latency_s", "area_mm2"):
        np.testing.assert_allclose([float(r[col]) for r in got],
                                   [float(r[col]) for r in want], rtol=1e-5,
                                   err_msg=col)


def test_torch_llm_serving_front_matches_the_reference_example(tmp_path):
    (tmp_path / "jax").mkdir()
    ref = _run("llm_serving_front.py", tmp_path / "jax", "--max-points",
               "3000")
    out = _run("torch_llm_serving_front.py", tmp_path, "--device", "cpu",
               "--max-points", "3000", "--out", str(tmp_path / "front.csv"))

    def line(text, start):
        return next(x for x in text.splitlines() if x.startswith(start))

    for start in ("evaluated ", "front mix by PE type:"):
        assert line(out, start) == line(ref, start)
    feasible = line(ref, "SLO-feasible: ").split(")")[0]
    assert line(out, "SLO-feasible: ").startswith(feasible)
    assert ("HOLDS" in line(out, "paper claim")) == \
        ("HOLDS" in line(ref, "paper claim"))
    got = _rows(tmp_path / "front.csv")
    want = _rows(tmp_path / "jax" / "results" / "serving" / "front.csv")
    key = lambda r: (r["model"], r["pe_type"], r["accuracy"])  # noqa: E731
    assert sorted(map(key, got)) == sorted(map(key, want))
