"""Runs the launch layer's multi-process tests: ``world`` ranks of
``tests/_torch_dist_worker.py``, each its own Python process, meeting in
a gloo process group through a ``FileStore`` under the test's temporary
directory (no TCP port, so parallel test workers cannot collide).

Each rank imports torch and the port only, never JAX.  The ranks run
their tasks in order and write each task's result; ``run_ranks`` waits
for all of them up to a deadline, kills every rank past it, and fails:
a rank that never reaches a collective fails the test, never hangs it.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

TESTS = Path(__file__).resolve().parent
WORKER = TESTS / "_torch_dist_worker.py"
DEADLINE_S = 240


def run_ranks(world: int, tasks: list, workdir, deadline_s=DEADLINE_S):
    """Run ``tasks`` (dicts with a ``name`` and the task's arguments) on
    ``world`` gloo ranks; returns {task name: [(meta, arrays) a rank]}."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    spec = workdir / "spec.json"
    spec.write_text(json.dumps({"world": world, "workdir": str(workdir),
                                "tasks": tasks}))
    src = str(TESTS.parent / "src")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [src, str(TESTS), os.environ.get("PYTHONPATH", "")]))
    logs = [open(workdir / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(spec), str(r)],
                              stdout=logs[r], stderr=subprocess.STDOUT,
                              env=env) for r in range(world)]
    end = time.monotonic() + deadline_s
    try:
        for p in procs:
            p.wait(timeout=max(0.1, end - time.monotonic()))
    except subprocess.TimeoutExpired:
        raise AssertionError(
            f"{world} ranks did not finish within {deadline_s} s:\n"
            + _tails(workdir, world)) from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise AssertionError(f"ranks {bad} failed:\n" + _tails(workdir, world))
    out = {}
    for task in tasks:
        name = task["name"]
        out[name] = []
        for r in range(world):
            meta = json.loads((workdir / f"{name}.{r}.json").read_text())
            with np.load(workdir / f"{name}.{r}.npz") as z:
                arrays = {k: z[k] for k in z.files}
            out[name].append((meta, arrays))
    return out


def _tails(workdir: Path, world: int) -> str:
    return "\n".join(f"--- rank {r}:\n"
                     + (workdir / f"rank{r}.log").read_text()[-3000:]
                     for r in range(world))
