"""Ranks of one process group, each its own Python process, on one host.

``run_ranks(world, tasks, workdir, device=..., backend=..., modules=...)``
writes a spec to ``workdir``, starts ``world`` processes of

  python -m repro_torch.launch.ranks <spec.json> <rank>

waits for all of them up to a deadline, stops every rank past it, and
returns each task's result a rank.  Each rank joins the process group
through a ``FileStore`` in ``workdir`` (no TCP port, so runs side by side
cannot collide), with a timeout: a rank that never reaches a collective
fails the others instead of hanging them.  It runs the tasks in order:
a task ``{"name": ..., "kind": ...}`` (``kind`` defaults to the name) is
``TASKS[kind](task, at)`` of the first of ``modules`` whose ``TASKS``
has it, ``at`` the rank's ``Rank``, and gives (numbers, arrays), written
as ``<name>.<rank>.json`` and ``<name>.<rank>.npz``.

The device defaults to the card, as every entry point of the port does
(``device.resolve_device``); the CPU tests name ``"cpu"``.  The backend
follows the device (``mesh.init_process_group``) unless the caller names
another: ranks that share one card name gloo, since NCCL refuses two
ranks on one GPU.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

DEADLINE_S = 240
TIMEOUT_S = 120


@dataclasses.dataclass(frozen=True)
class Rank:
    """Where a task runs: its rank, the group's size, the device and the
    backend the group was made with."""
    rank: int
    world: int
    device: torch.device
    backend: str | None = None

    def mesh(self, shape, axes=("data", "model")):
        """A mesh of ``shape`` over the group, on the rank's device."""
        from repro_torch.launch import mesh as M
        return M.make_mesh(shape, axes, self.device, backend=self.backend)


def run_ranks(world: int, tasks: list, workdir, *, device=None,
              backend: str | None = None, modules=("repro_torch.tp_check",),
              path=(), deadline_s: float = DEADLINE_S,
              timeout_s: float = TIMEOUT_S) -> dict:
    """Run ``tasks`` on ``world`` ranks; {task name: [(numbers, arrays) a
    rank]}.  ``modules`` are imported by each rank for their ``TASKS``,
    ``path`` is put on its ``PYTHONPATH`` (beside the port's own
    directory); CPU ranks take one thread each.  A rank that fails, or
    outlives ``deadline_s``, raises ``RuntimeError`` with the ranks' last
    output (every rank stopped first)."""
    from repro_torch.device import resolve_device
    device = resolve_device(device)
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    spec = workdir / "spec.json"
    spec.write_text(json.dumps({
        "world": world, "workdir": str(workdir), "device": str(device),
        "backend": backend, "modules": list(modules), "timeout_s": timeout_s,
        "tasks": tasks}))
    src = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src, *map(str, path), os.environ.get("PYTHONPATH", "")]))
    if device.type == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    logs = [open(workdir / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.ranks", str(spec), str(r)],
        stdout=logs[r], stderr=subprocess.STDOUT, env=env)
        for r in range(world)]
    end = time.monotonic() + deadline_s
    late = False
    try:
        for p in procs:
            p.wait(timeout=max(0.1, end - time.monotonic()))
    except subprocess.TimeoutExpired:
        late = True
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if late or bad:
        tails = "\n".join(f"--- rank {r}:\n"
                          + (workdir / f"rank{r}.log").read_text()[-3000:]
                          for r in range(world))
        raise RuntimeError(
            f"{world} ranks did not finish within {deadline_s} s:\n{tails}"
            if late else f"ranks {bad} failed:\n{tails}")
    out = {}
    for task in tasks:
        name = task["name"]
        out[name] = []
        for r in range(world):
            meta = json.loads((workdir / f"{name}.{r}.json").read_text())
            with np.load(workdir / f"{name}.{r}.npz") as z:
                out[name].append((meta, {k: z[k] for k in z.files}))
    return out


def main(argv=None) -> int:
    """One rank of a ``run_ranks`` spec: ``<spec.json> <rank>``."""
    import torch.distributed as dist

    from repro_torch.device import resolve_device
    from repro_torch.launch import mesh as M
    spec_path, rank = (argv if argv is not None else sys.argv[1:])[:2]
    rank = int(rank)
    with open(spec_path) as f:
        spec = json.load(f)
    device = resolve_device(spec.get("device"))
    workdir, world = spec["workdir"], spec["world"]
    tables = [importlib.import_module(m).TASKS
              for m in spec.get("modules", ())]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(1)
    at = Rank(rank, world, device, spec.get("backend"))
    store = dist.FileStore(os.path.join(workdir, "store"), world)
    M.init_process_group(device, rank, world, store=store,
                         timeout_s=spec.get("timeout_s", TIMEOUT_S),
                         backend=at.backend)
    try:
        for task in spec["tasks"]:
            kind = task.get("kind", task["name"])
            fn = next((t[kind] for t in tables if kind in t), None)
            if fn is None:
                raise KeyError(f"no task {kind!r} in {spec.get('modules')}")
            meta, arrays = fn(task, at)
            with open(os.path.join(workdir, f"{task['name']}.{rank}.json"),
                      "w") as f:
                json.dump(meta, f)
            np.savez(os.path.join(workdir, f"{task['name']}.{rank}.npz"),
                     **arrays)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
