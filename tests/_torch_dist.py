"""Runs the launch layer's multi-process tests: ``world`` CPU ranks of
``repro_torch.launch.ranks`` over gloo, each its own Python process,
running the tasks of ``tests/_torch_dist_worker.py`` (and of
``repro_torch.tp_check``).

Each rank imports torch and the port only, never JAX.  ``run_ranks``
waits for all of them up to a deadline, stops every rank past it, and
fails: a rank that never reaches a collective fails the test, never
hangs it.
"""

from pathlib import Path

from repro_torch.launch import ranks

TESTS = Path(__file__).resolve().parent
DEADLINE_S = 240


def run_ranks(world: int, tasks: list, workdir, deadline_s=DEADLINE_S):
    """Run ``tasks`` (dicts with a ``name`` and the task's arguments) on
    ``world`` gloo ranks; returns {task name: [(meta, arrays) a rank]}."""
    return ranks.run_ranks(world, tasks, workdir, device="cpu",
                           modules=("_torch_dist_worker",
                                    "repro_torch.tp_check"),
                           path=(TESTS,), deadline_s=deadline_s)
