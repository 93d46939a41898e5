"""What the kernel wrappers and the models report to a dry run.

``launch.op_analysis.Analyzer`` installs itself here while it counts a
step (``install``); the kernel wrappers declare each launch's work, or
its ``meta`` stand-in's, through ``declare``, and the models declare the
contractions they write as an elementwise product and a sum through
``products``.  With no analyzer installed, ``active()`` is a global read
and nothing else runs.  This module imports nothing of the port, so the
kernels depend on it and not on the launch layer.
"""

from __future__ import annotations

_active = None


def active():
    """The analyzer in effect, or None."""
    return _active


def install(analyzer) -> None:
    """Make ``analyzer`` (or None) the one in effect; one at a time."""
    global _active
    if analyzer is not None and _active is not None:
        raise RuntimeError("an analyzer is already active")
    _active = analyzer


def declare(kernel: str, flops: float, reads, writes) -> None:
    """One launch of ``kernel``: its FLOPs and the tensors it reads and
    writes, for the analyzer in effect (a no-op without one)."""
    a = _active
    if a is not None:
        a._declare(kernel, flops, reads, writes)


def products(flops: float) -> None:
    """FLOPs of a contraction written as elementwise ops, for the
    analyzer in effect (a no-op without one)."""
    a = _active
    if a is not None:
        a.product_flops += float(flops)


def address(t) -> int:
    """A tensor's address; 0 for a ``meta`` tensor, which has no storage
    (the wrappers' alignment checks then take it as aligned)."""
    return 0 if t.device.type == "meta" else t.data_ptr()
