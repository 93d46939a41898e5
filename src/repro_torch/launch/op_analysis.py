"""Per-device FLOPs, bytes, collectives and memory of one eager step (the
port's counterpart of ``repro.launch.hlo_analysis``).

The reference compiles a step and parses its optimized HLO: XLA's own
cost analysis counts a while loop's body once, so it walks the call
graph and multiplies each body by its trip count.  The port has no HLO:
a step is eager torch, every loop iteration runs and dispatches its own
ops, so an op is counted each time it runs and no trip-count correction
exists.  ``analyze(fn, *args)`` runs ``fn`` under a dispatch mode and
returns the reference's keys and three more:

  * ``flops``: 2*M*N*K of every product, by ``torch.utils.flop_counter``'s
    registry (the formulas ``FlopCounterMode`` applies), plus the kernels'
    declared products;
  * ``matvec_flops``: the part of ``flops`` in matrix-vector products,
    an ``mm`` or ``addmm`` of one row (a decode step at batch 1).  XLA's
    CPU compiler fuses each such dot into a loop fusion, and the
    reference's count, which reads the dots of the computations it walks
    and no fusion's body, leaves them out: ``flops - matvec_flops`` is
    what it counts (a batched product of one row, ``bmm``, stays a dot
    there and is not in this part);
  * ``bytes_out``: the output bytes of every op that is not a view or an
    alias (a pure allocation, ``empty``, writes nothing); an in-place op
    is credited at the tensor it writes, so a row written into a buffer
    counts the row's view, as the reference credits a
    ``dynamic-update-slice`` with its update; collectives count their
    payload; kernels the bytes they write;
  * ``collectives``: payload bytes by kind (the reference's names:
    ``all-gather``, ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
    ``collective-permute``) with a ``<kind>_count`` each and a ``total``,
    from the ``c10d`` ops the mode sees; the payload is the collective's
    output bytes, as the reference counts the instruction's shape;
  * ``whiles``: always empty (no loop is compiled), ``n_computations``:
    the ops dispatched;
  * ``memory``: ``argument_size_in_bytes``, the storages of ``args`` that
    the step reads (an op or a kernel takes them), as ``jax.jit`` prunes
    the arguments a compiled step never reads; ``resident_argument_bytes``,
    every storage of ``args``; ``output_size_in_bytes`` (the storages of
    the result) and ``temp_size_in_bytes``, the peak of the bytes
    allocated inside the step and still alive, over the step (each
    storage counted once, from the op that made it until it is freed);
  * ``launches`` and ``kernels``: per hand-written kernel, its launches
    and its declared FLOPs, bytes read and bytes written.

``products`` declares the FLOPs of a contraction the code writes as an
elementwise product and a sum (the reference writes it as an einsum, a
dot its count takes), so both packages count the same work.

The kernel wrappers report their work through ``repro_torch._work``,
where an analyzer installs itself while it counts: on a CUDA tensor
after the launch, on a ``meta`` tensor instead of it (the dry run), so a
step counted on the card and the same step counted on ``meta`` read
alike.  With no analyzer installed ``_work.active()`` is a global read
and nothing else runs.
"""

from __future__ import annotations

import weakref
from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch import _work
from repro_torch._work import active, declare, products  # noqa: F401

# c10d op -> (reference kind, the argument holding its output)
_C10D = {
    "allgather_": ("all-gather", 0),
    "_allgather_base_": ("all-gather", 0),
    "allgather_into_tensor_coalesced_": ("all-gather", 0),
    "allgather_coalesced_": ("all-gather", 0),
    "allreduce_": ("all-reduce", 0),
    "allreduce_coalesced_": ("all-reduce", 0),
    "reduce_scatter_": ("reduce-scatter", 0),
    "_reduce_scatter_base_": ("reduce-scatter", 0),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 0),
    "alltoall_": ("all-to-all", 0),
    "alltoall_base_": ("all-to-all", 0),
    "send": ("collective-permute", 0),
    "recv_": ("collective-permute", 0),
    "broadcast_": ("broadcast", 0),
}

# products of two matrices, no batch axis
_MATRIX_PRODUCTS = {"mm", "addmm"}

# allocations that write nothing
_ALLOCATIONS = {"empty", "empty_like", "empty_strided", "new_empty",
                "new_empty_strided"}

def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x) -> list:
    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages of a tree's tensors."""
    seen, n = set(), 0
    for t in _tensors(tree):
        st = t.untyped_storage()
        if st._cdata not in seen:
            seen.add(st._cdata)
            n += st.nbytes()
    return n


def _flat(x, out: list) -> list:
    """The tensors of an op's argument (a tensor or a list of them)."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _flat(y, out)
    return out


class _OpInfo:
    """What the mode needs of an op, read once from its schema."""
    __slots__ = ("view", "written", "written_kw", "allocation", "c10d",
                 "flops", "matrix")

    def __init__(self, func):
        from torch.utils.flop_counter import flop_registry
        schema = func._schema
        self.view = any(r.alias_info is not None and not r.alias_info.is_write
                        for r in schema.returns)
        writes = [(i, a.name) for i, a in enumerate(schema.arguments)
                  if a.alias_info is not None and a.alias_info.is_write]
        self.written = tuple(i for i, _ in writes)
        self.written_kw = tuple(n for _, n in writes)
        if any(r.alias_info is not None for r in schema.returns) \
                and not writes:
            self.view = True
        packet = func._overloadpacket
        self.allocation = packet.__name__ in _ALLOCATIONS
        self.c10d = (_C10D.get(schema.name.split("::")[-1])
                     if func.namespace == "c10d" else None)
        self.flops = flop_registry.get(packet)
        self.matrix = packet.__name__ in _MATRIX_PRODUCTS


class _Mode(TorchDispatchMode):
    """Counts FLOPs (``torch.utils.flop_counter``'s registry), bytes,
    collectives and live storages of every op."""

    def __init__(self, analyzer: "Analyzer"):
        super().__init__()
        self.a = analyzer
        self.info = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        info = self.info.get(func)
        if info is None:
            info = self.info[func] = _OpInfo(func)
        a = self.a
        a.n_ops += 1
        if info.view:
            return out                    # a view or an alias
        ins = []
        for x in args:
            _flat(x, ins)
        for x in kwargs.values():
            _flat(x, ins)
        a._read(ins)
        if info.flops is not None:
            flops = info.flops(*args, **kwargs, out_val=out)
            a.op_flops += flops
            if info.matrix and out.shape[0] == 1:
                a.matvec_flops += flops
        if info.c10d is not None:
            kind, at = info.c10d
            a._collective(kind, sum(map(_nbytes, _flat(args[at], []))))
            return out
        if info.written or info.written_kw:  # in place: what it writes
            written = [args[i] for i in info.written if i < len(args)]
            written += [kwargs[n] for n in info.written_kw if n in kwargs]
            a.bytes_out += sum(map(_nbytes, _flat(written, [])))
            return out
        fresh = _flat(out, [])
        if not info.allocation:
            a.bytes_out += sum(map(_nbytes, fresh))
        for t in fresh:
            a._allocated(t.untyped_storage())
        return out


class Analyzer:
    """``with Analyzer(args) as a:`` counts what runs inside; ``a.report()``
    gives the counts.  ``args`` (any tree of tensors) are the step's
    arguments: their storages are the argument bytes and never count as
    allocated inside the step."""

    def __init__(self, args=()):
        self.args = args
        self._args = {}
        for t in _tensors(args):
            st = t.untyped_storage()
            self._args[st._cdata] = st.nbytes()
        self._used = set()
        self.product_flops = 0.0
        self.op_flops = 0
        self.matvec_flops = 0
        self.bytes_out = 0.0
        self.n_ops = 0
        self.coll: Dict[str, float] = {}
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.live = 0
        self.peak = 0
        self._tracked: Dict[int, Any] = {}
        self.output = None

    # -- the kernels' and the mode's records -------------------------------
    def _declare(self, kernel, flops, reads, writes):
        self._read(reads)
        k = self.kernels.setdefault(kernel, dict(
            launches=0, flops=0.0, bytes_read=0.0, bytes_written=0.0))
        written = sum(_nbytes(t) for t in writes)
        k["launches"] += 1
        k["flops"] += float(flops)
        k["bytes_read"] += float(sum(_nbytes(t) for t in reads))
        k["bytes_written"] += float(written)
        self.bytes_out += float(written)

    def _read(self, tensors):
        for t in tensors:
            key = t.untyped_storage()._cdata
            if key in self._args:
                self._used.add(key)

    def _collective(self, kind, payload):
        self.coll[kind] = self.coll.get(kind, 0.0) + float(payload)
        self.coll[kind + "_count"] = self.coll.get(kind + "_count", 0) + 1
        self.bytes_out += float(payload)

    def _allocated(self, st):
        key = st._cdata
        if key in self._tracked or key in self._args:
            return
        n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)

        def freed(key=key, n=n):
            self.live -= n
            self._tracked.pop(key, None)

        self._tracked[key] = weakref.finalize(st, freed)

    # -- the context -------------------------------------------------------
    def __enter__(self):
        _work.install(self)
        self._mode = _Mode(self)
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        _work.install(None)
        self._mode.__exit__(*exc)
        for f in self._tracked.values():
            f.detach()
        return False

    def report(self) -> dict:
        """The reference's keys (``flops``, ``bytes_out``, ``collectives``,
        ``whiles``, ``n_computations``) and ``matvec_flops``, ``memory``,
        ``launches`` and ``kernels``."""
        coll = dict(self.coll)
        coll["total"] = sum(v for k, v in coll.items()
                            if not k.endswith("_count") and k != "total")
        kernel_flops = sum(k["flops"] for k in self.kernels.values())
        return {
            "flops": (float(self.op_flops) + kernel_flops
                      + self.product_flops),
            "matvec_flops": float(self.matvec_flops),
            "bytes_out": float(self.bytes_out),
            "collectives": coll,
            "whiles": [],
            "n_computations": self.n_ops,
            "memory": {
                "argument_size_in_bytes": sum(self._args[k]
                                              for k in self._used),
                "resident_argument_bytes": storage_bytes(self.args),
                "output_size_in_bytes": storage_bytes(self.output),
                "temp_size_in_bytes": int(self.peak)},
            "launches": {k: v["launches"] for k, v in self.kernels.items()},
            "kernels": {k: dict(v) for k, v in self.kernels.items()},
        }


def analyze(fn, *args, **kwargs):
    """(fn(*args, **kwargs), its report): ``fn`` run once under an
    ``Analyzer`` whose arguments are ``args``."""
    with Analyzer(args) as a:
        out = fn(*args, **kwargs)
        a.output = out
    return out, a.report()
