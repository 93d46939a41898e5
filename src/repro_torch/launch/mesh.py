"""Device meshes on ``torch.distributed`` (port of ``repro.launch.mesh``).

The reference's mesh is a ``jax.sharding.Mesh``: named axes over the
devices of one SPMD program.  Here a mesh is a ``DeviceMesh`` over the
ranks of one process group, one process a device, with the reference's
axis names (``data``, ``model``, and ``pod`` on two pods).

``make_production_mesh`` gives the production layout as a shape alone
(``MeshShape``): 256 or 512 processes are never started to read the
sharding rules, which take either a ``MeshShape`` or a ``DeviceMesh``
through ``axis_sizes``.

The process group's backend follows the device: NCCL for CUDA tensors,
gloo for CPU tensors, and for ``meta`` tensors (the dry run) PyTorch's
fake backend (``torch.testing._internal.distributed.fake_pg``), over
which one process stands for a rank of a mesh of any size: collectives
complete and move nothing (``init_process_group``).  A CUDA mesh over a
gloo group, or a CPU mesh over an NCCL one, raises: a collective never
falls back from one to the other.  Every group gets a timeout, so a rank that
never reaches a collective fails the others instead of hanging them.

The launcher's mesh context (``activation_sharding``, as the
reference's ``layers.activation_sharding``) is kept here too: the one
place that knows which ranks share a batch.  The EP MoE layer reads its
mesh (``current_mesh``); the activation quantization takes its absmax
over the dp ranks (``dp_max``).

With ``split=True`` the context also says that the params hold their
``model`` shards (the tensor-parallel split): ``current_split`` gives
the ``model`` group (``ModelSplit``: group, size, rank) to the layers,
which compute their heads, columns, vocab rows and experts only and
meet through autograd-aware collectives over that group:
``copy_to_model`` (the identity; its gradient the sum over the group)
where a replicated tensor enters a split region, ``reduce_from_model``
(the sum over the group; its gradient the identity) where a region's
partial sums leave it, ``gather_from_model`` (the ranks' slices joined;
its gradient the rank's slice) where a split result is needed whole,
and ``model_max`` for a quantization scale that spans a split
dimension.  Over a ``model`` axis of one rank there is no
split: ``current_split`` is None and nothing runs.

With ``seq_axes`` the context also says that the serving cache is split
over its sequence (``sharding.cache_spec(..., seq_shard=True)``): over
``model``, or over ``("data", "model")`` where the batch does not divide
the dp axes.  ``current_seq`` gives that group (``SeqGroup``: group,
size, this rank's slice) to the attention, which attends over its slice
of the keys and combines the softmax across the group with
``SeqGroup.max`` and ``SeqGroup.sum`` (all-reduces, no gradient:
serving).  The ``model`` group is the split's own process group; a
``data`` x ``model`` group is one made for it (``fold_group``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import math
import threading
from typing import Any, Dict, NamedTuple, Tuple

import torch
import torch.distributed as dist

DP_AXES = ("pod", "data")
TP_AXIS = "model"
TIMEOUT_S = 300


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, without processes: what the
    sharding rules read of a mesh.  ``shape`` maps an axis to its size,
    as the reference's ``Mesh.shape`` does."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """16 x 16 = 256 chips a pod; 2 pods = 512 with a leading ``pod``
    axis.  A shape only: no process is started."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


BACKENDS = {"cuda": "nccl", "cpu": "gloo", "meta": "fake"}


def backend_for(device) -> str:
    """The process group backend of a device type: NCCL for CUDA, gloo
    for the CPU, the fake backend for ``meta``."""
    kind = torch.device(device).type
    if kind not in BACKENDS:
        raise ValueError(f"no collective backend for device type {kind!r}")
    return BACKENDS[kind]


def init_process_group(device, rank: int, world_size: int, *, store=None,
                       init_method: str | None = None,
                       timeout_s: float = TIMEOUT_S,
                       backend: str | None = None) -> None:
    """The default process group for a mesh of ``device``'s type: NCCL
    for a card, gloo for the CPU, with a timeout.  ``store`` (e.g. a
    ``FileStore``) or ``init_method`` (``env://`` under ``torchrun``,
    ``tcp://localhost:<port>``) says how the ranks meet.  ``meta``: the
    fake backend, this process alone standing for ``rank`` of
    ``world_size`` (its store a ``FakeStore`` unless ``store`` is
    given).  ``backend`` names another backend explicitly (gloo for
    two ranks on one card, which NCCL refuses); nothing picks it by
    itself, and ``make_mesh`` then needs the same ``backend``."""
    if torch.device(device).type == "meta":
        # importing the module registers the "fake" backend
        from torch.testing._internal.distributed.fake_pg import FakeStore
        store = store if store is not None else FakeStore()
    kwargs = dict(backend=backend or backend_for(device), rank=rank,
                  world_size=world_size,
                  timeout=datetime.timedelta(seconds=timeout_s))
    if store is not None:
        kwargs["store"] = store
    else:
        kwargs["init_method"] = init_method or "env://"
    if kwargs["backend"] == "nccl":
        kwargs["device_id"] = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(**kwargs)


def make_mesh(shape, axes, device=None, backend: str | None = None):
    """A ``DeviceMesh`` of ``shape`` with the named ``axes`` over the
    ranks of the default process group (already initialized, its size
    the product of ``shape``), on ``device``'s type (default: the card).
    Ranks fill the mesh in row-major order, as ``jax.make_mesh`` fills
    its devices.  The group's backend must be the device's, or
    ``backend`` where the caller named another one to
    ``init_process_group``."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.device import resolve_device
    device = resolve_device(device)
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(mesh.init_process_group, or torchrun's env://)")
    want, have = backend or backend_for(device), dist.get_backend()
    if have != want:
        raise RuntimeError(f"a {device.type} mesh needs a {want} process "
                           f"group, not {have}: collectives do not fall "
                           f"back from one backend to another")
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks, the "
                         f"process group has {dist.get_world_size()}")
    return init_device_mesh(device.type, shape, mesh_dim_names=axes)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis: size} of a ``MeshShape`` or a ``DeviceMesh`` (whose own
    ``shape`` is a tuple, not the reference's mapping)."""
    if isinstance(mesh, MeshShape):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_names(mesh) -> Tuple[str, ...]:
    if isinstance(mesh, MeshShape):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names)


def dp_axes(mesh) -> tuple:
    """The data-parallel axes of a mesh (the pod axis included when
    present)."""
    return tuple(a for a in axis_names(mesh) if a in DP_AXES)


def tp_axis(mesh) -> str:
    return TP_AXIS


def dp_total(mesh) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in dp_axes(mesh))


def coordinate(mesh, rank: int | None = None) -> Dict[str, int]:
    """{axis: index} of ``rank`` (default: this process) in a
    ``DeviceMesh``."""
    if rank is None:
        coord = mesh.get_coordinate()
    else:
        at = (mesh.mesh == rank).nonzero()
        if at.shape[0] != 1:
            raise ValueError(f"rank {rank} is not in the mesh")
        coord = at[0].tolist()
    return dict(zip(mesh.mesh_dim_names, coord))


def dp_index(mesh) -> int:
    """This process's index on the data-parallel axes (row-major over
    them, the pod axis major): ranks that share it hold the same slice of
    the batch."""
    if mesh is None:
        return 0
    coord, sizes = coordinate(mesh), axis_sizes(mesh)
    i = 0
    for a in dp_axes(mesh):
        i = i * sizes[a] + coord[a]
    return i


def all_reduce(t: torch.Tensor, mesh, axes, op=dist.ReduceOp.SUM):
    """``t`` reduced in place over the mesh ``axes`` (one collective an
    axis, over this process's group of it: a sum over pod then data is
    the sum over both)."""
    for a in axes:
        dist.all_reduce(t, op=op, group=mesh.get_group(a))
    return t


# ---------------------------------------------------------------------------
# the launcher's mesh context
# ---------------------------------------------------------------------------

_ctx = threading.local()


class ModelSplit(NamedTuple):
    """This rank's ``model`` group under the tensor-parallel split: the
    process group, its size and this rank's index in it."""
    group: Any
    size: int
    rank: int

    def divides(self, n: int) -> bool:
        """The sharding rules split a dimension of n over ``model``."""
        return n % self.size == 0


def model_split(mesh, tp_axis: str = TP_AXIS):
    """The ``ModelSplit`` of ``mesh``'s ``model`` axis, or None where the
    axis has one rank (or the mesh none)."""
    if mesh is None or tp_axis not in axis_names(mesh):
        return None
    size = axis_sizes(mesh)[tp_axis]
    if size == 1:
        return None
    return ModelSplit(mesh.get_group(tp_axis), size,
                      coordinate(mesh)[tp_axis])


def activation_sharding(dp_axes, dp_total: int, mesh=None,
                        tp_axis: str = TP_AXIS, split: bool = False,
                        seq_axes=None):
    """The launcher's mesh context: ``dp_axes`` carry the batch (each
    rank holds its slice), ``dp_total`` their product; ``mesh`` and
    ``tp_axis`` are what the EP MoE layer (``moe.moe_apply_ep``) reads.
    ``split``: the params hold their ``model`` shards, and the layers
    compute the rank's part (``current_split``).  ``seq_axes``: the mesh
    axes (a name or a tuple, major first) over which the serving cache
    splits its sequence (``current_seq``)."""
    return in_context(((tuple(dp_axes), int(dp_total)) if dp_axes else None,
                       (mesh, tp_axis),
                       model_split(mesh, tp_axis) if split else None,
                       seq_group(mesh, seq_axes) if seq_axes else None))


def saved_context():
    """This thread's mesh context, as ``in_context`` takes it."""
    return (getattr(_ctx, "dp", None), getattr(_ctx, "mesh", None),
            getattr(_ctx, "split", None), getattr(_ctx, "seq", None))


@contextlib.contextmanager
def in_context(saved):
    """The mesh context ``saved`` (from ``saved_context``) on this thread,
    the thread's own restored after (a layer recomputed on autograd's
    thread runs in its forward's context)."""
    old = saved_context()
    _ctx.dp, _ctx.mesh, _ctx.split, _ctx.seq = saved
    try:
        yield
    finally:
        _ctx.dp, _ctx.mesh, _ctx.split, _ctx.seq = old


def current_mesh():
    """(mesh, tp_axis) of the launcher's context, or (None, None)."""
    m = getattr(_ctx, "mesh", None)
    return m if m is not None else (None, None)


def current_dp() -> tuple:
    """The context's dp axes (() without a context)."""
    dp = getattr(_ctx, "dp", None)
    return dp[0] if dp else ()


def dp_max(t: torch.Tensor) -> torch.Tensor:
    """``t``'s max over the dp ranks of the context (in place): the
    global batch's where each rank holds a slice.  Without a context, or
    over one dp rank, ``t`` itself, and no collective runs."""
    mesh, _ = current_mesh()
    dp = getattr(_ctx, "dp", None)
    if mesh is None or dp is None or dp[1] == 1:
        return t
    return all_reduce(t, mesh, dp[0], dist.ReduceOp.MAX)


# ---------------------------------------------------------------------------
# the tensor-parallel split: collectives over the model group
# ---------------------------------------------------------------------------

def current_split():
    """The context's ``ModelSplit`` when the params hold their ``model``
    shards over more than one rank, else None."""
    return getattr(_ctx, "split", None)


class _CopyToModel(torch.autograd.Function):
    """The identity on a tensor every rank of the group holds whole and
    uses for its own part; its gradient, each rank's part, summed over
    the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """The sum over the group of each rank's partial tensor; its gradient
    (the same on every rank, what follows being replicated) passes as it
    is."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """The ranks' slices joined along ``dim`` in rank order (an all-gather
    over the group).  Its gradient is this rank's slice: of its own
    gradient where what follows is replicated (the same on every rank),
    of the group's sum where what follows is split (``summed``: each
    rank's gradient a part; a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, split, dim, summed):
        ctx.split, ctx.dim, ctx.summed = split, dim, summed
        part = x.contiguous()
        parts = [torch.empty_like(part) for _ in range(split.size)]
        dist.all_gather(parts, part, group=split.group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        split, dim = ctx.split, ctx.dim
        if not ctx.summed:
            return g.chunk(split.size, dim)[split.rank], None, None, None
        whole = g.movedim(dim, 0).contiguous()
        mine = whole.new_empty((whole.shape[0] // split.size,
                                *whole.shape[1:]))
        dist.reduce_scatter_tensor(mine, whole, group=split.group)
        return mine.movedim(0, dim), None, None, None


def gather_from_model(x: torch.Tensor, dim: int = -1,
                      into_split: bool = False) -> torch.Tensor:
    """The group's slices of ``x`` joined along ``dim``
    (``_GatherFromModel``); ``into_split``: the result enters a split
    region.  x itself off the split."""
    split = current_split()
    if split is None:
        return x
    return _GatherFromModel.apply(x, split, dim % x.ndim, into_split)


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """``x`` entering a split region (``_CopyToModel``); x itself off the
    split."""
    split = current_split()
    return x if split is None else _CopyToModel.apply(x, split.group)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """The sum of the ranks' partial ``x`` over the model group
    (``_ReduceFromModel``); x itself off the split."""
    split = current_split()
    return x if split is None else _ReduceFromModel.apply(x, split.group)


def model_max(t: torch.Tensor) -> torch.Tensor:
    """``t``'s max over the model group (in place, no gradient): a
    quantization scale over a dimension the ranks split.  ``t`` itself
    off the split."""
    split = current_split()
    if split is None:
        return t
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=split.group)
    return t


# ---------------------------------------------------------------------------
# the sequence-sharded cache: collectives over the cache's sequence group
# ---------------------------------------------------------------------------

class SeqGroup(NamedTuple):
    """The ranks over which the serving cache splits its sequence: the
    process group, its size and this rank's slice (rows [rank * n, +n) of
    the cache's n * size); ``rest``, the group of the fold's ``data``
    axis (None over ``model`` alone).
    Its collectives reduce in place, with no gradient."""
    group: Any
    size: int
    rank: int
    rest: Any = None

    def max(self, t: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return t

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(t, group=self.group)
        return t


_FOLD_GROUPS: Dict[Any, Any] = {}


def fold_group(mesh, axes: tuple):
    """This rank's process group over the mesh ``axes`` together (the
    cache's ``("data", "model")`` fold): the whole default group where
    they span the mesh, else one group a coordinate of the other axes,
    every such group made on every rank in the same order (as
    ``new_group`` asks), once a mesh."""
    names, sizes = axis_names(mesh), axis_sizes(mesh)
    if math.prod(sizes[a] for a in axes) == dist.get_world_size():
        return dist.group.WORLD
    key = (id(mesh), tuple(axes))
    if key not in _FOLD_GROUPS:
        ids = mesh.mesh.permute(
            *[names.index(a) for a in names if a not in axes],
            *[names.index(a) for a in axes])
        ids = ids.reshape(-1, math.prod(sizes[a] for a in axes))
        mine = None
        for row in ids.tolist():
            g = dist.new_group(ranks=row)
            if dist.get_rank() in row:
                mine = g
        _FOLD_GROUPS[key] = mine
    return _FOLD_GROUPS[key]


def seq_group(mesh, axes):
    """The ``SeqGroup`` of the mesh ``axes`` (a name or a tuple, major
    first), or None where they hold one rank."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    sizes = axis_sizes(mesh)
    size = math.prod(sizes[a] for a in axes)
    if size == 1:
        return None
    coord = coordinate(mesh)
    rank = 0
    for a in axes:
        rank = rank * sizes[a] + coord[a]
    if len(axes) == 1:
        return SeqGroup(mesh.get_group(axes[0]), size, rank)
    # the fold, ("data", "model"): ``rest`` is the data axis's group
    return SeqGroup(fold_group(mesh, axes), size, rank,
                    mesh.get_group(axes[0]))


class ThreadGroup:
    """n slices of a sequence group in one process, each served on a
    thread of its own: ``member(i)`` is slice i's stand-in for its
    ``SeqGroup``, whose ``max`` / ``sum`` wait for every slice's tensor and
    reduce them in slice order (the combine checked on one device, as
    ``chip_smoke.py`` checks it on the card)."""

    def __init__(self, n: int):
        self.n = n
        self.barrier = threading.Barrier(n)
        self.held = [None] * n

    def member(self, i: int):
        return _ThreadMember(self, i)

    def reduce(self, i: int, t: torch.Tensor, op) -> torch.Tensor:
        self.held[i] = t.clone()
        self.barrier.wait()
        total = self.held[0]
        for x in self.held[1:]:
            total = op(total, x)
        self.barrier.wait()
        return t.copy_(total)


class _ThreadMember(NamedTuple):
    group: ThreadGroup
    rank: int

    @property
    def size(self) -> int:
        return self.group.n

    def max(self, t: torch.Tensor) -> torch.Tensor:
        return self.group.reduce(self.rank, t, torch.maximum)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return self.group.reduce(self.rank, t, torch.add)


def current_seq():
    """The context's ``SeqGroup`` when the serving cache splits its
    sequence over more than one rank, else None."""
    return getattr(_ctx, "seq", None)


def split_max(t: torch.Tensor) -> torch.Tensor:
    """``t``'s max over the dp ranks and the model group: the absmax of a
    tensor of which each rank holds a slice of the batch and a slice of
    the features."""
    return model_max(dp_max(t))
