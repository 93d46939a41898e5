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
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import math
import threading
from typing import Dict, Tuple

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
                       timeout_s: float = TIMEOUT_S) -> None:
    """The default process group for a mesh of ``device``'s type: NCCL
    for a card, gloo for the CPU, with a timeout.  ``store`` (e.g. a
    ``FileStore``) or ``init_method`` (``env://`` under ``torchrun``,
    ``tcp://localhost:<port>``) says how the ranks meet.  ``meta``: the
    fake backend, this process alone standing for ``rank`` of
    ``world_size`` (its store a ``FakeStore`` unless ``store`` is
    given)."""
    if torch.device(device).type == "meta":
        # importing the module registers the "fake" backend
        from torch.testing._internal.distributed.fake_pg import FakeStore
        store = store if store is not None else FakeStore()
    kwargs = dict(backend=backend_for(device), rank=rank,
                  world_size=world_size,
                  timeout=datetime.timedelta(seconds=timeout_s))
    if store is not None:
        kwargs["store"] = store
    else:
        kwargs["init_method"] = init_method or "env://"
    if torch.device(device).type == "cuda":
        kwargs["device_id"] = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(**kwargs)


def make_mesh(shape, axes, device=None):
    """A ``DeviceMesh`` of ``shape`` with the named ``axes`` over the
    ranks of the default process group (already initialized, its size
    the product of ``shape``), on ``device``'s type (default: the card).
    Ranks fill the mesh in row-major order, as ``jax.make_mesh`` fills
    its devices."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.device import resolve_device
    device = resolve_device(device)
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(mesh.init_process_group, or torchrun's env://)")
    want, have = backend_for(device), dist.get_backend()
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


def activation_sharding(dp_axes, dp_total: int, mesh=None,
                        tp_axis: str = TP_AXIS):
    """The launcher's mesh context: ``dp_axes`` carry the batch (each
    rank holds its slice), ``dp_total`` their product; ``mesh`` and
    ``tp_axis`` are what the EP MoE layer (``moe.moe_apply_ep``) reads."""
    return in_context(((tuple(dp_axes), int(dp_total)) if dp_axes else None,
                       (mesh, tp_axis)))


def saved_context():
    """This thread's mesh context, as ``in_context`` takes it."""
    return getattr(_ctx, "dp", None), getattr(_ctx, "mesh", None)


@contextlib.contextmanager
def in_context(saved):
    """The mesh context ``saved`` (from ``saved_context``) on this thread,
    the thread's own restored after (a layer recomputed on autograd's
    thread runs in its forward's context)."""
    old = saved_context()
    _ctx.dp, _ctx.mesh = saved
    try:
        yield
    finally:
        _ctx.dp, _ctx.mesh = old


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
