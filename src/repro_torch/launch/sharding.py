"""Per-architecture sharding rules (port of ``repro.launch.sharding``:
DP / FSDP / TP / EP / sequence).

The rules are the reference's, leaf by leaf, on the port's param trees,
whose paths are the reference's (``convert.params_from_numpy`` keeps the
tree).  Training params take the FSDP+TP layout: the TP dimension
(attention heads, FFN hidden, vocab) over ``model``, the other large
dimension over ``data``.  Serving params shard over ``model`` only.
Attention projections TP-shard only where the head count divides the
``model`` axis; MoE experts shard over ``model`` (expert parallelism).
Long-context KV caches whose heads do not divide ``model`` shard over
the sequence instead.

A spec is a tuple with one entry a dimension: ``None``, an axis name, or
a tuple of axis names (the dimension split over their product, the first
axis major), the counterpart of ``PartitionSpec``.  A ``Sharding`` is a
spec on a mesh: it gives each rank its slice (offset and local shape) of
a global leaf, and moves a leaf between its global and local forms.  A
rule names an axis only where the axis divides the dimension, so every
shard is even; ``Sharding`` raises on an uneven one rather than pad.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, NamedTuple, Tuple

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import (axis_names, axis_sizes, coordinate,
                                     dp_axes, dp_total)

Spec = Tuple[Any, ...]


def _fsdp_axis(mesh):
    return "data"


def _div(n: int, mesh, axis) -> bool:
    sizes = axis_sizes(mesh)
    return axis in sizes and n % sizes[axis] == 0


def param_spec(cfg, mesh, path: str, shape, mode: str = "train") -> Spec:
    """The spec of one parameter leaf (the reference's rules)."""
    m = "model"
    d = _fsdp_axis(mesh) if mode == "train" else None
    # packed serving weights: codes shard like the parent weight; the
    # per-channel scales stay replicated (small)
    if "/scale" in path and re.search(r"/scale$", path):
        return (None,) * len(shape)
    if "codes__" in path:
        path = re.sub(r"/codes__\w+$", "", path)
    rank = len(shape)

    def ax(axis, dim):
        """axis if that mesh axis divides shape[dim], else None."""
        if axis is None:
            return None
        return axis if _div(shape[dim], mesh, axis) else None

    none = (None,) * rank

    # ---- embeddings -------------------------------------------------------
    if re.search(r"(embed|tok_embed)$", path):
        return (ax(m, 0), ax(d, 1))
    if re.search(r"pos_embed$", path):
        return (None, ax(d, 1))
    if re.search(r"lm_head$", path):
        return (ax(d, 0), ax(m, 1))

    # ---- MoE ----------------------------------------------------------------
    if "experts/" in path:
        # (L, E, d, f) up/gate; (L, E, f, d) down: EP over model on E
        if rank == 4:
            if path.endswith("w_down"):
                return (None, ax(m, 1), None, ax(d, 3))
            return (None, ax(m, 1), ax(d, 2), None)
        return none
    if path.endswith("router"):
        return (None, ax(d, 1), None) if rank == 3 else (ax(d, 0), None)

    # ---- attention ------------------------------------------------------------
    is_stacked = rank == 3  # (L, in, out)
    i, o = (1, 2) if is_stacked else (0, 1)
    tp_q = _div(cfg.n_heads, mesh, "model") if cfg.n_heads else False
    tp_kv = _div(cfg.kv_heads, mesh, "model") if cfg.kv_heads else False
    lead = (None,) if is_stacked else ()
    if re.search(r"(attn|self_attn|cross_attn)/wq$", path):
        return (*lead, ax(d, i), m if tp_q else None)
    if re.search(r"(attn|self_attn|cross_attn)/w[kv]$", path):
        return (*lead, ax(d, i), m if tp_kv else None)
    if re.search(r"(attn|self_attn|cross_attn)/wo$", path):
        return (*lead, m if tp_q else None, ax(d, o))

    # ---- RWKV time/channel mix ---------------------------------------------
    if re.search(r"tm/w[rkvg]$", path):
        return (*lead, ax(d, i), ax(m, o))
    if re.search(r"tm/(wo)$", path):
        return (*lead, ax(m, i), ax(d, o))
    if re.search(r"tm/wa$", path):
        return (*lead, ax(d, i), None)
    if re.search(r"tm/wb$", path):
        return (*lead, None, ax(d, o))
    if re.search(r"cm/wk$", path):
        return (*lead, ax(d, i), ax(m, o))
    if re.search(r"cm/(wv)$", path):
        return (*lead, ax(m, i), ax(d, o))
    if re.search(r"cm/wr$", path):
        return (*lead, ax(d, i), ax(m, o))

    # ---- Mamba ---------------------------------------------------------------
    if path.endswith("in_proj"):
        return (*((None,) * (rank - 2)), ax(d, rank - 2), ax(m, rank - 1))
    if path.endswith("out_proj"):
        return (*((None,) * (rank - 2)), ax(m, rank - 2), ax(d, rank - 1))
    if path.endswith("conv_w"):
        return (*((None,) * (rank - 1)), ax(m, rank - 1))
    if path.endswith("conv_b") or path.endswith("norm"):
        return (*((None,) * (rank - 1)), ax(m, rank - 1))

    # ---- generic MLP -----------------------------------------------------------
    if re.search(r"(w_up|w_gate)$", path):
        return (*((None,) * (rank - 2)), ax(d, rank - 2), ax(m, rank - 1))
    if re.search(r"w_down$", path):
        return (*((None,) * (rank - 2)), ax(m, rank - 2), ax(d, rank - 1))
    if re.search(r"fc\d?$", path) and rank == 2:
        return (ax(d, 0), ax(m, 1))

    # ---- everything else (norm scales, biases, mu, u, ...): replicated -----
    return none


class AttnHeads(NamedTuple):
    """A rank's share of one attention layer under the tensor-parallel
    split, by ``param_spec``'s attention rules: ``q`` query heads (the
    rank's, from rank * q), ``q_split`` whether ``wq``'s columns and
    ``wo``'s rows are split; ``kv_split`` whether ``wk`` / ``wv``'s
    columns are; and the ``kv`` KV heads its queries read (of every KV
    head after ``kv_replicate_to``), from ``kv_lo``."""
    q: int
    kv: int
    kv_lo: int
    q_split: bool
    kv_split: bool


def attn_heads(n_heads: int, kv_heads: int, kv_total: int,
               split) -> AttnHeads:
    """The ``AttnHeads`` of a layer of ``n_heads`` query and ``kv_heads``
    KV heads (``kv_total`` after ``kv_replicate_to``) under ``split``
    (``mesh.ModelSplit`` or None).  The three cases: q and kv split (the
    GQA ratio kept), q split over a replicated kv (the rank's q heads
    read ``kv_total / m`` heads, or one where fewer than a group), and
    nothing split (the layer whole on every rank)."""
    if split is None or not split.divides(n_heads):
        return AttnHeads(n_heads, kv_total, 0, False, False)
    q = n_heads // split.size
    group = n_heads // kv_total
    if q >= group:
        kv = q // group
        lo = split.rank * kv
    else:
        kv, lo = 1, split.rank * q // group
    return AttnHeads(q, kv, lo, True, split.divides(kv_heads))


class SsmHeads(NamedTuple):
    """A rank's share of one RWKV6 time mix or Mamba2 block under the
    tensor-parallel split: ``n`` heads from ``lo``, and whether the layer
    splits (``split``) or stays whole on every rank."""
    n: int
    lo: int
    split: bool


def ssm_heads(n_heads: int, split, *widths) -> SsmHeads:
    """The ``SsmHeads`` of a layer of ``n_heads`` heads under ``split``
    (``mesh.ModelSplit`` or None): the rank's ``n_heads / m`` where ``m``
    divides the heads and every one of ``widths`` (the split leaves'
    columns: RWKV6's channel-mix width, Mamba2's ``in_proj`` width), else
    the layer whole."""
    if split is None or not all(split.divides(n) for n in (n_heads,
                                                            *widths)):
        return SsmHeads(n_heads, 0, False)
    n = n_heads // split.size
    return SsmHeads(n, split.rank * n, True)


def map_with_path(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over a tree of dicts and lists, keeping its
    structure; paths join keys and list indices with "/", as the
    reference's ``tree_map_with_path`` keys."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, f"{path}/{i}" if path
                                        else str(i))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def make_param_specs(cfg, params, mesh, mode: str = "train"):
    """The tree of specs matching a params tree (tensors of any device,
    ``meta`` included)."""
    return map_with_path(
        lambda path, leaf: param_spec(cfg, mesh, path, tuple(leaf.shape),
                                      mode), params)


def make_param_shardings(cfg, params, mesh, mode: str = "train"):
    return map_with_path(
        lambda path, leaf: Sharding(mesh, param_spec(
            cfg, mesh, path, tuple(leaf.shape), mode)), params)


# ---------------------------------------------------------------------------
# batch / cache specs
# ---------------------------------------------------------------------------

def batch_spec(cfg, mesh, kind: str = "train"):
    """leaf_spec(key, ndim): the spec of an input batch's leaf (the batch
    over the dp axes)."""
    dp = dp_axes(mesh)

    def leaf_spec(key: str, ndim: int) -> Spec:
        return (dp, *(None,) * (ndim - 1))

    return leaf_spec


def make_batch_shardings(batch, cfg, mesh):
    dp = dp_axes(mesh)
    return map_with_path(
        lambda path, leaf: Sharding(mesh, (dp, *(None,) * (leaf.ndim - 1))),
        batch)


def cache_spec(cfg, mesh, path: str, shape, seq_shard: bool = False) -> Spec:
    """KV-cache / SSM-state sharding.

    KV tensors are (..., B, S, Hkv, Dh): batch over dp; heads over model
    if divisible, else (for long context) the SEQUENCE dim over model.
    SSM states (..., B, H, dk, dv): heads over model when divisible.
    """
    dp = dp_axes(mesh)
    sizes = axis_sizes(mesh)
    total = dp_total(mesh)
    rank = len(shape)
    if path.endswith("index"):
        return (None,) * rank
    if rank >= 4 and (re.search(r"(^|/)k$", path)
                      or re.search(r"(^|/)v$", path)):
        b_dim = rank - 4
        lead = (None,) * b_dim
        heads = shape[rank - 2]
        bp = dp if shape[b_dim] % total == 0 else None
        if heads % sizes["model"] == 0 and not seq_shard:
            return (*lead, bp, None, "model", None)
        if seq_shard:
            # batch 1 long context: fold the idle data axis into the
            # sequence sharding
            seq_ax = "model" if bp is not None else ("data", "model")
            return (*lead, bp, seq_ax, None, None)
        return (*lead, bp, None, None, None)
    if re.search(r"(^|/)s$", path) and rank >= 4:    # SSM state (..B,H,dk,dv)
        lead = (None,) * (rank - 4)
        h = shape[rank - 3]
        hs = "model" if h % sizes["model"] == 0 else None
        bp = dp if shape[rank - 4] % total == 0 else None
        return (*lead, bp, hs, None, None)
    if re.search(r"(tm_last|cm_last)$", path) and rank >= 2:
        bp = dp if shape[rank - 2] % total == 0 else None
        return (*(None,) * (rank - 2), bp, None)
    if path.endswith("conv") and rank >= 3:          # (..., B, W-1, C)
        c = shape[-1]
        cs = "model" if c % sizes["model"] == 0 else None
        bp = dp if shape[rank - 3] % total == 0 else None
        return (*(None,) * (rank - 3), bp, None, cs)
    return (None,) * rank


def seq_sharded(cfg, mesh) -> bool:
    """The reference splits this config's KV cache over its sequence on
    ``mesh`` (its perf runner's rule): its KV heads (``kv_replicate_to``
    where set) do not divide the ``model`` axis."""
    kv = getattr(cfg, "kv_replicate_to", 0) or cfg.kv_heads
    return bool(kv and kv % axis_sizes(mesh)["model"] != 0)


def cache_seq_axes(cfg, mesh, batch: int, seq_shard: bool):
    """The mesh axes over which ``cache_spec`` splits a KV cache of
    ``batch`` rows along its sequence: ``"model"``, or ``("data",
    "model")`` where the batch does not divide the dp axes; None without
    ``seq_shard``."""
    if not seq_shard:
        return None
    return cache_spec(cfg, mesh, "k", (batch, 1, 1, 1), True)[1]


def make_cache_shardings(cfg, cache, mesh, seq_shard: bool = False):
    """Shardings of a cache tree's tensors (its host-int ``index``
    entries, which the port keeps outside tensors, map to None)."""
    return map_with_path(
        lambda path, leaf: Sharding(mesh, cache_spec(
            cfg, mesh, path, tuple(leaf.shape), seq_shard))
        if torch.is_tensor(leaf) else None, cache)


# ---------------------------------------------------------------------------
# a spec on a mesh
# ---------------------------------------------------------------------------

def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


class Sharding:
    """A spec on a mesh (a ``DeviceMesh``, or a ``MeshShape`` for the
    slices alone): the counterpart of ``NamedSharding``."""

    def __init__(self, mesh, spec: Spec):
        self.mesh = mesh
        self.spec = tuple(spec)
        names = set(axis_names(mesh))
        for entry in self.spec:
            for a in _entry_axes(entry):
                if a not in names:
                    raise ValueError(f"spec {self.spec} names axis {a!r}, "
                                     f"not in the mesh {sorted(names)}")

    def __repr__(self):
        return f"Sharding({self.spec})"

    @property
    def replicated(self) -> bool:
        return all(not _entry_axes(e) for e in self.spec)

    def names(self, axis: str) -> bool:
        """The spec splits some dimension over ``axis``."""
        return any(axis in _entry_axes(e) for e in self.spec)

    def slices(self, shape, coord: Dict[str, int]) -> tuple:
        """The slice of a global leaf of ``shape`` that the mesh
        coordinate ``coord`` ({axis: index}) holds; raises where an axis
        does not divide its dimension."""
        shape = tuple(shape)
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more entries than "
                             f"shape {shape} has dimensions")
        sizes = axis_sizes(self.mesh)
        out = []
        for dim, n in enumerate(shape):
            axes = _entry_axes(self.spec[dim]) if dim < len(self.spec) else ()
            parts = math.prod(sizes[a] for a in axes)
            if n % parts:
                raise ValueError(f"dimension {dim} of {shape} does not split "
                                 f"evenly over {axes} ({parts} parts)")
            idx = 0
            for a in axes:
                idx = idx * sizes[a] + coord[a]
            step = n // parts
            out.append(slice(idx * step, (idx + 1) * step))
        return tuple(out)

    def local_slices(self, shape) -> tuple:
        """This process's slice of a global leaf of ``shape``."""
        return self.slices(shape, coordinate(self.mesh))

    def without(self, axes) -> "Sharding":
        """This spec with the mesh ``axes`` dropped: the form of a leaf
        gathered over every other axis (``gather(local, keep=axes)``),
        whose own slices ``shard(full, keep=axes)`` leaves alone.  An
        axis may be dropped only where it names a dimension alone."""
        axes = tuple(axes)
        out = []
        for entry in self.spec:
            names = _entry_axes(entry)
            if any(a in axes for a in names) and len(names) > 1:
                raise ValueError(f"spec {self.spec}: cannot keep {axes} of "
                                 f"a dimension split over {names}")
            out.append(None if names and names[0] in axes else entry)
        return Sharding(self.mesh, tuple(out))

    def local_shape(self, shape) -> tuple:
        """The shape of this process's shard of a global leaf."""
        return tuple(s.stop - s.start for s in self.local_slices(shape))

    def shard(self, full: torch.Tensor, keep=()) -> torch.Tensor:
        """This process's shard of a global tensor: a copy in storage of
        its own (a view would keep the whole leaf alive), or ``full``
        itself where the shard is the whole leaf.  ``keep``: mesh axes
        along which ``full`` is this rank's shard already (a leaf that
        ``gather(..., keep=)`` left split): it is sliced along the
        others only."""
        if keep:
            return self.without(keep).shard(full)
        if self.replicated:
            return full
        part = full[self.local_slices(full.shape)]
        if part.shape == full.shape:
            return full
        return part.clone(memory_format=torch.contiguous_format)

    def gather(self, local: torch.Tensor, keep=()) -> torch.Tensor:
        """The global tensor from the shards of the ranks that share this
        rank's replica: for each dimension, an all-gather over the group
        of each mesh axis its spec names (the minor axis first), the
        parts joined along the dimension (a collective: every rank
        calls it).  Axes of size 1 move nothing; a replicated leaf is
        returned as it is.  ``keep``: mesh axes not gathered, along
        which the result stays this rank's shard (the tensor-parallel
        split keeps ``model``)."""
        if keep:
            return self.without(keep).gather(local)
        if self.replicated:
            return local
        sizes = axis_sizes(self.mesh)
        full = local
        for dim, entry in enumerate(self.spec):
            for a in reversed(_entry_axes(entry)):
                if sizes[a] == 1:
                    continue
                part = full.contiguous()
                parts = [torch.empty_like(part) for _ in range(sizes[a])]
                dist.all_gather(parts, part, group=self.mesh.get_group(a))
                full = torch.cat(parts, dim=dim)
        return full
