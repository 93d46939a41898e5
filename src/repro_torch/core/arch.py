"""Accelerator configuration space (port of ``repro.core.arch``).

An Eyeriss-style spatial array: a grid of processing elements (PEs), a
global buffer, per-PE scratchpads, a PE type (bit precision) and a DRAM
bandwidth.  A batched ``AcceleratorConfig`` holds one (N,) tensor per
knob, so the whole cost model runs over N design points as plain
broadcast tensor math.

Flat space indices decode by mixed radix on the host, in float64 numpy
exactly as the reference does, so the same index gives the same config
in both packages; only the decoded columns are moved to the device.
"""

from __future__ import annotations

from typing import Iterable, Iterator, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.device import same_device, host, resolve_device

# PE type codes (index into the constant tables in pe.py).
PE_FP32 = 0
PE_INT16 = 1
PE_LIGHTPE1 = 2  # 8-bit activations, 4-bit (power-of-two) weights, 1 shift
PE_LIGHTPE2 = 3  # 8-bit activations, 8-bit weights, 2 shifts + add
PE_INT8 = 4      # conventional int8 MAC (beyond-paper comparison point)

PE_TYPE_NAMES = ("fp32", "int16", "lightpe1", "lightpe2", "int8")
PE_TYPE_CODES = {name: code for code, name in enumerate(PE_TYPE_NAMES)}


class AcceleratorConfig(NamedTuple):
    """One design point, or N of them: every field a 0-d or (N,) tensor.

    Knobs are float32 and ``pe_type`` is int32, as in the reference;
    table lookups index with ``pe_type.long()``.  ``mapping`` is the
    dataflow schedule code (0 = the legacy schedule), the trailing
    mixed-radix axis with a single-value default grid.
    """

    pe_rows: torch.Tensor
    pe_cols: torch.Tensor
    gbuf_kb: torch.Tensor
    spad_ifmap: torch.Tensor
    spad_filter: torch.Tensor
    spad_psum: torch.Tensor
    pe_type: torch.Tensor
    bandwidth_gbps: torch.Tensor
    mapping: torch.Tensor | float = 0.0

    @property
    def num_pes(self):
        return self.pe_rows * self.pe_cols


def _cols_to_config(cols: dict, device: torch.device) -> AcceleratorConfig:
    cfg = AcceleratorConfig(**{
        f: torch.as_tensor(np.asarray(cols[f]),
                           dtype=torch.int32 if f == "pe_type"
                           else torch.float32)
        for f in AcceleratorConfig._fields})
    return config_to(cfg, device)[0]


def config_to(cfg: AcceleratorConfig,
              device: torch.device) -> tuple[AcceleratorConfig, tuple]:
    """A batched config on ``device``.  From the CPU to a card the fields
    go through ONE pinned (fields, N) float32 buffer and one copy queued
    on the current stream, so the host does not wait for the stream
    (``pe_type`` codes are small integers: exact through float32).
    Returns ``(config, staged)``: keep ``staged`` alive until the stream
    has passed the copy."""
    src = torch.as_tensor(cfg.pe_rows).device
    if same_device(src, device):
        return AcceleratorConfig(*[torch.as_tensor(f, device=src)
                                   for f in cfg]), ()
    if torch.device(device).type != "cuda" or src.type != "cpu":
        return AcceleratorConfig(*[torch.as_tensor(f, device=src).to(device)
                                   for f in cfg]), ()
    shape = tuple(torch.as_tensor(cfg.pe_rows).shape)
    buf = torch.empty((len(cfg),) + shape, dtype=torch.float32,
                      pin_memory=True)
    for i, f in enumerate(cfg):
        buf[i] = torch.as_tensor(f)
    dev = buf.to(device, non_blocking=True)
    return AcceleratorConfig(*[
        dev[i].to(torch.int32) if name == "pe_type" else dev[i]
        for i, name in enumerate(AcceleratorConfig._fields)]), (buf,)


def make_config(
    pe_rows: int = 12,
    pe_cols: int = 14,
    gbuf_kb: float = 108.0,
    spad_ifmap: int = 12,
    spad_filter: int = 224,
    spad_psum: int = 24,
    pe_type: str | int = "int16",
    bandwidth_gbps: float = 25.6,
    mapping: float = 0.0,
    device: str | torch.device | None = None,
) -> AcceleratorConfig:
    """Build a single design point (defaults follow Eyeriss-like values)."""
    code = PE_TYPE_CODES[pe_type] if isinstance(pe_type, str) else int(pe_type)
    return _cols_to_config(dict(
        pe_rows=pe_rows, pe_cols=pe_cols, gbuf_kb=gbuf_kb,
        spad_ifmap=spad_ifmap, spad_filter=spad_filter, spad_psum=spad_psum,
        pe_type=code, bandwidth_gbps=bandwidth_gbps, mapping=mapping),
        resolve_device(device))


def stack_configs(configs: Sequence[AcceleratorConfig]) -> AcceleratorConfig:
    """Stack N single design points into one batched AcceleratorConfig."""
    return AcceleratorConfig(*[
        torch.stack([torch.as_tensor(getattr(c, f),
                                     device=c.pe_rows.device) for c in configs])
        for f in AcceleratorConfig._fields])


def concat_configs(configs: Sequence[AcceleratorConfig]) -> AcceleratorConfig:
    """Concatenate batched configs along the lane axis (field dtypes and
    the device kept): the survivor buffer of the two-stage pruned walk."""
    return AcceleratorConfig(*[
        torch.cat([torch.as_tensor(getattr(c, f)) for c in configs])
        for f in AcceleratorConfig._fields])


def take_config(cfg: AcceleratorConfig, rows) -> AcceleratorConfig:
    """Row-select a batched config by a slice, a boolean mask or an index
    array (numpy or tensor), on the config's device."""
    def take(f):
        f = torch.as_tensor(f)
        if isinstance(rows, slice):
            return f[rows]
        return f[torch.as_tensor(rows, device=f.device)]
    return AcceleratorConfig(*[take(f) for f in cfg])


# ---------------------------------------------------------------------------
# The paper's design space (Sec. III-C) and the wider grids.
# ---------------------------------------------------------------------------

DEFAULT_SPACE = dict(
    pe_rows=(8, 12, 16, 24, 32),
    pe_cols=(8, 14, 16, 28, 32),
    gbuf_kb=(54.0, 108.0, 216.0, 432.0),
    spad_ifmap=(12, 24),
    spad_filter=(112, 224, 448),
    spad_psum=(16, 24, 32),
    pe_type=tuple(range(len(PE_TYPE_NAMES))),
    bandwidth_gbps=(12.8, 25.6, 51.2),
)

# 16*16*12*4*6*6*5*5 = 11,059,200 configs, walked lazily in chunks.
WIDE_SPACE = dict(
    pe_rows=(4, 6, 8, 10, 12, 14, 16, 20, 24, 28, 32, 36, 40, 48, 56, 64),
    pe_cols=(4, 6, 8, 10, 12, 14, 16, 20, 24, 28, 32, 36, 40, 48, 56, 64),
    gbuf_kb=(27.0, 54.0, 81.0, 108.0, 162.0, 216.0, 324.0, 432.0, 648.0,
             864.0, 1296.0, 1728.0),
    spad_ifmap=(6, 12, 24, 48),
    spad_filter=(56, 112, 168, 224, 336, 448),
    spad_psum=(8, 16, 24, 32, 48, 64),
    pe_type=tuple(range(len(PE_TYPE_NAMES))),
    bandwidth_gbps=(6.4, 12.8, 25.6, 51.2, 102.4),
)

# 3 gbuf splits x 2 replication orders x 4 channel-tile divisors x
# 5 filter-tile divisors (decoded by dataflow._mapping_knobs).
MAPPING_CHOICES = 120

# DEFAULT_SPACE with the mapping axis opened: 27,000 x 120 points.
MAPPED_SPACE = dict(DEFAULT_SPACE,
                    mapping=tuple(float(i) for i in range(MAPPING_CHOICES)))


def _space_axes(space: dict | None) -> list[np.ndarray]:
    """Per-field value axes in AcceleratorConfig field order; a space
    without ``mapping`` gets the single-value legacy axis ``(0.0,)``."""
    space = dict(DEFAULT_SPACE if space is None else space)
    space.setdefault("mapping", (0.0,))
    return [np.asarray(space[k], np.float64)
            for k in AcceleratorConfig._fields]


def space_radices(space: dict | None = None) -> np.ndarray:
    """Per-field axis lengths: the mixed-radix digit bases of ``space_points``."""
    return np.array([len(a) for a in _space_axes(space)], np.int64)


def space_size(space: dict | None = None) -> int:
    """Number of points in the cartesian design space (no materialization)."""
    return int(np.prod([len(a) for a in _space_axes(space)]))


def subsample_indices(n: int, max_points: int | None,
                      seed: int = 0) -> np.ndarray | None:
    """Sorted unique flat indices of a uniform subsample, or ``None`` for
    the full walk.  numpy's ``default_rng`` draw of the reference, so the
    same ``(n, max_points, seed)`` gives the same point set in both
    packages."""
    if max_points is None or n <= max_points:
        return None
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(n, size=max_points, replace=False))


def space_points(indices: np.ndarray, space: dict | None = None,
                 device: str | torch.device | None = None) -> AcceleratorConfig:
    """Decode flat space indices into a batched config via mixed radix.

    Index order matches ``itertools.product`` over the fields (last axis
    fastest).  The decode runs on the host; the columns go to ``device``.
    """
    device = resolve_device(device)
    axes = _space_axes(space)
    idx = np.asarray(indices, np.int64)
    radices = np.array([len(a) for a in axes], np.int64)
    strides = np.concatenate([np.cumprod(radices[::-1])[::-1][1:], [1]])
    cols = {k: axes[i][(idx // strides[i]) % radices[i]]
            for i, k in enumerate(AcceleratorConfig._fields)}
    return _cols_to_config(cols, device)


def iter_space_chunks(space: dict | None = None,
                      chunk_size: int = 4096,
                      max_points: int | None = None,
                      seed: int = 0,
                      start_chunk: int = 0,
                      device: str | torch.device | None = None) -> Iterator[
                          tuple[AcceleratorConfig, np.ndarray]]:
    """Lazily yield ``(config_chunk, flat_indices)`` over the space, with
    the same chunk boundaries and subsample as the reference."""
    device = resolve_device(device)
    n = space_size(space)
    keep = subsample_indices(n, max_points, seed)
    if keep is not None:
        for lo in range(start_chunk * chunk_size, len(keep), chunk_size):
            idx = keep[lo:lo + chunk_size]
            yield space_points(idx, space, device), idx
        return
    for lo in range(start_chunk * chunk_size, n, chunk_size):
        idx = np.arange(lo, min(lo + chunk_size, n), dtype=np.int64)
        yield space_points(idx, space, device), idx


def enumerate_space(space: dict | None = None,
                    max_points: int | None = None,
                    seed: int = 0,
                    device: str | torch.device | None = None) -> AcceleratorConfig:
    """Enumerate (or subsample) the design space as one batched config."""
    device = resolve_device(device)
    n = space_size(space)
    idx = subsample_indices(n, max_points, seed)
    if idx is None:
        idx = np.arange(n, dtype=np.int64)
    return space_points(idx, space, device)


# ---------------------------------------------------------------------------
# The joint (model x accelerator) space: the co-exploration axis.
#
# The model is one more mixed-radix digit, the SLOWEST one: joint flat
# index = model_id * space_size(space) + accelerator_index.  The decode
# stays host int64 numpy, index for index the reference's; only the
# decoded config columns go to the device.
# ---------------------------------------------------------------------------

def joint_space_size(space: dict | None = None, num_models: int = 1) -> int:
    """Number of (model, accelerator-config) points in the joint space."""
    if num_models < 1:
        raise ValueError(f"num_models must be >= 1, got {num_models}")
    return num_models * space_size(space)


def joint_space_points(
        indices: np.ndarray, space: dict | None = None,
        num_models: int = 1,
        device: str | torch.device | None = None,
) -> tuple[np.ndarray, AcceleratorConfig]:
    """Decode flat joint indices into (host model ids, batched config):
    ``model_id = idx // A`` and ``space_points(idx % A)``."""
    a = space_size(space)
    idx = np.asarray(indices, np.int64)
    if idx.size and (idx.min() < 0 or idx.max() >= num_models * a):
        raise ValueError(
            f"joint index out of range for {num_models} models x {a} configs")
    return idx // a, space_points(idx % a, space, device)


def _validate_model_groups(model_groups, num_models: int) -> tuple:
    groups = tuple(tuple(int(m) for m in g) for g in model_groups)
    flat = [m for g in groups for m in g]
    if any(m < 0 or m >= num_models for m in flat):
        raise ValueError(f"model_groups reference models outside "
                         f"[0, {num_models}): {groups}")
    if len(flat) != len(set(flat)):
        raise ValueError(f"model_groups assign a model twice: {groups}")
    return groups


def iter_joint_space_chunks(
        space: dict | None = None,
        num_models: int = 1,
        chunk_size: int = 4096,
        max_points: int | None = None,
        seed: int = 0,
        group_by_model: bool = False,
        model_groups: Sequence[Sequence[int]] | None = None,
        start_chunk: int = 0,
        device: str | torch.device | None = None,
) -> Iterator[tuple[int | np.ndarray, AcceleratorConfig, np.ndarray]]:
    """Lazily yield ``(model_ids, config_chunk, flat_joint_indices)``.

    The default (mixed) walk yields dense chunks that cross model
    boundaries, ``model_ids`` an int64 array aligned with the lanes;
    ``model_groups`` (disjoint tuples of model ids, walked in order)
    restricts mixing to within each group.  ``group_by_model=True`` yields
    a scalar model id a chunk and never mixes.  ``max_points`` subsamples
    the JOINT space with the same RNG stream in both walks, so they visit
    the same points; ``start_chunk`` skips the first chunks by index
    arithmetic.  Chunk boundaries and indices are the reference's.
    """
    device = resolve_device(device)
    a = space_size(space)
    n = joint_space_size(space, num_models)
    keep = subsample_indices(n, max_points, seed)
    skip = int(start_chunk)
    if group_by_model:
        for m in range(num_models):
            if keep is None:
                midx = np.arange(m * a, (m + 1) * a, dtype=np.int64)
            else:
                midx = keep[(keep >= m * a) & (keep < (m + 1) * a)]
            n_chunks = -(-len(midx) // chunk_size)
            if skip >= n_chunks:
                skip -= n_chunks
                continue
            for lo in range(skip * chunk_size, len(midx), chunk_size):
                idx = midx[lo:lo + chunk_size]
                yield m, space_points(idx - m * a, space, device), idx
            skip = 0
        return
    if model_groups is None:
        groups = (tuple(range(num_models)),)
    else:
        groups = _validate_model_groups(model_groups, num_models)
    for group in groups:
        g = np.asarray(group, np.int64)
        if keep is None:
            # lazy decode of the group's local enumeration:
            # local index l -> (model g[l // a], accel l % a)
            g_n = len(g) * a
            n_chunks = -(-g_n // chunk_size)
            if skip >= n_chunks:
                skip -= n_chunks
                continue
            for lo in range(skip * chunk_size, g_n, chunk_size):
                loc = np.arange(lo, min(lo + chunk_size, g_n), dtype=np.int64)
                mids = g[loc // a]
                yield (mids, space_points(loc % a, space, device),
                       mids * a + loc % a)
            skip = 0
        else:
            gidx = keep[np.isin(keep // a, g)]
            n_chunks = -(-len(gidx) // chunk_size)
            if skip >= n_chunks:
                skip -= n_chunks
                continue
            for lo in range(skip * chunk_size, len(gidx), chunk_size):
                idx = gidx[lo:lo + chunk_size]
                yield idx // a, space_points(idx % a, space, device), idx
            skip = 0


def config_rows(cfg: AcceleratorConfig) -> Iterable[dict]:
    """Iterate a batched config as python dicts (for reports/CSV)."""
    arrs = {f: np.atleast_1d(host(getattr(cfg, f))) for f in cfg._fields}
    for i in range(len(arrs["pe_rows"])):
        row = {f: arrs[f][i].item() for f in cfg._fields}
        row["pe_type_name"] = PE_TYPE_NAMES[int(row["pe_type"])]
        yield row
