"""Design-space exploration + Pareto analysis (port of ``repro.core.dse``,
the non-streaming part; the paper's Sec. IV).

Every design point of a batched config is priced against a workload:
the cost-model backend's PPA stage gives each lane its clock and area,
the dataflow fold sums the per-layer row-stationary costs at that clock,
and ``_finish`` derives the paper's metrics (perf/area, energy per
inference) on the host in float64.  Both device stages are eager torch
on the device of the config.

Batches are processed in fixed-shape chunks (the trailing partial chunk
repeats its last point up to the chunk shape), as in the reference; every
per-lane computation is elementwise, so a lane's result does not depend
on the chunk it was evaluated in.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.arch import AcceleratorConfig, PE_INT16, PE_TYPE_NAMES
from repro_torch.core.costmodel import CostModel, as_cost_model
from repro_torch.core.dataflow import LayerCost, layer_cost, reduce_layer_costs
from repro_torch.core.ppa import PPAModels
from repro_torch.core.synth import LEAKAGE_MW_PER_MM2
from repro_torch.core.workloads import LayerSpec, Workload
from repro_torch.device import host

# Default number of design points evaluated per chunk.
DEFAULT_CHUNK_SIZE = 4096

# Host dtype of every DseResult column: the derived metrics are computed
# on the host in float64 from the device sums (macs overflows float32's
# mantissa for ImageNet-scale networks).
RESULT_DTYPES = dict.fromkeys((
    "latency_s", "energy_j", "energy_total_j", "area_mm2", "power_mw",
    "clock_ghz", "perf", "perf_per_area", "utilization", "macs"), np.float64)


class DseResult(NamedTuple):
    """Struct-of-arrays over N design points for one workload (host
    float64 numpy columns)."""
    latency_s: np.ndarray
    energy_j: np.ndarray         # chip energy: MAC + on-chip mem + leakage*T
    energy_total_j: np.ndarray   # chip + DRAM (beyond-paper reporting)
    area_mm2: np.ndarray
    power_mw: np.ndarray
    clock_ghz: np.ndarray
    perf: np.ndarray             # inferences / s
    perf_per_area: np.ndarray    # inferences / s / mm^2
    utilization: np.ndarray
    macs: np.ndarray


def _ppa_stage(ppa_fn, params, cfg: AcceleratorConfig):
    """The PPA stage: the backend's (power, clock, area) plus leakage from
    area at the shared 45 nm density."""
    power_mw, clock_ghz, area_mm2 = ppa_fn(params, cfg)
    return power_mw, clock_ghz, area_mm2, LEAKAGE_MW_PER_MM2 * area_mm2


def _network_sums(cfg: AcceleratorConfig, clock_ghz: torch.Tensor,
                  layers: LayerSpec) -> LayerCost:
    """Summed network cost per design-point lane: (lanes, 1) configs
    against (1, L) layers, then the masked sequential layer fold."""
    lanes = AcceleratorConfig(*[f[:, None] for f in cfg])
    per_layer = layer_cost(LayerSpec(*[f[None, :] for f in layers]),
                           lanes, clock_ghz[:, None])
    return reduce_layer_costs(per_layer, layers.count)


def _network_stage(cfg: AcceleratorConfig, clock_ghz, workload: Workload):
    """The dataflow stage of one chunk."""
    return _network_sums(cfg, clock_ghz, workload.layers)


def _finish(cost, clock_ghz, area_mm2, leak_mw) -> DseResult:
    """Network cost sums -> DSE metric columns, on HOST in float64."""
    f64 = lambda x: host(x).astype(np.float64)  # noqa: E731
    cycles, util, macs = f64(cost.cycles), f64(cost.utilization), f64(cost.macs)
    e_mac, e_mem = f64(cost.energy_mac_pj), f64(cost.energy_mem_pj)
    e_dram = f64(cost.energy_dram_pj)
    clock_ghz, area_mm2 = f64(clock_ghz), f64(area_mm2)
    latency_s = cycles / (clock_ghz * 1e9)
    # chip energy = dynamic access-count energy + leakage x runtime; DRAM
    # energy is invisible to a synthesis flow and reported separately
    e_chip = (e_mac + e_mem) * 1e-12 + f64(leak_mw) * 1e-3 * latency_s
    perf = 1.0 / np.maximum(latency_s, 1e-12)
    return DseResult(
        latency_s=latency_s, energy_j=e_chip,
        energy_total_j=e_chip + e_dram * 1e-12,
        area_mm2=area_mm2,
        power_mw=e_chip / np.maximum(latency_s, 1e-12) * 1e3,
        clock_ghz=clock_ghz, perf=perf,
        perf_per_area=perf / np.maximum(area_mm2, 1e-9),
        utilization=util, macs=macs)


class PendingChunk(NamedTuple):
    """A dispatched chunk: device tensors queued on the current stream,
    not yet copied to the host.  ``finish_chunk`` waits for them."""
    cost: object                 # dataflow LayerCost sums (device tensors)
    clock: object
    area: object
    leak: object
    n: int                       # real (unpadded) lane count


def _pad_config(cfg: AcceleratorConfig, pad: int) -> AcceleratorConfig:
    """Repeat the last design point ``pad`` times (the fixed chunk shape);
    padded lanes are sliced off after evaluation."""
    return AcceleratorConfig(*[
        torch.cat([f, f[-1:].expand((pad,) + tuple(f.shape[1:]))])
        for f in cfg])


def _slice_config(cfg: AcceleratorConfig, lo: int, hi: int) -> AcceleratorConfig:
    return AcceleratorConfig(*[f[lo:hi] for f in cfg])


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def evaluate_chunk(cfg: AcceleratorConfig, workload: Workload,
                   surrogate: PPAModels | CostModel | str | None = None,
                   pad_to: int | None = None) -> DseResult:
    """Evaluate one batch (padded up to ``pad_to`` lanes) and return the
    host result; ``surrogate`` selects the cost-model backend
    (``None`` = the synthesis oracle)."""
    return finish_chunk(dispatch_chunk(cfg, workload, surrogate,
                                       pad_to=pad_to))


def dispatch_chunk(cfg: AcceleratorConfig, workload: Workload,
                   surrogate: PPAModels | CostModel | str | None = None,
                   pad_to: int | None = None) -> PendingChunk:
    """Validate, pad and queue both stages of one chunk; returns before
    the device has finished."""
    model = as_cost_model(surrogate)
    model.validate(cfg)
    cfg = AcceleratorConfig(*[torch.as_tensor(f, device=cfg.pe_rows.device)
                              for f in cfg])
    if cfg.pe_rows.ndim == 0:  # single unbatched point: lift to (1,)
        cfg = AcceleratorConfig(*[f.reshape(1) for f in cfg])
    n = int(cfg.pe_rows.shape[0])
    if n == 0:
        return PendingChunk(None, None, None, None, 0)
    if pad_to is not None and n < pad_to:
        cfg = _pad_config(cfg, pad_to - n)
    power, clock, area, leak = _ppa_stage(model.ppa_fn, model.ppa_params, cfg)
    del power  # nominal-activity power; the result's power column is
    #            derived from chip energy over runtime in _finish
    cost = _network_stage(cfg, clock, workload)
    return PendingChunk(cost, clock, area, leak, n)


def finish_chunk(pending: PendingChunk) -> DseResult:
    """Copy a dispatched chunk's sums to the host in one transfer and
    derive the float64 columns."""
    if pending.n == 0:
        return _empty_result()
    rows = torch.stack([*pending.cost, pending.clock, pending.area,
                        pending.leak])[:, :pending.n]
    rows = host(rows)
    k = len(LayerCost._fields)
    res = _finish(LayerCost(*rows[:k]), *rows[k:])
    return DseResult(*[np.asarray(col, RESULT_DTYPES[f])
                       for f, col in zip(DseResult._fields, res)])


def _empty_result() -> DseResult:
    """Zero-point DseResult with the documented per-column host dtypes."""
    return DseResult(*[np.empty((0,), RESULT_DTYPES[f])
                       for f in DseResult._fields])


def evaluate_space(cfg: AcceleratorConfig, workload: Workload,
                   surrogate: PPAModels | CostModel | str | None = None,
                   chunk_size: int | None = None) -> DseResult:
    """Evaluate a batched design space on one workload.

    With ``chunk_size`` set, the batch runs in chunks of that many lanes
    and the host columns are concatenated, so device memory stays
    O(chunk_size).  A batch that fits one chunk is padded to the next
    power of two (capped at the chunk size), as in the reference.
    """
    n = int(np.shape(cfg.pe_rows)[0]) if np.ndim(cfg.pe_rows) else 1
    if n == 0:
        return _empty_result()
    if chunk_size is None or n <= chunk_size:
        pad = _next_pow2(n) if chunk_size is None \
            else min(chunk_size, _next_pow2(n))
        return evaluate_chunk(cfg, workload, surrogate, pad_to=pad)
    cols: list[list[np.ndarray]] = [[] for _ in DseResult._fields]
    for lo in range(0, n, chunk_size):
        res = evaluate_chunk(_slice_config(cfg, lo, min(lo + chunk_size, n)),
                             workload, surrogate, pad_to=chunk_size)
        for acc, col in zip(cols, res):
            acc.append(col)
    return DseResult(*[np.concatenate(c) for c in cols])


# ---------------------------------------------------------------------------
# Pareto analysis
# ---------------------------------------------------------------------------

def pareto_mask_dense(objectives: torch.Tensor) -> torch.Tensor:
    """Non-dominated mask, O(N^2) broadcast: the reference oracle.

    objectives: (N, D), all HIGHER-IS-BETTER.  Point i is dominated iff
    some j is >= on every objective and > on at least one.
    """
    a = objectives[:, None, :]   # i
    b = objectives[None, :, :]   # j
    ge = torch.all(b >= a, dim=-1)
    gt = torch.any(b > a, dim=-1)
    return ~torch.any(ge & gt, dim=1)


def pareto_mask_tiled(objectives: torch.Tensor,
                      block_size: int = 1024) -> torch.Tensor:
    """Non-dominated mask with O(N * block_size) memory, any D: all N
    points against one block of candidate dominators at a time, OR-ed
    into the dominated accumulator.  Equal to ``pareto_mask_dense``."""
    obj = torch.as_tensor(objectives)
    n = obj.shape[0]
    dominated = torch.zeros(n, dtype=torch.bool, device=obj.device)
    for lo in range(0, n, block_size):
        blk = obj[lo:lo + block_size]
        ge = torch.all(blk[None, :, :] >= obj[:, None, :], dim=-1)
        gt = torch.any(blk[None, :, :] > obj[:, None, :], dim=-1)
        dominated |= torch.any(ge & gt, dim=1)
    return ~dominated


def pareto_mask_2d(objectives: np.ndarray) -> np.ndarray:
    """Sort-based O(N log N) non-dominated mask for 2 objectives, on the
    host in float64; equal points never dominate each other."""
    obj = host(objectives).astype(np.float64)
    n, d = obj.shape
    if d != 2:
        raise ValueError(f"pareto_mask_2d needs 2 objectives, got {d}")
    if n == 0:
        return np.zeros((0,), bool)
    x, y = obj[:, 0], obj[:, 1]
    order = np.lexsort((-y, -x))          # x desc, ties broken y desc
    xs, ys = x[order], y[order]
    new_group = np.r_[True, xs[1:] != xs[:-1]]
    group_id = np.cumsum(new_group) - 1
    group_max = np.maximum.reduceat(ys, np.flatnonzero(new_group))
    prev_max = np.r_[-np.inf, np.maximum.accumulate(group_max)[:-1]]
    dominated = (prev_max[group_id] >= ys) | (group_max[group_id] > ys)
    mask = np.empty(n, bool)
    mask[order] = ~dominated
    return mask


# N above which the dispatcher refuses the O(N^2) dense path.
_DENSE_LIMIT = 4096


def pareto_mask(objectives, method: str = "auto",
                block_size: int = 1024) -> torch.Tensor:
    """Non-dominated mask of (N, D) HIGHER-IS-BETTER objectives, on the
    device of ``objectives`` (the CPU for a numpy array).

    method: "auto" (sorted when D == 2, dense for small N, else tiled),
    "dense", "tiled" or "sorted" (2 objectives, host).  All agree exactly.
    """
    obj = torch.as_tensor(objectives)
    n, d = obj.shape
    if method == "auto":
        if d == 2:
            method = "sorted"
        elif n <= _DENSE_LIMIT:
            method = "dense"
        else:
            method = "tiled"
    if method == "dense":
        return pareto_mask_dense(obj)
    if method == "tiled":
        return pareto_mask_tiled(obj, block_size=block_size)
    if method == "sorted":
        return torch.as_tensor(pareto_mask_2d(obj), device=obj.device)
    raise ValueError(f"unknown pareto_mask method {method!r}")


def _objective_columns(result: DseResult, metrics: Sequence[str]) -> np.ndarray:
    """(N, D) higher-is-better objective matrix from DseResult fields;
    a ``neg_`` prefix flips a lower-is-better metric."""
    cols = []
    for m in metrics:
        if m.startswith("neg_"):
            cols.append(-np.asarray(getattr(result, m[4:]), np.float64))
        else:
            cols.append(np.asarray(getattr(result, m), np.float64))
    return np.stack(cols, axis=-1)


def pareto_front(result: DseResult,
                 metrics: tuple = ("perf_per_area", "neg_energy_j"),
                 method: str = "auto") -> torch.Tensor:
    return pareto_mask(_objective_columns(result, metrics), method=method)


# ---------------------------------------------------------------------------
# The paper's normalized reporting (Figs. 4-6)
# ---------------------------------------------------------------------------

def best_index(result: DseResult, pe_type, code: int | None,
               metric: str = "perf_per_area", mode: str = "max") -> int:
    """Index of the best design of a given PE type under a metric
    (``code=None`` ranks the whole space; a type absent from the space
    falls back to the global best)."""
    vals = np.asarray(getattr(result, metric), np.float64)
    if code is not None:
        sel = np.atleast_1d(host(pe_type)) == code
        if sel.any():
            vals = np.where(sel, vals, -np.inf if mode == "max" else np.inf)
    return int(np.argmax(vals) if mode == "max" else np.argmin(vals))


def normalized_report(result: DseResult, cfg: AcceleratorConfig) -> dict:
    """Per-PE-type best configs, normalized to the best-perf/area INT16
    design: the normalization of the paper's Figs. 4-6.  Without an INT16
    design the global best becomes the reference, recorded under
    ``"_reference"``."""
    types = np.atleast_1d(host(cfg.pe_type))
    has_int16 = bool((types == PE_INT16).any())
    ref = best_index(result, types, PE_INT16 if has_int16 else None,
                     "perf_per_area")
    ref_ppa = float(result.perf_per_area[ref])
    ref_energy = float(result.energy_j[ref])
    report = {"_reference": dict(
        pe_type=PE_TYPE_NAMES[int(types[ref])], index=ref,
        fallback=not has_int16,
        note=None if has_int16 else
        "no INT16 design in space; normalized to global best perf/area")}
    for code, name in enumerate(PE_TYPE_NAMES):
        if not (types == code).any():
            continue
        i_ppa = best_index(result, types, code, "perf_per_area")
        i_en = best_index(result, types, code, "energy_j", "min")
        report[name] = dict(
            best_perf_per_area=float(result.perf_per_area[i_ppa]),
            norm_perf_per_area=float(result.perf_per_area[i_ppa]) / ref_ppa,
            best_energy_j=float(result.energy_j[i_en]),
            norm_energy=float(result.energy_j[i_en]) / ref_energy,
            energy_at_best_ppa=float(result.energy_j[i_ppa]) / ref_energy,
            index_best_ppa=i_ppa, index_best_energy=i_en,
        )
    return report


def report_pe_types(report: dict) -> dict:
    """The per-PE-type entries of a normalized report (metadata dropped)."""
    return {k: v for k, v in report.items() if not k.startswith("_")}


def spread(result: DseResult) -> dict:
    """Fig. 2: how much perf/area and energy vary across the space."""
    ppa = np.asarray(result.perf_per_area, np.float64)
    en = np.asarray(result.energy_j, np.float64)
    return dict(perf_per_area_spread=float(ppa.max() / max(ppa.min(), 1e-30)),
                energy_spread=float(en.max() / max(en.min(), 1e-30)))
