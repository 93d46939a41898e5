"""Row-stationary (RS) dataflow cost model (port of ``repro.core.dataflow``).

Analytical model of the spatial-array accelerator running one conv/GEMM
layer under Eyeriss's row-stationary dataflow: compute cycles, per-level
access counts, energy and latency.  Where the reference vmaps a scalar
function over layers and then over design points, ``layer_cost`` here is
written once as broadcast tensor math: configs shaped (lanes, 1) against
layers shaped (1, L) give (lanes, L) per-layer costs in one pass.

Every ``torch.where`` keeps the reference's guarded form: the false
branch is the legacy expression, so neutral IR fields and mapping code 0
price exactly as the paper's model.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import energy as E
from repro_torch.core import pe as PE
from repro_torch.core.arch import AcceleratorConfig
from repro_torch.core.workloads import KIND_ATTN_KV, KIND_MOE_EXPERT, LayerSpec


class LayerCost(NamedTuple):
    macs: torch.Tensor
    cycles_compute: torch.Tensor
    cycles_memory: torch.Tensor
    cycles: torch.Tensor            # max(compute, memory) — double buffered
    utilization: torch.Tensor       # spatial PE utilization in [0, 1]
    dram_bits: torch.Tensor
    gbuf_bits: torch.Tensor
    noc_bits: torch.Tensor
    rf_bits: torch.Tensor
    energy_pj: torch.Tensor         # total layer energy (incl. DRAM)
    energy_mac_pj: torch.Tensor
    energy_mem_pj: torch.Tensor     # on-chip memory (RF + NoC + gbuf)
    energy_dram_pj: torch.Tensor    # off-chip DRAM (not visible to synthesis)


def _clip(x, lo, hi):
    """``jnp.clip``: min(max(x, lo), hi), each bound a tensor or a number."""
    x = torch.maximum(x, lo) if torch.is_tensor(lo) else torch.clamp_min(x, lo)
    return torch.minimum(x, hi) if torch.is_tensor(hi) else torch.clamp_max(x, hi)


def _ceil_div(a, b):
    return torch.ceil(a / torch.clamp_min(b, 1.0))


def _mapping_knobs(mapping):
    """Decompose a mapping code in [0, MAPPING_CHOICES) into the schedule
    knobs: (legacy, fil_frac, cols_first, c_div, q_div).

    Mixed radix 3 x 2 x 4 x 5 = 120 codes; code 0 is the legacy schedule
    (0.5 gbuf split, rows-first replication, tile divisors 1).
    """
    m = mapping.to(torch.float32)
    split_code = torch.remainder(m, 3.0)               # 0 -> 0.5 (legacy)
    fil_frac = torch.where(split_code == 1.0, 0.75,
                           torch.where(split_code == 2.0, 0.25, 0.5))
    cols_first = torch.remainder(torch.floor(m / 3.0), 2.0) == 1.0
    c_div = torch.exp2(torch.remainder(torch.floor(m / 6.0), 4.0))  # 1,2,4,8
    q_code = torch.remainder(torch.floor(m / 24.0), 5.0)
    q_div = torch.where(q_code == 4.0, 6.0, q_code + 1.0)  # 1, 2, 3, 4, 6
    return m == 0.0, fil_frac, cols_first, c_div, q_div


def layer_cost(layer: LayerSpec, cfg: AcceleratorConfig,
               clock_ghz: torch.Tensor) -> LayerCost:
    """Cost of layers on design points at the given clocks.

    Shapes broadcast: (lanes, 1) config fields and clock against (1, L)
    layer fields give (lanes, L) costs.  Per-operand second-operand
    streams: resident weights (conv/gemm) replay through the gbuf;
    streamed KV (``attn_kv``) is read once per batch element at
    activation width; gated expert weights (``moe_expert``) divide weight
    traffic by ``active_frac``.
    """
    H, W, C, K = layer.H, layer.W, layer.C, layer.K
    R, S, stride, batch = layer.R, layer.S, layer.stride, layer.batch
    count = layer.count
    streamed = layer.kind == float(KIND_ATTN_KV)
    gated = layer.kind == float(KIND_MOE_EXPERT)
    active_frac = torch.clamp_min(layer.active_frac, 1e-9)
    Eh = torch.floor((H - R) / stride) + 1.0
    F = torch.floor((W - S) / stride) + 1.0
    macs = batch * K * C * R * S * Eh * F * count

    a_bits = PE.act_bits(cfg.pe_type)
    w_bits = PE.weight_bits(cfg.pe_type)
    p_bits = PE.psum_bits(cfg.pe_type)
    op2_bits = torch.where(streamed, a_bits, w_bits)

    mapping = torch.as_tensor(cfg.mapping, device=cfg.pe_rows.device)
    legacy, fil_frac, cols_first, c_div, q_div = _mapping_knobs(mapping)

    # ---- per-PE tiling limited by scratchpad capacities ----------------
    c_fit = torch.where(
        legacy, _clip(torch.floor(cfg.spad_ifmap / S), 1.0, C),
        _clip(torch.floor(cfg.spad_ifmap / (S * c_div)), 1.0, C))
    q_cap = torch.floor(cfg.spad_filter / (c_fit * S))
    q_fit = torch.where(
        legacy, _clip(torch.minimum(q_cap, cfg.spad_psum), 1.0, K),
        _clip(torch.minimum(torch.floor(q_cap / q_div), cfg.spad_psum),
              1.0, K))

    # ---- spatial mapping: logical R x E grid onto pe_rows x pe_cols ----
    Pr, Pc = cfg.pe_rows, cfg.pe_cols
    rows_used = torch.minimum(R, Pr)
    cols_used = torch.minimum(Eh, Pc)
    fold_r = _ceil_div(R, Pr)
    fold_e = _ceil_div(Eh, Pc)
    groups = _ceil_div(K, q_fit) * _ceil_div(C, c_fit) * batch
    repl_r_cap = torch.floor(Pr / torch.clamp_min(rows_used, 1.0))
    repl_c_cap = torch.floor(Pc / torch.clamp_min(cols_used, 1.0))
    repl_r_first = _clip(repl_r_cap, 1.0, groups)
    repl_c_rest = _clip(repl_c_cap, 1.0,
                        torch.clamp_min(groups / repl_r_first, 1.0))
    repl_c_first = _clip(repl_c_cap, 1.0, groups)
    repl_r_rest = _clip(repl_r_cap, 1.0,
                        torch.clamp_min(groups / repl_c_first, 1.0))
    use_cols = torch.logical_and(torch.logical_not(legacy), cols_first)
    repl_r = torch.where(use_cols, repl_r_rest, repl_r_first)
    repl_c = torch.where(use_cols, repl_c_first, repl_c_rest)
    util = (rows_used * repl_r / (fold_r * Pr)) * \
           (cols_used * repl_c / (fold_e * Pc))
    util = _clip(util, 1e-3, 1.0)

    active_pes = util * Pr * Pc
    cycles_compute = macs / active_pes  # 1 MAC-equiv per PE per cycle

    # ---- data volumes (words) ------------------------------------------
    if_words = batch * C * H * W
    fil_words = K * C * R * S
    of_words = batch * K * Eh * F

    # ---- DRAM traffic with gbuf-capacity replay factors -----------------
    gbuf_bits_cap = cfg.gbuf_kb * 1024.0 * 8.0
    k_fit_gbuf = torch.where(
        legacy,
        _clip(torch.floor(0.5 * gbuf_bits_cap /
                          torch.clamp_min(C * R * S * w_bits, 1.0)), 1.0, K),
        _clip(torch.floor(fil_frac * gbuf_bits_cap /
                          torch.clamp_min(C * R * S * w_bits, 1.0)), 1.0, K))
    replay_if = _ceil_div(K, k_fit_gbuf)
    n_if_fit = torch.where(
        legacy,
        _clip(torch.floor(0.5 * gbuf_bits_cap /
                          torch.clamp_min(C * H * W * a_bits, 1.0)), 1.0, batch),
        _clip(torch.floor((1.0 - fil_frac) * gbuf_bits_cap /
                          torch.clamp_min(C * H * W * a_bits, 1.0)), 1.0, batch))
    replay_fil = _ceil_div(batch, n_if_fit)
    fil_dram_bits = torch.where(
        streamed, layer.stream_words * a_bits * batch,
        torch.where(gated, fil_words * w_bits / active_frac,
                    fil_words * w_bits * replay_fil))
    dram_bits = (if_words * a_bits * replay_if
                 + fil_dram_bits
                 + of_words * a_bits) * count

    # ---- gbuf traffic ----------------------------------------------------
    if_gbuf_reads = if_words * _ceil_div(K, q_fit * repl_r)
    fil_gbuf_reads = torch.where(
        streamed, layer.stream_words * batch,
        torch.where(gated, fil_words * fold_e * batch / active_frac,
                    fil_words * fold_e * batch))
    psum_spill = 2.0 * of_words * torch.clamp_min(_ceil_div(C, c_fit) - 1.0,
                                                  0.0)
    gbuf_bits = (if_gbuf_reads * a_bits + fil_gbuf_reads * op2_bits
                 + psum_spill * p_bits + of_words * a_bits) * count

    # ---- NoC + RF traffic ------------------------------------------------
    noc_bits = (if_gbuf_reads * a_bits + fil_gbuf_reads * op2_bits
                + psum_spill * p_bits) * count
    psum_rf_accesses = 2.0 * macs / torch.clamp_min(S * c_fit, 1.0)
    rf_bits = macs * (a_bits + op2_bits) + psum_rf_accesses * p_bits

    # ---- memory-bound cycles ----------------------------------------------
    bytes_per_cycle = cfg.bandwidth_gbps / torch.clamp_min(clock_ghz, 1e-6)
    cycles_memory = (dram_bits / 8.0) / torch.clamp_min(bytes_per_cycle, 1e-6)
    cycles_compute = cycles_compute * torch.where(streamed, 1.0, count)
    cycles = torch.maximum(cycles_compute, cycles_memory)

    # ---- energy ------------------------------------------------------------
    e_mac = macs * PE.mac_energy_pj(cfg.pe_type) \
        + cycles * active_pes * PE.PE_CTRL_ENERGY_PJ
    e_rf = (macs * E.rf_access_energy(a_bits, cfg.spad_ifmap * a_bits)
            + macs * E.rf_access_energy(op2_bits, cfg.spad_filter * op2_bits)
            + psum_rf_accesses * E.rf_access_energy(
                p_bits, cfg.spad_psum * p_bits))
    e_mem = (e_rf
             + noc_bits * E.NOC_E_PER_BIT_PJ
             + gbuf_bits * E.gbuf_energy_per_bit(cfg.gbuf_kb))
    e_dram = dram_bits * E.DRAM_E_PER_BIT_PJ
    return LayerCost(
        macs=macs, cycles_compute=cycles_compute, cycles_memory=cycles_memory,
        cycles=cycles, utilization=util, dram_bits=dram_bits,
        gbuf_bits=gbuf_bits, noc_bits=noc_bits, rf_bits=rf_bits,
        energy_pj=e_mac + e_mem + e_dram, energy_mac_pj=e_mac,
        energy_mem_pj=e_mem, energy_dram_pj=e_dram)


def _layer_fold(x: torch.Tensor) -> torch.Tensor:
    """Strictly sequential left fold over the LAST (layer) axis.

    ``torch.sum`` would pick its own association; the fold always adds
    layers in stack order, so trailing zero (padding) layers leave the
    valid prefix's sum exactly as it was.
    """
    acc = x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def reduce_layer_costs(per_layer: LayerCost, counts: torch.Tensor) -> LayerCost:
    """Mask ``count == 0`` layers to exact 0.0 and fold the layer axis.

    All 13 fields, plus utilization x MACs for the MAC-weighted mean
    utilization, are stacked and folded together: the fold is elementwise
    per field, so one stacked fold adds the same values in the same
    order as 14 separate folds, with 14x fewer launches.
    """
    valid = counts > 0.0
    fields = torch.broadcast_tensors(*per_layer,
                                     per_layer.utilization * per_layer.macs)
    folded = _layer_fold(torch.where(valid, torch.stack(fields), 0.0))
    summed = LayerCost(*folded[:-1])
    util = folded[-1] / torch.clamp_min(summed.macs, 1.0)
    # rebuild the total from the folded components at a fixed association
    return summed._replace(
        utilization=util,
        energy_pj=(summed.energy_mac_pj + summed.energy_mem_pj
                   + summed.energy_dram_pj))


def network_cost(layers: LayerSpec, cfg: AcceleratorConfig,
                 clock_ghz: torch.Tensor) -> LayerCost:
    """Summed cost of a layer stack on each design point.

    Config fields and ``clock_ghz`` are 0-d or (lanes,); layer fields are
    (L,).  Returns per-lane sums (0-d for a single design point).
    """
    lane = lambda x: torch.as_tensor(x).unsqueeze(-1)  # noqa: E731
    per_layer = layer_cost(layers, AcceleratorConfig(*map(lane, cfg)),
                           lane(clock_ghz))
    return reduce_layer_costs(per_layer, layers.count)
