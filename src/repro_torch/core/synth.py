"""Synthesis oracle, the stand-in for Synopsys DC + FreePDK45 (port of
``repro.core.synth``).

An analytical area / timing / power model built from the 45 nm constants
in ``pe`` and ``energy``, with the second-order effects of a synthesis
run and a deterministic ~3% pseudo-noise term.  Every formula is
elementwise over the config fields, so a batched config of N points is
one pass of broadcast tensor math.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import energy as E
from repro_torch.core import pe as PE
from repro_torch.core.arch import AcceleratorConfig


class SynthResult(NamedTuple):
    area_mm2: torch.Tensor
    crit_path_ns: torch.Tensor
    clock_ghz: torch.Tensor
    power_mw: torch.Tensor          # at nominal (70%) MAC activity
    leakage_mw: torch.Tensor


_NOISE_AMP = 0.03

# 45 nm leakage power density (mW per mm^2 of synthesized area), shared
# with the surrogate backend so the two can only differ through the
# fitted power/clock/area polynomials.
LEAKAGE_MW_PER_MM2 = 3.5


def _noise(cfg: AcceleratorConfig, salt: float):
    """Deterministic ~3% 'synthesis variability' from a config hash.

    The sine of arguments in the thousands differs by an ulp between
    XLA, torch on the CPU and CUDA; at 3% amplitude that stays at
    float32 tolerance.
    """
    h = (cfg.pe_rows * 12.9898 + cfg.pe_cols * 78.233
         + cfg.gbuf_kb * 0.3719 + cfg.spad_ifmap * 3.1415
         + cfg.spad_filter * 0.0711 + cfg.spad_psum * 7.919
         + cfg.pe_type.to(torch.float32) * 41.417
         + cfg.bandwidth_gbps * 1.6180 + salt * 93.9737)
    return 1.0 + _NOISE_AMP * torch.sin(h) * torch.cos(h * 1.7)


def synthesize(cfg: AcceleratorConfig) -> SynthResult:
    n_pes = cfg.pe_rows * cfg.pe_cols

    # ---- area -----------------------------------------------------------
    pe_area = PE.pe_area_um2(cfg.pe_type, cfg.spad_ifmap, cfg.spad_filter,
                             cfg.spad_psum)
    wiring = 1.0 + 0.015 * torch.log2(torch.clamp_min(n_pes, 2.0))
    area_um2 = (n_pes * pe_area * wiring
                + E.gbuf_area_um2(cfg.gbuf_kb)
                + n_pes * E.NOC_AREA_PER_PE_UM2
                + E.IO_AREA_UM2)
    area_mm2 = area_um2 * 1e-6 * _noise(cfg, 1.0)

    # ---- timing ----------------------------------------------------------
    crit = (PE.mac_delay_ns(cfg.pe_type)
            * (1.0 + 0.02 * torch.log2(torch.clamp_min(n_pes, 2.0)))
            + 0.035 * torch.log2(torch.clamp_min(cfg.gbuf_kb, 2.0)))
    crit = crit * _noise(cfg, 2.0)
    clock_ghz = 1.0 / crit

    # ---- power at nominal activity ----------------------------------------
    activity = 0.70
    a_b = PE.act_bits(cfg.pe_type)
    w_b = PE.weight_bits(cfg.pe_type)
    p_b = PE.psum_bits(cfg.pe_type)
    pe_pj_per_cycle = (PE.mac_energy_pj(cfg.pe_type)
                       + E.rf_access_energy(a_b, cfg.spad_ifmap * a_b)
                       + E.rf_access_energy(w_b, cfg.spad_filter * w_b)
                       + (2.0 / 12.0) * E.rf_access_energy(
                           p_b, cfg.spad_psum * p_b)
                       + PE.PE_CTRL_ENERGY_PJ)
    gbuf_pj_per_cycle = (cfg.pe_cols * a_b + cfg.pe_rows * w_b) \
        * E.gbuf_energy_per_bit(cfg.gbuf_kb)
    dyn_mw = activity * clock_ghz * (n_pes * pe_pj_per_cycle
                                     + gbuf_pj_per_cycle)  # pJ * GHz = mW
    leak_mw = LEAKAGE_MW_PER_MM2 * area_mm2
    power_mw = (dyn_mw + leak_mw) * _noise(cfg, 3.0)
    return SynthResult(area_mm2=area_mm2, crit_path_ns=crit,
                       clock_ghz=clock_ghz, power_mw=power_mw,
                       leakage_mw=leak_mw)


def oracle_ppa(params, cfg: AcceleratorConfig):
    """PPA stage of the oracle backend: ``(params, cfg) -> (power_mw,
    clock_ghz, area_mm2)``; ``params`` is empty, as the oracle has no
    fitted state."""
    del params
    s = synthesize(cfg)
    return s.power_mw, s.clock_ghz, s.area_mm2
