"""Memory-hierarchy energy / area constants, 45 nm (port of
``repro.core.energy``).

Level ratios follow Eyeriss (ISCA'16), expressed per *bit* so narrower
quantized operands cost proportionally less to move.
"""

from __future__ import annotations

import torch

# pJ per bit moved at each level (16-bit reference access in parens).
NOC_E_PER_BIT_PJ = 2.0 / 16.0       # inter-PE network hop       (2 pJ / 16b)
GBUF_E_PER_BIT_PJ = 5.0 / 16.0      # 108 KB-class SRAM          (5 pJ / 16b)
DRAM_E_PER_BIT_PJ = 200.0 / 16.0    # LPDDR-class               (200 pJ / 16b)

GBUF_REF_KB = 108.0                 # gbuf energy scales ~sqrt(capacity)

# Scratchpad access: fixed + per-bit components, both ~sqrt(capacity).
# Reference: 1 pJ for a 16-bit access to a 4096-bit (256x16) spad.
RF_C0_PJ = 0.20                     # per-access (decoder/wordline)
RF_C1_PJ_PER_BIT = 0.65 / 16.0      # per bit read/written
RF_REF_CAP_BITS = 4096.0

# Area (um^2 per bit) for the SRAM macros.
GBUF_AREA_PER_BIT_UM2 = 0.22        # dense SRAM
GBUF_PERIPHERY_UM2 = 45000.0        # decoders/sense amps, ~fixed
NOC_AREA_PER_PE_UM2 = 120.0         # router + wiring share per PE
IO_AREA_UM2 = 150000.0              # pads / PHY, fixed


def rf_access_energy(bits_per_access, cap_bits):
    """Energy of one scratchpad access (pJ)."""
    scale = torch.sqrt(torch.clamp_min(cap_bits, 64.0) / RF_REF_CAP_BITS)
    return (RF_C0_PJ + bits_per_access * RF_C1_PJ_PER_BIT) * scale


def gbuf_energy_per_bit(gbuf_kb):
    """Global buffer access energy per bit; grows ~sqrt(capacity)."""
    return GBUF_E_PER_BIT_PJ * torch.sqrt(gbuf_kb / GBUF_REF_KB)


def gbuf_area_um2(gbuf_kb):
    bits = gbuf_kb * 1024.0 * 8.0
    return bits * GBUF_AREA_PER_BIT_UM2 + GBUF_PERIPHERY_UM2


def dram_energy_pj(bits):
    return bits * DRAM_E_PER_BIT_PJ


def noc_energy_pj(bits):
    return bits * NOC_E_PER_BIT_PJ
