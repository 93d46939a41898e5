"""Processing-element models: energy / area / delay per PE type
(port of ``repro.core.pe``).

45 nm figures from Horowitz (ISSCC'14), LightNN (TRETS'18) and Eyeriss
(ISCA'16), as in the reference.  The per-type tables are float32
tensors indexed by the PE-type code; the accessors gather with
``pe_type.long()`` on the device of ``pe_type``.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core.arch import PE_TYPE_NAMES

_N = len(PE_TYPE_NAMES)  # fp32, int16, lightpe1, lightpe2, int8

# --- datapath widths (bits) ------------------------------------------------
#                                fp32   int16  lpe1   lpe2   int8
ACT_BITS = torch.tensor(        [32.0, 16.0,  8.0,   8.0,   8.0])
WEIGHT_BITS = torch.tensor(     [32.0, 16.0,  4.0,   8.0,   8.0])
PSUM_BITS = torch.tensor(       [32.0, 32.0,  20.0,  20.0,  24.0])

# --- arithmetic energy (pJ per MAC-equivalent op, 45 nm) --------------------
MAC_ENERGY_PJ = torch.tensor([
    3.7 + 0.9,              # fp32 mult + fp32 add            = 4.60
    0.8 + 0.10,             # int16 mult + int32 add          = 0.90
    0.024 + 0.08,           # 1 shift + int24 add             = 0.104
    2 * 0.024 + 2 * 0.08,   # 2 shifts + 2 int24 adds         = 0.208
    0.2 + 0.08,             # int8 mult + int24 add           = 0.28
])

# --- arithmetic area (um^2, 45 nm) ------------------------------------------
MAC_AREA_UM2 = torch.tensor([
    7700.0 + 4184.0,        # fp32                            = 11884
    930.0 + 137.0,          # int16                           = 1067
    100.0 + 100.0,          # lightpe1: shift + add           = 200
    150.0 + 110.0,          # lightpe2 (shared 2-term decode) = 260
    282.0 + 100.0,          # int8                            = 382
])

# --- PE critical path (ns, 45 nm, synthesized single-cycle MAC) -------------
MAC_DELAY_NS = torch.tensor([2.50, 1.25, 0.70, 0.72, 0.95])

# --- PE control / local-interconnect overhead -------------------------------
PE_CTRL_AREA_UM2 = 500.0       # FSM + NoC port, roughly constant per PE
PE_CTRL_ENERGY_PJ = 0.05       # per active cycle

# --- scratchpad (register-file class SRAM inside the PE) --------------------
SPAD_E_PER_BIT_PJ = 1.0 / 16.0   # 1 pJ per 16-bit access
SPAD_AREA_PER_BIT_UM2 = 0.50

# --- accuracy proxy -----------------------------------------------------------
# Mean top-1 accuracy deltas vs FP32 (percentage points) from the paper's
# Figs. 5-6 narrative, keyed by PE-type NAME so a reordering of
# PE_TYPE_NAMES can never misalign a delta; ACC_DELTA_PP is the derived
# positional view (gather by pe_type code).  ``accuracy.AccuracySurrogate``
# reads the dict.
ACC_DELTA_BY_NAME = {
    "fp32": 0.0,
    "int16": -0.1,
    "lightpe1": -0.9,
    "lightpe2": -0.4,
    "int8": -0.5,
}
ACC_DELTA_PP = torch.tensor([ACC_DELTA_BY_NAME[n] for n in PE_TYPE_NAMES])

_TABLES = dict(act=ACT_BITS, weight=WEIGHT_BITS, psum=PSUM_BITS,
               mac_energy=MAC_ENERGY_PJ, mac_area=MAC_AREA_UM2,
               mac_delay=MAC_DELAY_NS)


@functools.lru_cache(maxsize=None)
def _tables_on(device: torch.device) -> dict:
    """The per-type tables on ``device``, copied there once."""
    return {k: v.to(device) for k, v in _TABLES.items()}


def _lookup(name: str, pe_type: torch.Tensor) -> torch.Tensor:
    return _tables_on(pe_type.device)[name][pe_type.long()]


def act_bits(pe_type):
    return _lookup("act", pe_type)


def weight_bits(pe_type):
    return _lookup("weight", pe_type)


def psum_bits(pe_type):
    return _lookup("psum", pe_type)


def mac_energy_pj(pe_type):
    return _lookup("mac_energy", pe_type)


def mac_area_um2(pe_type):
    return _lookup("mac_area", pe_type)


def mac_delay_ns(pe_type):
    return _lookup("mac_delay", pe_type)


def spad_bits_per_word(pe_type):
    """(ifmap, filter, psum) word widths: act, weight and psum bits."""
    return act_bits(pe_type), weight_bits(pe_type), psum_bits(pe_type)


def pe_area_um2(pe_type, spad_ifmap, spad_filter, spad_psum):
    """Area of ONE processing element: arithmetic + scratchpads + control."""
    ib, fb, pb = spad_bits_per_word(pe_type)
    spad_bits = spad_ifmap * ib + spad_filter * fb + spad_psum * pb
    return (mac_area_um2(pe_type)
            + spad_bits * SPAD_AREA_PER_BIT_UM2
            + PE_CTRL_AREA_UM2)


def spad_access_energy_pj(bits):
    """Energy of one scratchpad access of `bits` width."""
    return bits * SPAD_E_PER_BIT_PJ
