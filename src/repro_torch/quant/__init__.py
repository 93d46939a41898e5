"""Quantization numerics for the paper's PE types (port of
``repro.quant``); the packed-weight codecs are in ``repro_torch.quant.pack``."""

from repro_torch.quant.qconfig import QuantConfig, preset, PE_TYPES
from repro_torch.quant.fake_quant import (affine_fake_quant, pow2_fake_quant,
                                          pow2x2_fake_quant, fake_quant_weight,
                                          fake_quant_weights, fake_quant_act)

__all__ = [
    "QuantConfig", "preset", "PE_TYPES", "affine_fake_quant",
    "pow2_fake_quant", "pow2x2_fake_quant", "fake_quant_weight",
    "fake_quant_weights", "fake_quant_act",
]
