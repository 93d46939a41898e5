"""Quantization configuration: maps the paper's PE types to QAT numerics
(port of ``repro.quant.qconfig``).

Each PE type in the QADAM hardware space implies a numerics scheme for
training (QAT fake-quant) and serving (packed weights):

  fp32     -> no quantization
  int16    -> 16-bit affine weights (per-channel) + 16-bit affine acts
  lightpe1 -> power-of-two weights, 4-bit codes (sign + 3-bit exponent),
              8-bit affine activations            (LightNN-1 numerics)
  lightpe2 -> sum-of-two-powers-of-two weights, 8-bit codes,
              8-bit affine activations            (LightNN-2 numerics)
  int8     -> 8-bit affine weights (per-channel) + 8-bit affine acts
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    pe_type: str = "fp32"          # one of repro_torch.core.arch.PE_TYPE_NAMES
    weight_scheme: str = "none"    # none | affine | pow2 | pow2x2
    weight_bits: int = 32
    act_scheme: str = "none"       # none | affine
    act_bits: int = 32
    per_channel: bool = True       # per-output-channel weight scales
    quantize_acts: bool = True

    @property
    def is_identity(self) -> bool:
        return self.weight_scheme == "none" and self.act_scheme == "none"


_PRESETS = {
    "fp32": QuantConfig("fp32", "none", 32, "none", 32),
    "int16": QuantConfig("int16", "affine", 16, "affine", 16),
    "lightpe1": QuantConfig("lightpe1", "pow2", 4, "affine", 8),
    "lightpe2": QuantConfig("lightpe2", "pow2x2", 8, "affine", 8),
    "int8": QuantConfig("int8", "affine", 8, "affine", 8),
}


def preset(pe_type: str) -> QuantConfig:
    """QuantConfig for one of the paper's PE types."""
    return _PRESETS[pe_type]


PE_TYPES = tuple(_PRESETS)
