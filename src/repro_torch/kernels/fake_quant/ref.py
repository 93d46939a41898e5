"""Plain torch version of the fused fake-quant kernel (forward only), the
port of ``repro.kernels.fake_quant.ref``.  ``torch.round`` rounds half to
even, like ``jnp.round``."""

from __future__ import annotations

import torch

POW2_LEVELS = 8  # sign + 3-bit exponent -> 8 levels


def ref_fake_quant_affine(w: torch.Tensor, scale: torch.Tensor,
                          bits: int) -> torch.Tensor:
    """w: (K, N); scale: (N,) per-channel. Quantize-dequantize forward."""
    qmax = 2.0 ** (bits - 1) - 1.0
    q = torch.clamp(torch.round(w / scale[None, :]), -qmax, qmax)
    return q * scale[None, :]


def ref_fake_quant_pow2(w: torch.Tensor, e_max: torch.Tensor) -> torch.Tensor:
    """w: (K, N); e_max: (N,). LightPE-1 pow2 rounding forward."""
    e_max = e_max[None, :]
    e_min = e_max - (POW2_LEVELS - 1)
    mag = torch.clamp_min(torch.abs(w), 1e-12)
    e = torch.minimum(torch.maximum(torch.round(torch.log2(mag)), e_min), e_max)
    return torch.sign(w) * torch.exp2(e)
