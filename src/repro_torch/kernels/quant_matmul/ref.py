"""Plain torch version of the quant_matmul kernel, the port of
``repro.kernels.quant_matmul.ref``: dequantize the whole weight, then an
IEEE float32 matrix product."""

from __future__ import annotations

import torch

from repro_torch.quant.pack import DEQUANTIZE


def ref_quant_matmul(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                     mode: str) -> torch.Tensor:
    """x: (M, K) float; w: (K//2, N) uint8 int4/pow2 codes or (K, N) int8;
    scale: (N,) (e_max for pow2) -> (M, N) float32."""
    return x.to(torch.float32) @ DEQUANTIZE[mode](w, scale)

