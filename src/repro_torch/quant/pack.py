"""Weight packing for the quantized serving path (port of
``repro.quant.pack``).

Serving stores the weights in the code format of the PE type the DSE
chose, packed into bytes in device memory: 4-bit codes two per byte, so
the ``quant_matmul`` kernel reads a quarter (int8: half) of the bytes of
a bf16 weight and dequantizes in registers.

Code formats (little nibble first within a byte):
  * int4  : two's-complement 4-bit integers, per-channel float scale
  * pow2  : sign (bit 3) + 3-bit exponent index into [e_max-7, e_max],
            per-channel e_max; code value = +-2^(e_max - 7 + idx)
  * int8  : plain int8 with per-channel scale (no packing)

Weights are (K, N) with the channel (output feature) on the last axis
and the codes packed along the reduction axis K, as in the reference;
the port also takes a stack (..., K, N) of such weights and packs each.
Codes are uint8 / int8 tensors, bit-exact with the reference except
pow2 codes where log2|w| sits at a half-integer (see ROADMAP C).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.fake_quant.ref import POW2_LEVELS
from repro_torch.quant.fake_quant import (affine_quantize, affine_scale,
                                          pow2_emax)


# ---------------------------------------------------------------------------
# nibble packing
# ---------------------------------------------------------------------------

def pack_nibbles(codes: torch.Tensor) -> torch.Tensor:
    """Pack uint4 codes (values 0..15, any int dtype) along the LAST axis.

    codes: (..., K) with K even -> (..., K//2) uint8; element 2i sits in the
    low nibble, 2i+1 in the high nibble.
    """
    if codes.shape[-1] % 2:
        raise ValueError(f"cannot pack an odd axis of {codes.shape[-1]} codes")
    c = codes.to(torch.uint8)
    return (c[..., 0::2] & 0xF) | ((c[..., 1::2] & 0xF) << 4)


def unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_nibbles: (..., K//2) uint8 -> (..., K) uint8 (0..15)."""
    lo = packed & 0xF
    hi = (packed >> 4) & 0xF
    return torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1], -1)


def _pack_k(codes: torch.Tensor) -> torch.Tensor:
    """pack_nibbles along the reduction axis: (..., K, N) -> (..., K//2, N)."""
    return pack_nibbles(codes.transpose(-1, -2)).transpose(-1, -2).contiguous()


def _unpack_k(packed: torch.Tensor) -> torch.Tensor:
    return unpack_nibbles(packed.transpose(-1, -2)).transpose(-1, -2)


# ---------------------------------------------------------------------------
# int4 affine
# ---------------------------------------------------------------------------

def quantize_int4(w: torch.Tensor):
    """w: (..., K, N) -> packed codes (..., K//2, N) uint8 + scale (..., N)."""
    scale = affine_scale(w, 4, axis=-2)                   # (..., 1, N)
    q = affine_quantize(w, scale, 4).to(torch.int8)       # [-7, 7]
    codes = (q & 0xF).to(torch.uint8)                     # two's complement
    return _pack_k(codes), scale[..., 0, :]


def dequantize_int4(packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    codes = _unpack_k(packed).to(torch.int8)
    q = torch.where(codes >= 8, codes - 16, codes)        # sign-extend 4b
    return q.to(torch.float32) * scale[..., None, :]


# ---------------------------------------------------------------------------
# pow2 (LightPE-1) 4-bit codes
# ---------------------------------------------------------------------------

def quantize_pow2(w: torch.Tensor):
    """w: (..., K, N) -> packed 4-bit pow2 codes (along K) + e_max (..., N)."""
    e_max = pow2_emax(w, axis=-2)                         # (..., 1, N)
    e_min = e_max - (POW2_LEVELS - 1)
    mag = torch.clamp_min(torch.abs(w), 1e-12)
    idx = torch.clamp(torch.round(torch.log2(mag)) - e_min, 0, POW2_LEVELS - 1)
    sign_bit = (w < 0).to(torch.uint8)
    codes = (idx.to(torch.uint8) | (sign_bit << 3)) & 0xF
    return _pack_k(codes), e_max[..., 0, :]


def dequantize_pow2(packed: torch.Tensor, e_max: torch.Tensor) -> torch.Tensor:
    codes = _unpack_k(packed)
    idx = (codes & 0x7).to(torch.float32)
    sign = torch.where(((codes >> 3) & 1).bool(), -1.0, 1.0)
    e = e_max[..., None, :] - (POW2_LEVELS - 1) + idx
    return sign * torch.exp2(e)


# ---------------------------------------------------------------------------
# int8 affine (no packing, for LightPE-2-as-8b and INT8 serving)
# ---------------------------------------------------------------------------

def quantize_int8(w: torch.Tensor):
    scale = affine_scale(w, 8, axis=-2)
    q = affine_quantize(w, scale, 8).to(torch.int8)
    return q, scale[..., 0, :]


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale[..., None, :]


QUANTIZE = {"int4": quantize_int4, "pow2": quantize_pow2,
            "int8": quantize_int8}
DEQUANTIZE = {"int4": dequantize_int4, "pow2": dequantize_pow2,
              "int8": dequantize_int8}
