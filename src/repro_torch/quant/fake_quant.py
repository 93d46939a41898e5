"""Fake-quantization numerics for QAT with a straight-through estimator
(port of ``repro.quant.fake_quant``).

The three weight schemes of the paper's PE types:

  * affine : symmetric uniform quantization (int8 / int16), per-channel
             or per-tensor scales;
  * pow2   : power-of-two weights (LightPE-1): w -> +-2^e with a 3-bit
             exponent window anchored at the per-channel absmax;
  * pow2x2 : sum of two powers of two (LightPE-2): w -> +-2^e1 +- 2^e2.

The scales (``affine_scale``, ``pow2_emax``) are plain torch reductions.
The elementwise quantize-dequantize body runs through the fused
``fake_quant`` kernel: on a CUDA tensor it launches the CUDA kernel, on
a CPU tensor it is the kernel's plain torch version.  The STE keeps the
reference's expression ``x + (q - x).detach()``, which is not bitwise
``q`` in float32.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.fake_quant import fake_quant
from repro_torch.kernels.fake_quant.ref import POW2_LEVELS
from repro_torch.quant.qconfig import QuantConfig


def _ste(x, qx):
    """Straight-through estimator: forward qx, gradient of identity."""
    return x + (qx - x).detach()


def _absmax(x: torch.Tensor, axis) -> torch.Tensor:
    """max |x| over ``axis`` (None = every axis), keeping reduced dims."""
    if axis is None:
        return torch.amax(torch.abs(x))
    if axis == ():
        return torch.abs(x)  # jnp.max over no axes reduces nothing
    return torch.amax(torch.abs(x), dim=axis, keepdim=True)


def _fused(x: torch.Tensor, scale: torch.Tensor, mode: str,
           bits: int = 8) -> torch.Tensor:
    """The kernel's elementwise body on a tensor of any rank: x viewed as
    (prod(leading dims), N) with the last axis as the channel axis, and a
    per-channel (broadcastable to (..., N)) or per-tensor scale."""
    n = x.shape[-1] if x.ndim else 1
    if scale.numel() == 1:
        s = scale.reshape(1).expand(n)
    elif scale.numel() == n and scale.shape[-1] == n:
        s = scale.reshape(n)
    else:
        raise ValueError(f"scale of shape {tuple(scale.shape)} is neither "
                         f"per-tensor nor per-channel for {tuple(x.shape)}")
    out = fake_quant(x.reshape(-1, n).contiguous(), s.contiguous(),
                     mode=mode, bits=bits)
    return out.reshape(x.shape)


# ---------------------------------------------------------------------------
# Affine (uniform symmetric)
# ---------------------------------------------------------------------------

def affine_scale(x: torch.Tensor, bits: int, axis=None) -> torch.Tensor:
    """Symmetric scale so that absmax maps to the max int level."""
    qmax = 2.0 ** (bits - 1) - 1.0
    absmax = torch.clamp_min(_absmax(x, axis), 1e-8)
    # divide by a tensor on x's device: CUDA divides by a Python scalar
    # as a multiply by its reciprocal, an ulp off IEEE division
    return absmax / absmax.new_tensor(qmax)


def affine_quantize(x: torch.Tensor, scale: torch.Tensor, bits: int):
    """Integer codes in [-qmax, qmax] (as floats)."""
    qmax = 2.0 ** (bits - 1) - 1.0
    return torch.clamp(torch.round(x / scale), -qmax, qmax)


def affine_fake_quant(x: torch.Tensor, bits: int, axis=None) -> torch.Tensor:
    scale = affine_scale(x.detach(), bits, axis)
    qx = _fused(x.detach(), scale, "affine", bits)
    return _ste(x, qx)


# ---------------------------------------------------------------------------
# Power-of-two (LightPE-1)
# ---------------------------------------------------------------------------

def pow2_emax(x: torch.Tensor, axis=None) -> torch.Tensor:
    """Top exponent of the representable window, from the absmax."""
    return torch.round(torch.log2(torch.clamp_min(_absmax(x, axis), 1e-8)))


def pow2_round(x: torch.Tensor, e_max: torch.Tensor) -> torch.Tensor:
    """Round magnitude to the nearest power of two inside
    [e_max - (POW2_LEVELS - 1), e_max].

    The reference passes the window floor ``e_min`` explicitly; every
    caller passes ``e_max - (POW2_LEVELS - 1)``, which is what the fused
    kernel derives itself, so the port takes only ``e_max``.  Values
    below the window floor to +-2^e_min; exact zeros stay zero.
    """
    return _fused(x, e_max, "pow2")


def pow2_fake_quant(x: torch.Tensor, axis=None) -> torch.Tensor:
    e_max = pow2_emax(x.detach(), axis)
    return _ste(x, pow2_round(x.detach(), e_max))


# ---------------------------------------------------------------------------
# Sum of two powers of two (LightPE-2)
# ---------------------------------------------------------------------------

def pow2x2_round(x: torch.Tensor, e_max: torch.Tensor):
    q1 = pow2_round(x, e_max)
    r = x - q1
    q2 = pow2_round(r, e_max - 1.0)  # residual is < half the value
    # keep the two-term form only when it helps (residual may be tiny)
    better = torch.abs(x - (q1 + q2)) <= torch.abs(x - q1)
    return torch.where(better, q1 + q2, q1)


def pow2x2_fake_quant(x: torch.Tensor, axis=None) -> torch.Tensor:
    e_max = pow2_emax(x.detach(), axis)
    return _ste(x, pow2x2_round(x.detach(), e_max))


# ---------------------------------------------------------------------------
# Dispatch by QuantConfig
# ---------------------------------------------------------------------------

def fake_quant_weight(w: torch.Tensor, qcfg: QuantConfig) -> torch.Tensor:
    """Quantize a weight tensor; per-channel = last axis (output features)."""
    if qcfg.weight_scheme == "none":
        return w
    axis = tuple(range(w.ndim - 1)) if qcfg.per_channel else None
    if qcfg.weight_scheme == "affine":
        return affine_fake_quant(w, qcfg.weight_bits, axis)
    if qcfg.weight_scheme == "pow2":
        return pow2_fake_quant(w, axis)
    if qcfg.weight_scheme == "pow2x2":
        return pow2x2_fake_quant(w, axis)
    raise ValueError(f"unknown weight scheme {qcfg.weight_scheme}")


def fake_quant_act(x: torch.Tensor, qcfg: QuantConfig) -> torch.Tensor:
    """Per-tensor dynamic activation quantization."""
    if qcfg.act_scheme == "none" or not qcfg.quantize_acts:
        return x
    return affine_fake_quant(x, qcfg.act_bits, axis=None)
