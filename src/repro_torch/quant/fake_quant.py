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
a CPU tensor it is the kernel's plain torch version.  A list of tensors
shares its launches (``fake_quant_weights``: one a group, two for
pow2x2), and so does a stack of expert weights or activations, each
slice with its own scale (``fake_quant_experts``,
``fake_quant_expert_acts``: the reference vmaps over the experts).  The STE keeps the
reference's expression ``x + (q - x).detach()``, which is not bitwise
``q`` in float32.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.fake_quant import fake_quant_group
from repro_torch.kernels.fake_quant.ref import POW2_LEVELS
from repro_torch.launch.mesh import dp_max
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


def _fused_group(xs, scales, mode: str, bits: int = 8) -> list:
    """The kernel's elementwise body on tensors of any rank, in one launch:
    each x viewed as (prod(leading dims), N) with the last axis as the
    channel axis, with a per-channel (broadcastable to (..., N)) or
    per-tensor scale (passed as one value, not expanded)."""
    mats, flat = [], []
    for x, scale in zip(xs, scales):
        n = x.shape[-1] if x.ndim else 1
        if scale.numel() == 1:
            s = scale.reshape(1)
        elif scale.numel() == n and scale.shape[-1] == n:
            s = scale.reshape(n)
        else:
            raise ValueError(f"scale of shape {tuple(scale.shape)} is neither "
                             f"per-tensor nor per-channel for "
                             f"{tuple(x.shape)}")
        mats.append(x.reshape(-1, n).contiguous())
        flat.append(s.contiguous())
    outs = fake_quant_group(mats, flat, mode=mode, bits=bits)
    return [out.reshape(x.shape) for out, x in zip(outs, xs)]


# ---------------------------------------------------------------------------
# Affine (uniform symmetric)
# ---------------------------------------------------------------------------

def affine_scale(x: torch.Tensor, bits: int, axis=None) -> torch.Tensor:
    """Symmetric scale so that absmax maps to the max int level."""
    return _scale_of(_absmax(x, axis), bits)


def _scale_of(absmax: torch.Tensor, bits: int) -> torch.Tensor:
    qmax = 2.0 ** (bits - 1) - 1.0
    absmax = torch.clamp_min(absmax, 1e-8)
    # divide by a tensor on x's device: CUDA divides by a Python scalar
    # as a multiply by its reciprocal, an ulp off IEEE division
    return absmax / absmax.new_tensor(qmax)


def affine_quantize(x: torch.Tensor, scale: torch.Tensor, bits: int):
    """Integer codes in [-qmax, qmax] (as floats)."""
    qmax = 2.0 ** (bits - 1) - 1.0
    return torch.clamp(torch.round(x / scale), -qmax, qmax)


def affine_fake_quant(x: torch.Tensor, bits: int, axis=None) -> torch.Tensor:
    return _fake_quant_group([x], "affine", bits, [axis])[0]


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
    return _fused_group([x], [e_max], "pow2")[0]


def pow2_fake_quant(x: torch.Tensor, axis=None) -> torch.Tensor:
    return _fake_quant_group([x], "pow2", 0, [axis])[0]


# ---------------------------------------------------------------------------
# Sum of two powers of two (LightPE-2)
# ---------------------------------------------------------------------------

def _pow2x2_round_group(xs, e_maxs) -> list:
    """``pow2x2_round`` of each x, the pow2 passes grouped: two launches."""
    q1s = _fused_group(xs, e_maxs, "pow2")
    rs = [x - q1 for x, q1 in zip(xs, q1s)]
    # the residual is < half the value
    q2s = _fused_group(rs, [e - 1.0 for e in e_maxs], "pow2")
    out = []
    for x, q1, q2 in zip(xs, q1s, q2s):
        # keep the two-term form only when it helps (residual may be tiny)
        better = torch.abs(x - (q1 + q2)) <= torch.abs(x - q1)
        out.append(torch.where(better, q1 + q2, q1))
    return out


def pow2x2_round(x: torch.Tensor, e_max: torch.Tensor):
    return _pow2x2_round_group([x], [e_max])[0]


def pow2x2_fake_quant(x: torch.Tensor, axis=None) -> torch.Tensor:
    return _fake_quant_group([x], "pow2x2", 0, [axis])[0]


# ---------------------------------------------------------------------------
# Dispatch by QuantConfig
# ---------------------------------------------------------------------------

def _quantize_group(ds, scheme: str, bits: int, axes, reduce=None) -> list:
    """The quantize-dequantize of each (detached) x under ``scheme``, x's
    scale reduced over its own axes, in one launch (two for pow2x2, whose
    second pass needs the residuals).  ``reduce`` (affine, one absmax a
    tensor) takes the stacked absmaxes to those the scales come from, as
    ``dp_max`` takes them over the dp ranks."""
    if scheme == "affine":
        absmax = [_absmax(d, a) for d, a in zip(ds, axes)]
        if reduce is not None:
            absmax = reduce(torch.stack(absmax)).unbind(0)
        qs = _fused_group(ds, [_scale_of(m, bits) for m in absmax],
                          "affine", bits)
    elif scheme == "pow2":
        qs = _fused_group(ds, [pow2_emax(d, a) for d, a in zip(ds, axes)],
                          "pow2")
    elif scheme == "pow2x2":
        qs = _pow2x2_round_group(ds, [pow2_emax(d, a)
                                      for d, a in zip(ds, axes)])
    else:
        raise ValueError(f"unknown weight scheme {scheme}")
    return qs


def _fake_quant_group(xs, scheme: str, bits: int, axes, reduce=None) -> list:
    """The STE fake quantization of each x under ``scheme``, x's scale
    reduced over its own axes (and by ``reduce``, as ``_quantize_group``);
    the kernel's passes are shared by the list: one launch, two for pow2x2
    (whose second pass needs the residuals)."""
    qs = _quantize_group([x.detach() for x in xs], scheme, bits, axes,
                         reduce)
    return [_ste(x, q) for x, q in zip(xs, qs)]


def fake_quant_weights(ws, qcfg: QuantConfig) -> list:
    """``[fake_quant_weight(w, qcfg) for w in ws]``, bit for bit, in one
    launch of the kernel (two for pow2x2)."""
    ws = list(ws)
    if qcfg.weight_scheme == "none":
        return ws
    # per-channel = last axis (output features)
    axes = [tuple(range(w.ndim - 1)) if qcfg.per_channel else None
            for w in ws]
    return _fake_quant_group(ws, qcfg.weight_scheme, qcfg.weight_bits, axes)


def fake_quant_weight(w: torch.Tensor, qcfg: QuantConfig) -> torch.Tensor:
    """Quantize a weight tensor; per-channel = last axis (output features)."""
    return fake_quant_weights([w], qcfg)[0]


def fake_quant_act(x: torch.Tensor, qcfg: QuantConfig) -> torch.Tensor:
    """Per-tensor dynamic activation quantization.  Under the launcher's
    mesh context (``launch.mesh.activation_sharding``) x is this rank's
    slice of the batch, and its absmax is the max over the dp ranks
    (``dp_max``): the scale spans the global batch, as on one device."""
    if qcfg.act_scheme == "none" or not qcfg.quantize_acts:
        return x
    return _fake_quant_group([x], "affine", qcfg.act_bits, [None],
                             dp_max)[0]


def _stacked(x: torch.Tensor, scheme: str, bits: int, per_channel: bool,
             reduce=None):
    """The STE fake quantization of every x[e] of a stack, each with its
    own scale (per channel over its own rows, or per tensor; ``reduce`` as
    ``_quantize_group``'s), the slices sharing the kernel's launches."""
    ds = list(x.detach().unbind(0))
    axes = [tuple(range(d.ndim - 1)) if per_channel else None for d in ds]
    return _ste(x, torch.stack(_quantize_group(ds, scheme, bits, axes,
                                               reduce)))


def fake_quant_experts(w: torch.Tensor, qcfg: QuantConfig) -> torch.Tensor:
    """``fake_quant_weight`` of every expert's weight w[e] of an (E, K, N)
    stack, its per-channel scale over that expert's K only, as the
    reference vmaps it over the experts: one launch a group of up to 64
    experts (two for pow2x2).  Taking the stack as one tensor would reduce
    over E x K instead."""
    if qcfg.weight_scheme == "none":
        return w
    return _stacked(w, qcfg.weight_scheme, qcfg.weight_bits,
                    qcfg.per_channel)


def fake_quant_expert_acts(x: torch.Tensor, qcfg: QuantConfig):
    """``fake_quant_act`` of every expert's (C, K) buffer x[e] of an (E, C,
    K) stack: one scale an expert, over its own buffer (the zero rows of
    unused capacity counted), as under the reference's vmap.  Under the
    launcher's mesh context each rank's buffer is its slice of the global
    one, and the (E,) absmax is the max over the dp ranks (``dp_max``), as
    ``fake_quant_act``'s: no collective over one dp rank."""
    if qcfg.act_scheme == "none" or not qcfg.quantize_acts:
        return x
    return _stacked(x, "affine", qcfg.act_bits, False, reduce=dp_max)
