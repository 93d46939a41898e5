"""Fused per-channel fake quantization: the wrapper of the CUDA kernel in
``repro_torch/csrc/fake_quant.cu`` (which replaces the Pallas kernel
``repro.kernels.fake_quant.fake_quant``).

A CUDA tensor launches the kernel, or raises: there is no fallback.  A
CPU tensor takes the plain torch version in ``ref.py``, which the kernel
is held to on the card.  ``fake_quant.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fake_quant.ref import (ref_fake_quant_affine,
                                                ref_fake_quant_pow2)

_MODES = {"affine": 0, "pow2": 1}


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("fake_quant").fake_quant_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fake_quant(w: torch.Tensor, scale: torch.Tensor, *, mode: str = "affine",
               bits: int = 8) -> torch.Tensor:
    """Fused quantize-dequantize of w: (K, N) float32 with one value per
    column in scale: (N,), the step for ``mode="affine"`` or e_max for
    ``mode="pow2"``.  Any K and N; the output is a new tensor."""
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode}")
    if w.device.type == "cpu":
        if mode == "affine":
            return ref_fake_quant_affine(w, scale, bits)
        return ref_fake_quant_pow2(w, scale)
    if w.device.type != "cuda":
        raise ValueError(f"fake_quant runs on CUDA or CPU tensors, got "
                         f"{w.device}")
    if w.dtype != torch.float32 or w.ndim != 2 or not w.is_contiguous():
        raise ValueError(f"fake_quant needs a contiguous 2-D float32 weight, "
                         f"got {w.dtype} {tuple(w.shape)} "
                         f"contiguous={w.is_contiguous()}")
    k, n = w.shape
    if (scale.dtype != torch.float32 or tuple(scale.shape) != (n,)
            or not scale.is_contiguous() or scale.device != w.device):
        raise ValueError(f"fake_quant needs a contiguous float32 scale of "
                         f"shape ({n},) on {w.device}, got {scale.dtype} "
                         f"{tuple(scale.shape)} on {scale.device}")
    out = torch.empty_like(w)
    if w.numel() == 0:
        return out
    launch = _entry()
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        rc = launch(w.data_ptr(), scale.data_ptr(), out.data_ptr(), k, n,
                    _MODES[mode], 2.0 ** (bits - 1) - 1.0, stream)
    if rc != 0:
        raise RuntimeError(f"fake_quant kernel launch failed: CUDA error {rc}")
    fake_quant.launches += 1
    return out


fake_quant.launches = 0

# The reference pads ragged shapes in ``fake_quant_any``; this kernel takes
# any (K, N) itself, so the name is kept as an alias for API parity.
fake_quant_any = fake_quant
