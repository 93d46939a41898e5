"""Matrix product with packed low-bit weights: the wrapper of the CUDA
kernel in ``repro_torch/csrc/quant_matmul.cu`` (which replaces the Pallas
kernel ``repro.kernels.quant_matmul.quant_matmul``).

A CUDA tensor launches the kernel, or raises: there is no fallback.  A
CPU tensor takes the plain torch version in ``ref.py``, which the kernel
is held to on the card.  ``quant_matmul.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.quant_matmul.ref import ref_quant_matmul

_MODES = {"int4": 0, "pow2": 1, "int8": 2}
_X_TYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("quant_matmul").quant_matmul_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
           mode: str):
    if x.ndim != 2 or w.ndim != 2:
        raise ValueError(f"quant_matmul needs a 2-D x and a 2-D weight, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    packed = mode in ("int4", "pow2")
    want = torch.uint8 if packed else torch.int8
    if w.dtype != want:
        raise ValueError(f"quant_matmul {mode} needs {want} codes, got "
                         f"{w.dtype}")
    k_w = w.shape[0] * (2 if packed else 1)
    if x.shape[1] != k_w:
        raise ValueError(f"quant_matmul {mode}: x has K={x.shape[1]} but the "
                         f"codes {tuple(w.shape)} hold K={k_w}")
    n = w.shape[1]
    if scale.dtype != torch.float32 or tuple(scale.shape) != (n,):
        raise ValueError(f"quant_matmul needs a float32 scale of shape "
                         f"({n},), got {scale.dtype} {tuple(scale.shape)}")


def quant_matmul(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, *,
                 mode: str = "int4") -> torch.Tensor:
    """y = x @ dequant(w), float32.

    x: (M, K) float32 or bfloat16.
    w: int4/pow2 -> (K//2, N) uint8 packed codes; int8 -> (K, N) int8.
    scale: (N,) float32 -- the step (int4/int8) or e_max (pow2).
    Any M, K (even for packed codes) and N; the output is a new tensor.
    """
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode}")
    _check(x, w, scale, mode)
    if x.device.type == "cpu":
        return ref_quant_matmul(x, w, scale, mode)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul runs on CUDA or CPU tensors, got "
                         f"{x.device}")
    if x.dtype not in _X_TYPES:
        raise ValueError(f"quant_matmul takes float32 or bfloat16 x, got "
                         f"{x.dtype}")
    for name, t in (("x", x), ("codes", w), ("scale", scale)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"quant_matmul needs {name} contiguous on "
                             f"{x.device}, got {t.device} "
                             f"contiguous={t.is_contiguous()}")
    m, k = x.shape
    n = w.shape[1]
    if max(m, k, n) >= 2 ** 31:
        raise ValueError(f"quant_matmul: shape {(m, k, n)} exceeds int32")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    launch = _entry()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = launch(x.data_ptr(), _X_TYPES[x.dtype], w.data_ptr(),
                    scale.data_ptr(), out.data_ptr(), m, k, n, _MODES[mode],
                    stream)
    if rc != 0:
        raise RuntimeError(f"quant_matmul kernel launch failed: CUDA error "
                           f"{rc}")
    quant_matmul.launches += 1
    return out


quant_matmul.launches = 0

# The reference pads ragged shapes in ``quant_matmul_any``; this kernel
# takes any shape itself, so the name is kept as an alias for API parity.
quant_matmul_any = quant_matmul
