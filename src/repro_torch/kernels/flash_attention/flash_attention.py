"""Flash attention forward: the wrapper of the CUDA kernel in
``repro_torch/csrc/flash_attention.cu`` (which replaces the Pallas kernel
``repro.kernels.flash_attention.flash_attention``).

Three entry points, one kernel:

  flash_attention(q, k, v)        one head, (S, D) -- the Pallas signature;
  flash_attention_bh(q, k, v)     (B, H, S, D), as ops.py's vmapped form;
  flash_attention_gqa(q, k, v, q_start)
                                  the model's layout (B, S, H, D) with
                                  grouped KV heads and a query start
                                  position per batch row (prompt: 0;
                                  decode: the cache index).

A CUDA tensor launches the kernel, or raises: there is no fallback.  A
CPU tensor takes the plain torch version in ``ref.py``, which the kernel
is held to on the card.  ``flash_attention.launches`` counts the
kernel's launches through any of the three.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import (ref_attention_gqa,
                                                     ref_flash_attention)

_HEAD_DIMS = (16, 32, 64, 128)
_TYPES = {torch.float32: 0, torch.bfloat16: 1}
_Strides = ctypes.c_longlong * 3


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("flash_attention").flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 7
                   + [ctypes.POINTER(ctypes.c_longlong)] * 4
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, q_start):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"flash attention needs 4-D q, k, v, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, hq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if k.shape[1] < 1 or k.shape[2] < 1 or hq % k.shape[2]:
        raise ValueError(f"flash attention needs Skv >= 1 and Hq a multiple "
                         f"of Hkv, got {tuple(k.shape)} for Hq={hq}")
    if q_start is not None and (tuple(q_start.shape) != (b,)
                                or q_start.device != q.device):
        raise ValueError(f"flash attention needs q_start of shape ({b},) on "
                         f"{q.device}, got {tuple(q_start.shape)} on "
                         f"{q_start.device}")


def _launch(q, k, v, q_start, causal: bool, scale: float) -> torch.Tensor:
    """The kernel on (B, S, H, D) views; returns (B, Sq, Hq, D) float32."""
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on CUDA or CPU tensors, got "
                         f"{q.device}")
    if q.dtype not in _TYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash attention takes float32 or bfloat16 q, k, v "
                         f"of one type, got {q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.stride(3) != 1:
            raise ValueError(f"flash attention needs {name} on {q.device} "
                             f"with a contiguous last axis")
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash attention takes head_dim in {_HEAD_DIMS}, "
                         f"got {d}")
    if max(b, sq, skv, hq) >= 2 ** 31:
        raise ValueError("flash attention: a dimension exceeds int32")
    if q_start is None:
        q_start = torch.zeros(b, dtype=torch.int32, device=q.device)
    elif q_start.dtype != torch.int32 or not q_start.is_contiguous():
        raise ValueError(f"flash attention needs a contiguous int32 q_start, "
                         f"got {q_start.dtype}")
    out = torch.empty((b, sq, hq, d), dtype=torch.float32, device=q.device)
    strides = [_Strides(*t.stride()[:3]) for t in (q, k, v, out)]
    launch = _entry()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    q_start.data_ptr(), _TYPES[q.dtype], b, sq, skv, hq, hkv,
                    d, *strides, scale or d ** -0.5, int(causal), stream)
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA error "
                           f"{rc}")
    flash_attention.launches += 1
    return out


def flash_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_start: torch.Tensor | None = None, *,
                        causal: bool = True,
                        scale: float = 0.0) -> torch.Tensor:
    """q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) -> (B, Sq, Hq, D) float32.

    Query head h reads KV head h // (Hq / Hkv).  With ``causal``, query i
    of batch row b sits at position q_start[b] + i (q_start: (B,) int32,
    non-negative; None = 0) and sees keys 0 .. q_start[b] + i.  ``scale``
    0 means 1/sqrt(D).
    """
    _check(q, k, v, q_start)
    if q.device.type == "cpu":
        start = (torch.zeros(q.shape[0], dtype=torch.int32)
                 if q_start is None else q_start)
        return ref_attention_gqa(q, k, v, start, causal, scale)
    return _launch(q, k, v, q_start, causal, scale)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float = 0.0) -> torch.Tensor:
    """q: (Sq, D); k, v: (Skv, D) -> (Sq, D) float32.  One head; any Sq and
    Skv (the kernel masks the ragged tile itself)."""
    if q.ndim != 2 or k.ndim != 2 or v.ndim != 2:
        raise ValueError("flash_attention takes (S, D) q, k, v")
    if q.device.type == "cpu":
        _check(q[None, :, None], k[None, :, None], v[None, :, None], None)
        return ref_flash_attention(q, k, v, causal, scale)
    out = flash_attention_gqa(q[None, :, None], k[None, :, None],
                              v[None, :, None], causal=causal, scale=scale)
    return out[0, :, 0]


flash_attention.launches = 0


def flash_attention_bh(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True,
                       scale: float = 0.0) -> torch.Tensor:
    """q: (B, H, Sq, D); k, v: (B, H, Skv, D) -> (B, H, Sq, D) float32.

    Unlike the reference's ops.py, nothing is padded: keys past Skv do not
    exist for any query, causal or not."""
    out = flash_attention_gqa(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal, scale=scale)
    return out.transpose(1, 2)
