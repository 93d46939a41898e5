"""Assigned input shapes x step kinds, as tensors on the ``meta`` device
(port of ``repro.launch.shapes``).

The 4 assigned shapes (LM shapes are seq_len x global_batch):
  train_4k    : seq 4096,   batch 256  -> train_step
  prefill_32k : seq 32768,  batch 32   -> prefill_step
  decode_32k  : seq 32768,  batch 128  -> serve_step (1 new token, KV@32k)
  long_500k   : seq 524288, batch 1    -> serve_step (sub-quadratic archs)

The reference's ``ShapeDtypeStruct`` stand-ins are ``meta`` tensors here:
shape and dtype, no storage, so nothing is allocated.  Family quirks:
Whisper's train / prefill take encoder FRAME embeddings of the stated
seq_len and a decoder stream of seq_len / 8; Qwen2-VL takes 3-D M-RoPE
position ids; the decode shapes' cache is the family's ``init_cache`` on
``meta``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq: int
    batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

WHISPER_DEC_FRAC = 8  # decoder stream = seq/8 for train/prefill shapes


def shape_runs(cfg, shape: ShapeSpec) -> bool:
    """Does this (arch x shape) cell run? (documented skips)"""
    if shape.kind == "decode":
        if not cfg.has_decode:
            return False
        if shape.seq > 100_000 and not cfg.sub_quadratic:
            return False  # long_500k needs sub-quadratic attention
    return True


def _i32(*shape):
    return torch.empty(shape, dtype=torch.int32, device="meta")


def _f32(*shape):
    return torch.empty(shape, dtype=torch.float32, device="meta")


def batch_specs(cfg, shape: ShapeSpec) -> Dict[str, Any]:
    """Training / prefill batch stand-ins."""
    b, s = shape.batch, shape.seq
    if cfg.family == "encdec":
        sd = max(s // WHISPER_DEC_FRAC, 16)
        return {"frames": _f32(b, s, cfg.d_model),
                "tokens": _i32(b, sd), "labels": _i32(b, sd)}
    out = {"tokens": _i32(b, s), "labels": _i32(b, s)}
    if cfg.family == "vlm":
        out["positions"] = _i32(b, s, 3)
    return out


def prefill_token_specs(cfg, shape: ShapeSpec):
    b, s = shape.batch, shape.seq
    if cfg.family == "encdec":
        sd = max(s // WHISPER_DEC_FRAC, 16)
        return {"frames": _f32(b, s, cfg.d_model), "tokens": _i32(b, sd)}
    return _i32(b, s)


def decode_token_specs(cfg, shape: ShapeSpec):
    return _i32(shape.batch, 1)


def cache_shape(cfg, mod, shape: ShapeSpec):
    """The family's cache at this shape on ``meta``: no allocation."""
    b, s = shape.batch, shape.seq
    if cfg.family == "ssm":
        return mod.init_cache(cfg, b, device="meta")
    return mod.init_cache(cfg, b, s, torch.bfloat16, device="meta")


def decode_extra_specs(cfg, shape: ShapeSpec) -> Dict[str, Any]:
    """Extra serve_step inputs (Whisper: encoder states)."""
    if cfg.family == "encdec":
        return {"enc_out": _f32(shape.batch, 4096, cfg.d_model)}
    if cfg.family == "vlm":
        return {"positions": _i32(shape.batch, 1, 3)}
    return {}


# per-arch microbatch counts for train_4k (the reference's, from its
# dry-run memory analysis on 16 GB chips)
TRAIN_MICROBATCHES = {
    "qwen3-32b": 16,
    "gemma3-1b": 16,
    "gemma2-9b": 8,
    "smollm-135m": 16,
    "phi3.5-moe-42b-a6.6b": 8,
    "deepseek-moe-16b": 8,
    "rwkv6-1.6b": 4,
    "qwen2-vl-72b": 32,
    "whisper-medium": 4,
    "zamba2-7b": 8,
}
