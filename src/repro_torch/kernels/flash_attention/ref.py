"""Plain torch versions of the flash attention kernel: the port of
``repro.kernels.flash_attention.ref`` (one head) and the same masked
softmax in the model's layout, with grouped KV heads and a query start
position per batch row (the attention of ``repro.models.transformer``)."""

from __future__ import annotations

import math

import torch

MASKED = -1e30


def _scale(d: int, scale: float) -> float:
    return scale or 1.0 / math.sqrt(d)


def ref_flash_attention(q, k, v, causal: bool = True,
                        scale: float = 0.0) -> torch.Tensor:
    """q: (Sq, D); k, v: (Skv, D) -> (Sq, D). Masked softmax attention."""
    sq, d = q.shape
    skv = k.shape[0]
    logits = (q.to(torch.float32) @ k.to(torch.float32).T) * _scale(d, scale)
    if causal:
        qp = torch.arange(sq, device=q.device)[:, None]
        kp = torch.arange(skv, device=q.device)[None, :]
        logits = torch.where(kp <= qp, logits, MASKED)
    p = torch.softmax(logits, dim=-1)
    return p @ v.to(torch.float32)


def ref_attention_gqa(q, k, v, q_start, causal: bool = True,
                      scale: float = 0.0) -> torch.Tensor:
    """q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D); q_start: (B,) int ->
    (B, Sq, Hq, D) float32.  Query head h reads KV head h // (Hq / Hkv);
    query i of row b sits at position q_start[b] + i, key j at j."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    qg = q.to(torch.float32).reshape(b, sq, hkv, hq // hkv, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg,
                          k.to(torch.float32)) * _scale(d, scale)
    if causal:
        qpos = (q_start.to(torch.long)[:, None]
                + torch.arange(sq, device=q.device)[None, :])
        kpos = torch.arange(skv, device=q.device)
        ok = kpos[None, None, :] <= qpos[:, :, None]           # (B, Sq, Skv)
        logits = torch.where(ok[:, None, None], logits, MASKED)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.to(torch.float32))
    return out.reshape(b, sq, hq, d)
