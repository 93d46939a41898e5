"""Chunked online-softmax ("flash") attention for prefill (port of
``repro.models.flash_attn``).

The reference never materializes more than an (Sq, BLOCK_K) tile of
logits: a scan over KV blocks carries the running max m, the normalizer
l and the output accumulator.  On the card this is one causal
``flash_attention`` launch, whose kernel runs that recurrence itself
(its key chunks in shared memory); the kernel scales the logits after
the product, the reference scales q before it (float32 rounding apart,
the same function).  On the CPU the plain version is the reference's
scan.  The kernel masks by index from one query start a row: query and
key positions must each be start + arange(S) a row, the queries' start
at or past the keys'.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import flash_attention_gqa, soft_cap
from repro_torch.models.layers import query_start

DEFAULT_BLOCK_K = 1024


def _plain(q, k, v, q_positions, kv_positions, window: int, softcap: float,
           scale: float, block_k: int):
    """The reference's scan over KV blocks, float32 throughout."""
    b, sq, hkv, g, dh = q.shape
    skv = k.shape[1]
    while skv % block_k != 0:
        block_k //= 2
    block_k = max(block_k, 1)
    nk = skv // block_k
    f32 = torch.float32
    qf = q.to(f32) * scale
    kb = k.to(f32).reshape(b, nk, block_k, hkv, dh).permute(1, 0, 3, 2, 4)
    vb = v.to(f32).reshape(b, nk, block_k, hkv, dh).permute(1, 0, 3, 2, 4)
    pb = kv_positions.to(torch.long).reshape(b, nk, block_k).permute(1, 0, 2)
    qp = q_positions.to(torch.long)[:, None, None, :, None]
    m = torch.full((b, hkv, g, sq), -math.inf, dtype=f32, device=q.device)
    l = torch.zeros((b, hkv, g, sq), dtype=f32, device=q.device)  # noqa: E741
    acc = torch.zeros((b, hkv, g, sq, dh), dtype=f32, device=q.device)
    for kc, vc, pc in zip(kb, vb, pb):
        logits = torch.einsum("bqhgd,bhkd->bhgqk", qf, kc)
        logits = soft_cap(logits, softcap)
        kp = pc[:, None, None, None, :]
        ok = (kp <= qp) & (kp > qp - window)
        logits = torch.where(ok, logits, -1e30)
        m_new = torch.maximum(m, torch.amax(logits, dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        l = l * alpha + torch.sum(p, dim=-1)                  # noqa: E741
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", p,
                                                    vc)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]           # (B,H,G,Sq,Dh)
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)


def flash_attention(q, k, v, q_positions, kv_positions, window: int,
                    softcap: float, query_scale: float,
                    block_k: int = DEFAULT_BLOCK_K, q_start=None):
    """q: (B, Sq, Hkv, G, Dh); k, v: (B, Skv, Hkv, Dh); positions: (B, Sq)
    / (B, Skv) absolute indices (causal and window masks).  Returns (B,
    Sq, Hkv, G, Dh) in q's type: masked full attention with -1e30 fill.
    ``window`` >= 2^30 is no window.  On the card the kernel masks by
    index: the positions must be start + arange a row, and ``q_start``
    ((B,) int32, each row's first query's offset from its first key) may
    be passed by a caller that has checked them."""
    b, sq, hkv, g, dh = q.shape
    scale = query_scale or 1.0 / math.sqrt(dh)
    if q.device.type == "cpu":
        return _plain(q, k, v, q_positions, kv_positions, window, softcap,
                      scale, block_k)
    skv = k.shape[1]
    # the mask reads only the queries' offsets from the first key
    if q_start is None:
        q_start = query_start(q_positions) - query_start(kv_positions)
        if bool((q_start < 0).any()):
            raise ValueError("flash_attention: a query row starts before "
                             "its first key")
    f32 = torch.float32
    out = flash_attention_gqa(
        q.reshape(b, sq, hkv * g, dh).to(f32), k.to(f32), v.to(f32),
        q_start, causal=True, scale=scale, round_p=False,
        window=window if window < skv else 0, softcap=softcap)
    return out.reshape(b, sq, hkv, g, dh).to(q.dtype)
