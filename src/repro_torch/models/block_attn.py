"""Exact block-banded attention for sliding-window (local) layers (port
of ``repro.models.block_attn``).

The reference cuts the sequence into blocks of BS >= W and lets each
query block attend to (previous block, own block): exact for W <= BS,
since any key within W of a query lies in those two blocks, and the
logits shrink from (S, S) to (S, 2 BS).

On the card this is one ``flash_attention`` launch with the window: the
kernel's windowed key ranges visit only the band, which is the same exact
attention.  The kernel masks by index from one query start a row, the
reference by ``positions`` (of queries and keys alike), so positions
other than start + arange(S) raise; so does a block size below the window (the reference then halves
BS under W and its band is narrower than the window: another function
than the kernel's).  On the CPU the plain version is the reference's
blocked computation, float32 throughout.

Used for train/prefill (no cache); decode reads the cache directly.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import flash_attention_gqa, soft_cap
from repro_torch.models.layers import query_start


def block_size(s: int, window: int) -> int:
    """The reference's block size: max(window, 128), halved until it
    divides S; below 16, S itself."""
    bs = max(window, 128)
    while s % bs != 0:
        bs //= 2
        if bs < 16:
            return s
    return bs


def _plain(q, k, v, positions, window: int, softcap: float, scale: float):
    """The reference's blocked computation, float32 throughout."""
    b, s, hkv, g, dh = q.shape
    bs = block_size(s, window)
    nb = s // bs
    f32 = torch.float32
    qb = q.to(f32).reshape(b, nb, bs, hkv, g, dh)
    kb = k.to(f32).reshape(b, nb, bs, hkv, dh)
    vb = v.to(f32).reshape(b, nb, bs, hkv, dh)
    pb = positions.to(torch.long).reshape(b, nb, bs)
    # previous block (zeros, at positions that no query sees, for block 0)
    prev = torch.cat([torch.zeros_like(kb[:, :1]), kb[:, :-1]], dim=1)
    prev_v = torch.cat([torch.zeros_like(vb[:, :1]), vb[:, :-1]], dim=1)
    prev_p = torch.cat([torch.full_like(pb[:, :1], -10 ** 9), pb[:, :-1]],
                       dim=1)
    k2 = torch.cat([prev, kb], dim=2)               # (B, nb, 2BS, Hkv, Dh)
    v2 = torch.cat([prev_v, vb], dim=2)
    p2 = torch.cat([prev_p, pb], dim=2)             # (B, nb, 2BS)
    logits = torch.einsum("bnqhgd,bnkhd->bnhgqk", qb, k2) * scale
    logits = soft_cap(logits, softcap)
    qp = pb[:, :, None, None, :, None]
    kp = p2[:, :, None, None, None, :]
    ok = (kp <= qp) & (kp > qp - window)
    logits = torch.where(ok, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bnhgqk,bnkhd->bnqhgd", probs, v2)
    return out.reshape(b, s, hkv, g, dh).to(q.dtype)


def block_local_attention(q, k, v, positions, window: int, softcap: float,
                          query_scale: float, checked: bool = False):
    """q: (B, S, Hkv, G, Dh); k, v: (B, S, Hkv, Dh); positions: (B, S).

    Returns (B, S, Hkv, G, Dh) in q's type: masked full attention with a
    causal sliding window of ``window`` (exact when the reference's block
    size is at least the window).  On the card the kernel masks by index,
    so the positions must be start + arange(S) a row; ``checked`` says
    the caller has checked that (the transformer does, once a forward).
    Its gradient on the card is the backward kernel's, window and
    soft-cap included."""
    b, s, hkv, g, dh = q.shape
    scale = query_scale or 1.0 / math.sqrt(dh)
    if q.device.type == "cpu":
        return _plain(q, k, v, positions, window, softcap, scale)
    bs = block_size(s, window)
    if bs < window:
        raise NotImplementedError(
            f"block_local_attention: S = {s} gives blocks of {bs} < window "
            f"{window}, where the reference's band is narrower than the "
            f"window; the kernel computes the exact window")
    # queries and keys share the positions: only their offsets matter
    if not checked:
        query_start(positions)
    zero = torch.zeros(b, dtype=torch.int32, device=q.device)
    f32 = torch.float32
    out = flash_attention_gqa(
        q.reshape(b, s, hkv * g, dh).to(f32), k.to(f32), v.to(f32), zero,
        causal=True, scale=scale, round_p=False, window=window,
        softcap=softcap)
    return out.reshape(b, s, hkv, g, dh).to(q.dtype)
