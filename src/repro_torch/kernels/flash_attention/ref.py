"""Plain torch versions of the flash attention kernels: the port of
``repro.kernels.flash_attention.ref`` (one head) and the same masked
softmax in the model's layout, with grouped KV heads and a query start
position per batch row (the attention of ``repro.models.transformer``);
its gradient by autograd (``ref_attention_gqa_bwd``, the backward
kernel's plain version); and the kernels' own arithmetic written out
(``emulate_attention``, ``emulate_attention_bwd``), so that the CPU can
test it."""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.quant_matmul.ref import split_bf16x3

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


def _visible(q_start, sq: int, skv: int, device) -> torch.Tensor:
    """(B, Sq, Skv): key j is visible to query i of row b when j <=
    q_start[b] + i."""
    qpos = (q_start.to(torch.long)[:, None]
            + torch.arange(sq, device=device)[None, :])
    kpos = torch.arange(skv, device=device)
    return kpos[None, None, :] <= qpos[:, :, None]


def ref_attention_gqa(q, k, v, q_start, causal: bool = True,
                      scale: float = 0.0,
                      round_p: bool = False) -> torch.Tensor:
    """q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D); q_start: (B,) int ->
    (B, Sq, Hq, D) float32.  Query head h reads KV head h // (Hq / Hkv);
    query i of row b sits at position q_start[b] + i, key j at j.

    The reference model's type rules (``repro.models.transformer``,
    ``_attention_dynwin``): the logits are q . (K rounded to q's type),
    summed in float32; with ``round_p`` the probabilities are rounded to
    V's type before P V (a no-op for float32 V)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    qg = q.to(torch.float32).reshape(b, sq, hkv, hq // hkv, d)
    kq = k.to(q.dtype).to(torch.float32)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, kq) * _scale(d, scale)
    if causal:
        ok = _visible(q_start, sq, skv, q.device)               # (B, Sq, Skv)
        logits = torch.where(ok[:, None, None], logits, MASKED)
    probs = torch.softmax(logits, dim=-1)
    if round_p:
        probs = probs.to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(torch.float32),
                       v.to(torch.float32))
    return out.reshape(b, sq, hq, d)


def ref_attention_gqa_bwd(q, k, v, q_start, dout, causal: bool = True,
                          scale: float = 0.0, round_p: bool = False):
    """(dq, dk, dv) of ``ref_attention_gqa`` against the float32 output
    gradient ``dout``, by autograd: the plain version of the backward
    kernel (``csrc/flash_attention_bwd.cu``).  Each gradient comes back in
    its input's type."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (q, k, v)]
        out = ref_attention_gqa(*ins, q_start, causal, scale, round_p)
        return torch.autograd.grad(out, ins, dout)


def emulate_attention_bwd(q, k, v, q_start, dout, causal: bool = True,
                          scale: float = 0.0, round_p: bool = False):
    """The backward kernel's formulas, in float32 torch: the rows' max M
    and sum L of exponentials, P = exp(s - M) / L, dP = dout . v (rounded
    to bfloat16 with ``round_p`` and a bfloat16 V, and then P too for
    dV), D = rowsum(P dP), dS = P (dP - D) scale; dq = dS K, and dk, dv
    summed over every query head of a KV head's group.  Not the kernel's
    order of sums."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    rnd = round_p and v.dtype == torch.bfloat16
    qf = q.to(torch.float32).reshape(b, sq, hkv, g, d)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    of = dout.to(torch.float32).reshape(b, sq, hkv, g, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * _scale(d, scale)
    if causal:
        ok = _visible(q_start, sq, skv, q.device)[:, None, None]
    else:
        ok = torch.ones_like(s, dtype=torch.bool)
    s = torch.where(ok, s, -torch.inf)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    p = e / e.sum(dim=-1, keepdim=True)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", of, vf)
    if rnd:
        dp = dp.to(torch.bfloat16).to(torch.float32)
    dsum = (p * dp).sum(dim=-1, keepdim=True)
    ds = torch.where(ok, p * (dp - dsum), 0.0) * _scale(d, scale)
    pv = p.to(torch.bfloat16).to(torch.float32) if rnd else p
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf).reshape(b, sq, hq, d)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", pv, of)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _parts(x: torch.Tensor, exact_bf16: bool):
    """The bf16 operands the tensor-core kernel multiplies: x itself when
    it is exact in bf16, else its three bf16 parts (``split_bf16x3``)."""
    if exact_bf16:
        return (x.to(torch.bfloat16),)
    return split_bf16x3(x)


def emulate_attention(q, k, v, q_start, plan, causal: bool = True,
                      scale: float = 0.0,
                      round_p: bool = False) -> torch.Tensor:
    """The kernels' arithmetic under launch plan ``plan`` (``Plan`` of
    ``flash_attention.py``), in float32 torch: every block's rows (query,
    head of the group) against its keys, split across the ranks of its
    cluster by the kernel's own formulas; each rank's partial softmax
    (m, l, acc) merged in rank order, or, with ``round_p`` and bfloat16
    V, two passes (global (M, L) first, then P = exp(s - M) / L rounded
    to V's type).  The ``mma`` variant multiplies bf16 operands: K
    rounded to bf16 for a bfloat16 q; a float32 q and K, P and a float32
    V as their three bf16 parts, each product exact.  It follows the
    kernels' split points and merge order, not the order of the sums
    inside a block."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        block_rows, block_keys)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    sc = _scale(d, scale)
    two_pass = round_p and v.dtype == torch.bfloat16
    out = torch.zeros((b, sq, hq, d), dtype=torch.float32)
    kq = k.to(q.dtype).to(torch.float32)
    vf = v.to(torch.float32)
    starts = [int(s) for s in q_start]
    for bi in range(b):
        for hk in range(hkv):
            for tile in range(plan.tiles):
                rows = block_rows(plan, tile, g, sq)
                if not rows:
                    continue
                qi = torch.tensor([i for i, _ in rows])
                heads = torch.tensor([hk * g + gg for _, gg in rows])
                qt = q[bi, qi, heads].to(torch.float32)          # (R, D)
                ranges = [block_keys(plan, tile, rank, g, sq, skv,
                                     starts[bi], causal)
                          for rank in range(plan.splits)]
                kend = max(r.stop for r in ranges)
                kr = kq[bi, :kend, hk]
                if plan.variant == "mma":   # bf16 parts, exact products
                    q_exact = q.dtype == torch.bfloat16
                    s = sum(a.to(torch.float32) @ c.to(torch.float32).T
                            for a in _parts(qt, q_exact)
                            for c in _parts(kr, q_exact
                                            or k.dtype == torch.bfloat16))
                    s = s * sc                                   # (R, kend)
                else:
                    s = (qt @ kr.T) * sc                         # (R, kend)
                if causal:
                    lim = torch.tensor([starts[bi] + i for i, _ in rows])
                    vis = torch.arange(kend)[None, :] <= lim[:, None]
                    s = torch.where(vis, s, -torch.inf)
                parts = []
                for r in ranges:
                    sr = s[:, r.start:r.stop]
                    m = sr.max(dim=1).values if r.stop > r.start else \
                        torch.full((len(rows),), -torch.inf)
                    e = torch.where(sr == -torch.inf, 0.0,
                                    torch.exp(sr - m[:, None]))
                    parts.append((m, e.sum(dim=1), r))
                big_m = torch.stack([m for m, _, _ in parts]).max(dim=0).values
                fac = [torch.where(m == -torch.inf, 0.0, torch.exp(m - big_m))
                       for m, _, _ in parts]
                big_l = sum(l * f for (_, l, _), f in zip(parts, fac))
                acc = torch.zeros((len(rows), d))
                for (m, _, r), f in zip(parts, fac):
                    sr = s[:, r.start:r.stop]
                    if two_pass:
                        p = torch.where(sr == -torch.inf, 0.0,
                                        torch.exp(sr - big_m[:, None])
                                        / big_l[:, None])
                        p = p.to(v.dtype).to(torch.float32)
                    else:
                        p = torch.where(sr == -torch.inf, 0.0,
                                        torch.exp(sr - m[:, None]))
                    vr = vf[bi, r.start:r.stop, hk]
                    if plan.variant == "mma":
                        term = sum(pp.to(torch.float32) @ vv.to(torch.float32)
                                   for pp in _parts(p, two_pass)
                                   for vv in _parts(vr, v.dtype
                                                    == torch.bfloat16))
                    else:
                        term = p @ vr
                    acc = acc + (term if two_pass else term * f[:, None])
                res = acc if two_pass else acc / big_l[:, None]
                out[bi, qi, heads] = res
    return out
