"""Plain torch versions of the flash attention kernels: the port of
``repro.kernels.flash_attention.ref`` (one head) and the same masked
softmax in the model's layout, with grouped KV heads and a query start
position per batch row (the attention of ``repro.models.transformer``);
its gradient by autograd (``ref_attention_gqa_bwd``, the backward
kernel's plain version); the same softmax over one rank's slice of the
keys (``ref_attention_stats``, ``ref_attention_pass2``: the slice forms'
plain versions, for a cache split over its sequence); and the kernels' own
arithmetic written out (``emulate_attention``, ``emulate_attention_bwd``),
so that the CPU can test it.

The forward takes the reference model's sliding window and logit
soft-cap (``src/repro/models/transformer.py``, ``_attention_dynwin``):
with ``window`` > 0 key j is visible to the query at position p when
p - window < j <= p (0 = global: j <= p); with ``softcap`` > 0 the
scaled logits become c * tanh(logits / c) before the mask.  Hidden keys
take the reference's -1e30 and so add exactly 0."""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.quant_matmul.ref import split_bf16x3

MASKED = -1e30
# the backward kernels' tiles by head_dim (``Cfg`` in
# ``csrc/flash_attention_bwd.cu`` up to 64, in
# ``csrc/flash_attention_bwd_wgmma.cuh`` at 112, 128 and 256; the card
# tests of the kernels against ``emulate_attention_bwd`` hold the two to
# each other)
BWD_CHUNK = {16: 64, 32: 64, 64: 64, 112: 64, 128: 64, 256: 64}
                                  # keys a chunk of its rows kernel, in
BWD_KEY_PARTS = {16: 2, 32: 2, 64: 2, 112: 1, 128: 1, 256: 1}
                                  # this many parts with their own statistics
BWD_ROW_TILE = {16: 64, 32: 64, 64: 64, 112: 64, 128: 64, 256: 64}
                                  # rows a tile of its keys kernel,
BWD_ROW_SPLIT = {16: 2, 32: 2, 64: 2, 112: 1, 128: 1, 256: 1}
                                  # summed in this many parts
# The wgmma instances (head_dims 112, 128, 256) sum their products slab by
# slab of the depth: S over slabs of the head dimension of this many
# columns (by q, k, v's type), dP over slabs of 32 (in bfloat16 its last
# one or two slabs, ``bwd_dp_tail``, one slab), the gradients over tiles
# of 64 keys or rows, each slab's sum added in float32 (``_chain``); their
# keys kernel sums dk and dv in the ranks of a cluster
# (``bwd_key_splits``), rank q over the row tiles q, q + S, ... of its key
# tile, the ranks in order.
BWD_WGMMA_SLAB = {torch.float32: 32, torch.bfloat16: 64}
BWD_WGMMA_DP_SLAB = 32
BWD_WGMMA_DIMS = (112, 128, 256)
BWD_WGMMA_TILE = 64          # keys a tile of the keys kernel
CLUSTER_MAX = 8              # a portable cluster's blocks
SMS = 132                    # streaming multiprocessors of an H100 SXM


def bwd_key_splits(b: int, hkv: int, skv: int) -> int:
    """The wgmma backward's keys kernel: blocks of a thread-block cluster
    on each 64-key tile (a power of two, at most 8), while the key tiles
    alone would leave more than half the SMs idle; the cluster's ranks
    take its row tiles in turn and sum their dk, dv in rank order."""
    blocks = b * hkv * -(-skv // BWD_WGMMA_TILE)
    splits = 1
    while splits < CLUSTER_MAX and 2 * blocks * splits <= SMS:
        splits *= 2
    return splits


def bwd_dp_tail(d: int, dtype) -> int:
    """dP's last slabs that the wgmma backward sums as one chain (``NT``
    in ``Cfg``): none in float32, 2 at head_dim 256 and 1 below in
    bfloat16."""
    if dtype == torch.float32:
        return 0
    return 2 if d > 128 else 1


def _scale(d: int, scale: float) -> float:
    return scale or 1.0 / math.sqrt(d)


def check_mask(causal: bool, window: int, softcap: float):
    """Raise for a window without the causal mask it narrows, or a
    negative window or soft-cap."""
    if window < 0 or softcap < 0.0:
        raise ValueError(f"flash attention takes window >= 0 and softcap "
                         f">= 0, got {window}, {softcap}")
    if window and not causal:
        raise ValueError("flash attention: a sliding window needs the "
                         "causal mask")


def soft_cap(logits: torch.Tensor, softcap: float) -> torch.Tensor:
    """c * tanh(logits / c) for c = ``softcap`` > 0 (IEEE division: by a
    tensor, which CUDA does not turn into a product), else the logits."""
    if softcap <= 0.0:
        return logits
    c = logits.new_tensor(softcap)
    return c * torch.tanh(logits / c)


def ref_flash_attention(q, k, v, causal: bool = True, scale: float = 0.0,
                        window: int = 0,
                        softcap: float = 0.0) -> torch.Tensor:
    """q: (Sq, D); k, v: (Skv, D) -> (Sq, D). Masked softmax attention."""
    check_mask(causal, window, softcap)
    sq, d = q.shape
    skv = k.shape[0]
    logits = (q.to(torch.float32) @ k.to(torch.float32).T) * _scale(d, scale)
    logits = soft_cap(logits, softcap)
    if causal:
        start = torch.zeros(1, dtype=torch.int32, device=q.device)
        ok = _visible(start, sq, skv, q.device, window)[0]
        logits = torch.where(ok, logits, MASKED)
    p = torch.softmax(logits, dim=-1)
    return p @ v.to(torch.float32)


def _visible(q_start, sq: int, skv: int, device,
             window: int = 0) -> torch.Tensor:
    """(B, Sq, Skv): key j is visible to query i of row b when j <= p =
    q_start[b] + i and, with a window, j > p - window."""
    qpos = (q_start.to(torch.long)[:, None]
            + torch.arange(sq, device=device)[None, :])
    kpos = torch.arange(skv, device=device)[None, None, :]
    ok = kpos <= qpos[:, :, None]
    if window > 0:
        ok &= kpos > qpos[:, :, None] - window
    return ok


def attention_probs(q, k, q_start, causal: bool = True, scale: float = 0.0,
                    window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """``ref_attention_gqa``'s normalized probabilities P (B, Hkv, G, Sq,
    Skv), float32, before any rounding: exactly 0 at a hidden key."""
    check_mask(causal, window, softcap)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    qg = q.to(torch.float32).reshape(b, sq, hkv, hq // hkv, d)
    kq = k.to(q.dtype).to(torch.float32)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, kq) * _scale(d, scale)
    logits = soft_cap(logits, softcap)
    if causal:
        ok = _visible(q_start, sq, skv, q.device, window)       # (B, Sq, Skv)
        logits = torch.where(ok[:, None, None], logits, MASKED)
    return torch.softmax(logits, dim=-1)


def round_probs(probs: torch.Tensor, dtype) -> torch.Tensor:
    """The normalized probabilities (B, Hkv, G, Sq, Skv) rounded to V's
    type (``round_p``); to e4m3 to nearest even (P lies in [0, 1])."""
    return probs.to(dtype)


def ref_attention_gqa(q, k, v, q_start, causal: bool = True,
                      scale: float = 0.0, round_p: bool = False,
                      window: int = 0,
                      softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D); q_start: (B,) int ->
    (B, Sq, Hq, D) float32.  Query head h reads KV head h // (Hq / Hkv);
    query i of row b sits at position q_start[b] + i, key j at j.

    The reference model's type rules (``repro.models.transformer``,
    ``_attention_dynwin``): the logits are q . (K rounded to q's type),
    summed in float32, scaled, soft-capped, masked; with ``round_p`` the
    probabilities are rounded to V's type before P V (a no-op for float32
    V).  K and V may be float8_e4m3fn (an fp8 cache): they widen exactly,
    and the normalized P, in [0, 1], rounds to e4m3 to nearest even, as
    JAX's ``astype`` rounds it (torch's cast saturates past 448 where JAX
    gives NaN, which no probability reaches).  Without ``round_p`` and
    with a float32 q this is the reference's ``layers._attend`` on such a
    cache: every operand upcast to float32, float32 P."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    probs = attention_probs(q, k, q_start, causal, scale, window, softcap)
    if round_p:
        probs = round_probs(probs, v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(torch.float32),
                       v.to(torch.float32))
    return out.reshape(b, sq, hq, d)


def _slice_logits(q, k, q_start, causal, scale, window, softcap):
    """The scaled, soft-capped logits (B, Hkv, G, Sq, Skv) of q against a
    slice of the keys (key j at position j - q_start's shift), -inf where
    hidden, and the visibility mask."""
    check_mask(causal, window, softcap)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    qg = q.to(torch.float32).reshape(b, sq, hkv, hq // hkv, d)
    kq = k.to(q.dtype).to(torch.float32)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kq) * _scale(d, scale)
    s = soft_cap(s, softcap)
    if causal:
        ok = _visible(q_start, sq, skv, q.device, window)[:, None, None]
    else:
        ok = torch.ones((1, 1, 1, 1, skv), dtype=torch.bool, device=q.device)
    return torch.where(ok, s, -torch.inf), ok


def _rows(x: torch.Tensor) -> torch.Tensor:
    """(B, Hkv, G, Sq) -> (B, Sq, Hq), head h = hk * G + g."""
    b, hkv, g, sq = x.shape
    return x.permute(0, 3, 1, 2).reshape(b, sq, hkv * g)


def _grouped(x: torch.Tensor, hkv: int) -> torch.Tensor:
    """(B, Sq, Hq) -> (B, Hkv, G, Sq, 1)."""
    b, sq, hq = x.shape
    return x.reshape(b, sq, hkv, hq // hkv).permute(0, 2, 3, 1)[..., None]


def ref_attention_stats(q, k, v, q_start, causal: bool = True,
                        scale: float = 0.0, round_p: bool = False,
                        window: int = 0, softcap: float = 0.0):
    """The plain version of ``flash_attention_stats``: k, v one rank's
    slice of the keys, q_start shifted by its first row (may be
    negative).  Returns (out or None, stats (2, B, Sq, Hq) float32): each
    row's M = max of the visible logits and L = sum exp(s - M) over the
    slice (-inf and 0 for a row that sees none of its keys); out = the
    slice's P V normalized by its own L (0 for such a row), None with
    ``round_p`` and a bfloat16 or e4m3 V (two passes)."""
    b, sq, hq, d = q.shape
    s, _ = _slice_logits(q, k, q_start, causal, scale, window, softcap)
    m = s.amax(dim=-1)
    e = torch.where(s == -torch.inf, 0.0, torch.exp(s - m[..., None]))
    l = e.sum(dim=-1)
    stats = torch.stack([_rows(m), _rows(l)]).contiguous()
    if round_p and v.dtype != torch.float32:
        return None, stats
    p = torch.where(l[..., None] > 0, e / l[..., None], 0.0)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(torch.float32))
    return out.reshape(b, sq, hq, d), stats


def ref_attention_pass2(q, k, v, q_start, stats, causal: bool = True,
                        scale: float = 0.0, round_p: bool = False,
                        window: int = 0,
                        softcap: float = 0.0) -> torch.Tensor:
    """The plain version of ``flash_attention_pass2``: given the group's
    (M, L) (``stats``), the slice's sum of P V over its visible keys, P =
    exp(s - M) / L rounded to V's type with ``round_p``."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    s, _ = _slice_logits(q, k, q_start, causal, scale, window, softcap)
    m, l = _grouped(stats[0], hkv), _grouped(stats[1], hkv)
    p = torch.where(s == -torch.inf, 0.0, torch.exp(s - m) / l)
    if round_p:
        p = round_probs(p, v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(torch.float32),
                       v.to(torch.float32))
    return out.reshape(b, sq, hq, d)


def slice_weight(stats: torch.Tensor, big_m: torch.Tensor) -> torch.Tensor:
    """A slice's share of a group's softmax sum: L e^(M - M_group) for its
    (M, L) = ``stats`` and the group's max ``big_m``; exactly 0 for a row
    that saw no key of the slice (L = 0, M = -inf)."""
    m, l = stats[0], stats[1]
    return torch.where(l > 0, l * torch.exp(m - big_m), 0.0)


def group_stats(stats):
    """The group's (M, L) (2, B, Sq, Hq) from each slice's, in slice
    order: M the max, L = sum L_r e^(M_r - M)."""
    big_m = torch.stack([st[0] for st in stats]).amax(dim=0)
    big_l = sum(slice_weight(st, big_m) for st in stats)
    return torch.stack([big_m, big_l]).contiguous()


def ref_attention_gqa_bwd(q, k, v, q_start, dout, causal: bool = True,
                          scale: float = 0.0, round_p: bool = False,
                          window: int = 0, softcap: float = 0.0):
    """(dq, dk, dv) of ``ref_attention_gqa`` against the float32 output
    gradient ``dout``, by autograd: the plain version of the backward
    kernel (``csrc/flash_attention_bwd.cu``).  Each gradient comes back in
    its input's type."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (q, k, v)]
        out = ref_attention_gqa(*ins, q_start, causal, scale, round_p,
                                window, softcap)
        return torch.autograd.grad(out, ins, dout)


# The part products the backward kernel issues for two operands of (up to)
# three bf16 parts each, (a part, b part), in its order: 6 of the 9, those
# whose weight reaches float32 rounding (mid.lo, lo.mid, lo.lo are below
# 2^-26 of |a||b|).  With one part on a side, the pairs that exist.
PAIRS = ((0, 2), (1, 1), (0, 1), (2, 0), (1, 0), (0, 0))


def _mma(a_parts, b_parts):
    """sum over k of A[..., m, k] B[..., k, n] from A's and B's bf16 parts
    (``_parts``), as the backward kernel's tensor cores sum it: 16-deep
    steps in order, each the sum of the kept part products (``PAIRS``)
    added to the float32 total."""
    a_parts = [p.to(torch.float32) for p in a_parts]
    b_parts = [p.to(torch.float32) for p in b_parts]
    depth = a_parts[0].shape[-1]
    acc = None
    for k0 in range(0, depth, 16):
        t = None
        for pa, pb in PAIRS:
            if pa < len(a_parts) and pb < len(b_parts):
                x = a_parts[pa][..., k0:k0 + 16] @ b_parts[pb][..., k0:k0 + 16, :]
                t = x if t is None else t + x
        acc = t if acc is None else acc + t
    return acc


def _chain(a_parts, b_parts, slab: int, tail: int = 0):
    """sum over k of A[..., m, k] B[..., k, n] as the wgmma kernels chain
    it: slab by slab of ``slab`` deep (the last ``tail`` slabs as one),
    each slab's kept part products (``PAIRS``) summed (on the tensor
    cores, in an order this does not follow) and added to the float32
    total."""
    a_parts = [p.to(torch.float32) for p in a_parts]
    b_parts = [p.to(torch.float32) for p in b_parts]
    depth = a_parts[0].shape[-1]
    cut = (-(-depth // slab) - tail) * slab if tail else depth
    bounds = [(s0, min(s0 + slab, cut)) for s0 in range(0, cut, slab)]
    if tail:
        bounds.append((cut, depth))
    acc = None
    for s0, s1 in bounds:
        t = None
        for pa, pb in PAIRS:
            if pa >= len(a_parts) or pb >= len(b_parts):
                continue
            x = a_parts[pa][..., s0:s1] @ b_parts[pb][..., s0:s1, :]
            t = x if t is None else t + x
        acc = t if acc is None else acc + t
    return acc


def emulate_attention_bwd(q, k, v, q_start, dout, causal: bool = True,
                          scale: float = 0.0, round_p: bool = False,
                          window: int = 0, softcap: float = 0.0):
    """The backward kernel's arithmetic (``csrc/flash_attention_bwd.cu``),
    in float32 torch.  Every product runs on bf16 parts (``_mma``): a
    bfloat16 q, k, v as itself, a float32 one, dout, P and dS as three
    parts, P rounded to bfloat16 (``round_p`` with a bfloat16 V) as
    itself, with the kernel's kept part products, 16 deep at a time.  The
    rows r = i * G + g of a KV head walk the keys in the rows kernel's
    chunks (``BWD_CHUNK``), each of the ``BWD_KEY_PARTS`` parts of a chunk
    with its own online max m, sum l of exp(s - m) and d = sum exp(s - m)
    dP, rescaled as m grows; the parts merge (part 0 first) into M, L and
    D = d / L.  Then P = exp(s - M) / L, dP = dout . v (rounded to
    bfloat16 with ``round_p`` and a bfloat16 V), dS = P (dP - D), taken
    through the soft-cap's derivative (x c, x (1 - t^2), / c) and scaled;
    dq = dS K summed per key part and then part 0 + part 1, and dk = dS^T
    q, dv = P^T dout over the rows in order (every query head of the
    group), in ``BWD_ROW_SPLIT`` parts of each ``BWD_ROW_TILE`` rows,
    added part 0 first.  At head_dims 112, 128 and 256 (the wgmma
    kernels) a chunk and a tile are 64 keys or rows in one part, and each
    product is chained slab by slab (``_chain``: ``BWD_WGMMA_SLAB``
    columns for S and dP, 64 keys or rows for the gradients).  The logits
    are soft-capped (c tanh(s / c)) and masked (the causal mask and the
    window) as the forward's.  It follows the kernels' parts, products,
    chunks, key parts and order of 16-deep steps, not the order of the
    sums inside a step or across a chunk's lanes.  Chunks or row tiles the
    kernels skip (outside every row's window) add exact zeros here."""
    check_mask(causal, window, softcap)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    sc = _scale(d, scale)
    rnd = round_p and v.dtype == torch.bfloat16
    exact = q.dtype == torch.bfloat16     # q, k, v are one part each

    def rows(x):   # (B, Sq, Hq, D) -> (B, Hkv, Sq * G, D), r = i * G + g
        return (x.to(torch.float32).reshape(b, sq, hkv, g, d)
                .permute(0, 2, 1, 3, 4).reshape(b, hkv, sq * g, d))

    wide = d in BWD_WGMMA_DIMS
    if wide:
        slab = BWD_WGMMA_SLAB[q.dtype]

        def mm_s(a, b_):
            return _chain(a, b_, slab)

        def mm_dp(a, b_):
            return _chain(a, b_, BWD_WGMMA_DP_SLAB, bwd_dp_tail(d, q.dtype))

        def mm_g(a, b_):
            return _chain(a, b_, 64)
    else:
        mm_s = mm_dp = mm_g = _mma
    qp, op = _parts(rows(q), exact), _parts(rows(dout), False)
    kp = _parts(k.to(torch.float32).permute(0, 2, 1, 3), exact)
    vp = _parts(v.to(torch.float32).permute(0, 2, 1, 3), exact)
    s = mm_s(qp, [x.transpose(-1, -2) for x in kp]) * sc    # (B, Hkv, R, Skv)
    t = None
    if softcap > 0.0:
        c = s.new_tensor(softcap)
        t = torch.tanh(s / c)
        s = c * t
    dp = mm_dp(op, [x.transpose(-1, -2) for x in vp])
    if rnd:
        dp = dp.to(torch.bfloat16).to(torch.float32)
    if causal:
        ok = _visible(q_start, sq, skv, q.device, window)    # (B, Sq, Skv)
        ok = ok.repeat_interleave(g, dim=1)[:, None]         # (B, 1, R, Skv)
    else:
        ok = torch.ones((1, 1, 1, skv), dtype=torch.bool, device=q.device)
    s = torch.where(ok, s, -torch.inf)
    parts = BWD_KEY_PARTS[d]
    width = BWD_CHUNK[d] // parts
    stats = []                       # each key part's (m, l, d) over chunks
    for h in range(parts):
        m = torch.full(s.shape[:-1], -torch.inf, device=q.device)
        l = torch.zeros(s.shape[:-1], device=q.device)
        dsum = torch.zeros(s.shape[:-1], device=q.device)
        for c0 in range(h * width, skv, parts * width):
            sc_, dpc = s[..., c0:c0 + width], dp[..., c0:c0 + width]
            mn = torch.maximum(m, sc_.amax(dim=-1))
            f = torch.where(m == -torch.inf, 0.0, torch.exp(m - mn))
            e = torch.where(sc_ == -torch.inf, 0.0,
                            torch.exp(sc_ - mn[..., None]))
            l = l * f + e.sum(dim=-1)
            dsum = dsum * f + (e * dpc).sum(dim=-1)
            m = mn
        stats.append((m, l, dsum))
    m = stats[0][0]
    for mh, _, _ in stats[1:]:
        m = torch.maximum(m, mh)
    fs = [torch.where(mh == -torch.inf, 0.0, torch.exp(mh - m))
          for mh, _, _ in stats]
    l = stats[0][1] * fs[0]
    big_d = stats[0][2] * fs[0]
    for (_, lh, dh), f in zip(stats[1:], fs[1:]):
        l = l + lh * f
        big_d = big_d + dh * f
    big_d = big_d / l
    p = torch.where(ok, torch.exp(s - m[..., None]) / l[..., None], 0.0)
    ds = p * (dp - big_d[..., None])
    if t is not None:
        ds = ds * c * (1.0 - t * t) / c
    ds = torch.where(ok, ds * sc, 0.0)
    pv = p.to(torch.bfloat16).to(torch.float32) if rnd else p
    in_part = (torch.arange(skv, device=q.device) // width) % parts
    dq = sum(mm_g(_parts(torch.where(in_part == h, ds, 0.0), False), kp)
             for h in range(parts))                          # (B, Hkv, R, D)
    tile, split = BWD_ROW_TILE[d], BWD_ROW_SPLIT[d]
    if wide:    # (B, 1, R, Skv): the cluster rank that sums a (row, key)
        split = bwd_key_splits(b, hkv, skv)
        r_tile = torch.arange(sq * g, device=q.device)[:, None] // tile
        j0 = (torch.arange(skv, device=q.device) // tile * tile)[None, :]
        starts = (q_start.to(torch.long) if causal else
                  torch.zeros(b, dtype=torch.long, device=q.device))
        seen = ((j0[None] - starts[:, None, None]).clamp(min=0) * g
                if causal else torch.zeros_like(j0)[None].expand(b, 1, skv))
        first = seen.clamp(max=sq * g) // tile               # (B, 1, Skv)
        part = ((r_tile[None] - first) % split)[:, None]
    else:
        part = ((torch.arange(sq * g, device=q.device) % tile)
                // (tile // split))[:, None]
    dk = dv = 0
    for h in range(split):                                  # (B, Hkv, Skv, D)
        in_split = part == h
        dk = dk + mm_g(_parts(torch.where(in_split, ds, 0.0).transpose(-1, -2),
                              False), qp)
        dv = dv + mm_g(_parts(torch.where(in_split, pv, 0.0).transpose(-1, -2),
                              rnd), op)
    dq = dq.reshape(b, hkv, sq, g, d).permute(0, 2, 1, 3, 4).reshape(
        b, sq, hq, d)
    dk, dv = dk.permute(0, 2, 1, 3), dv.permute(0, 2, 1, 3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _parts(x: torch.Tensor, exact_bf16: bool):
    """The bf16 operands the tensor-core kernel multiplies: x itself when
    it is exact in bf16, else its three bf16 parts (``split_bf16x3``)."""
    if exact_bf16:
        return (x.to(torch.bfloat16),)
    return split_bf16x3(x)


def emulate_attention(q, k, v, q_start, plan, causal: bool = True,
                      scale: float = 0.0, round_p: bool = False,
                      window: int = 0, softcap: float = 0.0,
                      mode: int = 0, stats=None):
    """The kernels' arithmetic under launch plan ``plan`` (``Plan`` of
    ``flash_attention.py``), in float32 torch: every block's rows (query,
    head of the group) against its keys, split across the ranks of its
    cluster by the kernel's own formulas; each rank's partial softmax
    (m, l, acc) merged in rank order, or, with ``round_p`` and a bfloat16
    or e4m3 V, two passes (global (M, L) first, then P = exp(s - M) / L
    rounded to V's type).  The ``mma`` and ``wgmma`` variants multiply
    bf16 operands: K rounded to bf16 for a bfloat16 q, and e4m3 K and V,
    as one exact part; a float32 q and K, P and a float32 V as their
    three bf16 parts, each product exact.  It follows the
    kernels' split points and merge order, not the order of the sums
    inside a block.  A window starts each block's keys at the first one
    its first row sees (``block_keys``), and a soft-cap takes the scaled
    logits through c * tanh(s / c) before the mask.

    ``mode`` 1 and 2 are the slice forms (``flash_attention_stats``,
    ``flash_attention_pass2``: k, v a slice of the keys, q_start shifted,
    possibly negative).  Mode 1 returns (out or None, stats (2, B, Sq,
    Hq)): the merged (M, L) of each row (-inf, 0 where it sees no key)
    and, without two passes, acc / L (0 for such a row).  Mode 2 takes
    the group's (M, L) from ``stats`` and returns the second pass's P V
    (P rounded with ``round_p``)."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        block_rows, block_keys)
    check_mask(causal, window, softcap)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    sc = _scale(d, scale)
    rnd = round_p and v.dtype != torch.float32     # P rounded to V's type
    two_pass = rnd or mode == 2
    out = torch.zeros((b, sq, hq, d), dtype=torch.float32)
    new_stats = torch.zeros((2, b, sq, hq), dtype=torch.float32)
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
                                     starts[bi], causal, window)
                          for rank in range(plan.splits)]
                kend = max(r.stop for r in ranges)
                kr = kq[bi, :kend, hk]
                if plan.variant != "split":   # bf16 parts, exact products
                    q_exact = q.dtype == torch.bfloat16
                    s = sum(a.to(torch.float32) @ c.to(torch.float32).T
                            for a in _parts(qt, q_exact)
                            for c in _parts(kr, q_exact
                                            or k.dtype != torch.float32))
                    s = s * sc                                   # (R, kend)
                else:
                    s = (qt @ kr.T) * sc                         # (R, kend)
                s = soft_cap(s, softcap)
                if causal:
                    lim = torch.tensor([starts[bi] + i for i, _ in rows])
                    kpos = torch.arange(kend)[None, :]
                    vis = kpos <= lim[:, None]
                    if window > 0:
                        vis &= kpos > lim[:, None] - window
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
                if mode == 1:
                    new_stats[0, bi, qi, heads] = big_m
                    new_stats[1, bi, qi, heads] = big_l
                    if rnd:
                        continue
                elif mode == 2:
                    big_m, big_l = stats[0, bi, qi, heads], stats[1, bi, qi,
                                                                  heads]
                acc = torch.zeros((len(rows), d))
                for (m, _, r), f in zip(parts, fac):
                    sr = s[:, r.start:r.stop]
                    if two_pass:
                        p = torch.where(sr == -torch.inf, 0.0,
                                        torch.exp(sr - big_m[:, None])
                                        / big_l[:, None])
                        if round_p:
                            p = p.to(v.dtype).to(torch.float32)
                    else:
                        p = torch.where(sr == -torch.inf, 0.0,
                                        torch.exp(sr - m[:, None]))
                    vr = vf[bi, r.start:r.stop, hk]
                    if plan.variant != "split":
                        term = sum(pp.to(torch.float32) @ vv.to(torch.float32)
                                   for pp in _parts(p, rnd)
                                   for vv in _parts(vr, v.dtype
                                                    != torch.float32))
                    else:
                        term = p @ vr
                    acc = acc + (term if two_pass else term * f[:, None])
                res = acc if two_pass else torch.where(
                    big_l[:, None] > 0, acc / big_l[:, None], 0.0)
                out[bi, qi, heads] = res
    if mode == 1:
        return (None if rnd else out), new_stats
    return out
