"""Shared model layers with quantization hooks (port of the parts of
``repro.models.layers`` that the serving and training paths run).

Every dense projection goes through ``qdense`` so a model runs under any
of the paper's PE-type numerics (QuantConfig), or on packed weight codes.
Params are plain nested dicts of tensors, keyed like the reference's
pytree; init functions draw from a ``torch.Generator``.

The unified ``attention`` (bidirectional, causal with a KV cache, and
cross attention over encoder states: the encoder-decoder family's) ends
on the ``flash_attention`` kernel for CUDA tensors.  The mixed-precision
context ``compute_dtype`` makes ``qdense`` cast both operands after the
fake quantization.  The launcher's mesh context
(``activation_sharding``, kept in ``launch.mesh``) tells the EP MoE
layer its mesh; each rank already holds its slice of the batch, so
``shard_batch`` places nothing.

``remat`` is the reference's ``jax.checkpoint`` of a layer: while a
gradient is being taken the layer keeps only its inputs, and its
backward runs the layer's forward again.

Under the tensor-parallel split (``launch.mesh.current_split``) a
projection takes ``split=``: "col" for a weight whose output columns
the ``model`` group splits (its activation replicated), "row" for one
whose input rows it splits (its activation the rank's slice, its
product a partial sum); the quantization scales then span the group
where the reference's span the logical tensor, and packed codes take
the rank's columns of their replicated per-channel scales; "tokens" for
a weight and an activation every rank holds whole (a layer the split
leaves whole), whose weight gradient each rank takes over its slice of
the tokens, summed over the group.  ``attention`` splits its heads
(``sharding.attn_heads``), ``mlp`` its hidden columns, ``rmsnorm(...,
split=True)`` a norm over the group's columns; ``embed_rows``,
``head_logits``, ``softmax_xent`` and ``greedy_tokens`` split the
vocabulary.

Under a serving cache split over its sequence (``launch.mesh.current_seq``)
``seq_attention`` attends over the rank's slice of the keys and combines
the softmax across the group.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Dict

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import (flash_attention_gqa,
                                                 flash_attention_pass2,
                                                 flash_attention_stats,
                                                 two_passes)
from repro_torch.kernels.flash_attention.ref import slice_weight
from repro_torch.kernels.quant_matmul import quant_matmul
from repro_torch.launch.mesh import (  # noqa: F401  (the reference's names)
    activation_sharding, copy_to_model, current_dp, current_mesh,
    current_split, gather_from_model, in_context, model_max,
    reduce_from_model, saved_context)
from repro_torch.launch.sharding import attn_heads
from repro_torch.quant.fake_quant import fake_quant_act, fake_quant_weight
from repro_torch.quant.pack import DEQUANTIZE
from repro_torch.quant.qconfig import QuantConfig

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# mixed-precision context
# ---------------------------------------------------------------------------

_ctx = threading.local()


@contextlib.contextmanager
def compute_dtype(dtype):
    """Mixed-precision context: ``qdense`` casts weights and activations
    to ``dtype`` after their fake quantization, before the product (the
    float32 master weights stay with the optimizer).  None = full
    precision.  The reference's launcher sets it from the config's
    ``mixed_precision``."""
    old = getattr(_ctx, "dtype", None)
    _ctx.dtype = dtype
    try:
        yield
    finally:
        _ctx.dtype = old


def current_compute_dtype():
    """The innermost ``compute_dtype``'s type, or None."""
    return getattr(_ctx, "dtype", None)


# ---------------------------------------------------------------------------
# the launcher's mesh context (kept in ``launch.mesh``)
# ---------------------------------------------------------------------------

def shard_batch(x: torch.Tensor) -> torch.Tensor:
    """The reference constrains dim 0 onto the dp axes here; each rank of
    the port already holds its slice of the batch, so x is returned."""
    return x


def remat(fn, *args):
    """``fn(*args)``; while a gradient is being taken (grad mode on and an
    input or a captured param that needs one), through
    ``torch.utils.checkpoint`` (non-reentrant): the activations inside
    ``fn`` are not kept but computed again in the backward, as the
    reference's ``jax.checkpoint`` rematerializes a layer.  Every kernel
    is deterministic and the layers draw no random numbers, so the values
    and gradients are those of ``fn(*args)``.  The recomputation runs
    under the forward's mixed-precision and mesh contexts (autograd may
    run it on a thread of its own, where the thread-local contexts are
    unset)."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in torch.utils._pytree.tree_flatten(args)[0]):
        from torch.utils.checkpoint import checkpoint
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False,
                          context_fn=_recompute_contexts)
    return fn(*args)


def _recompute_contexts():
    """(the forward's context, the recomputation's): the latter sets the
    forward's compute type and mesh context again, and restores the
    thread's own after."""
    dtype, mesh = current_compute_dtype(), saved_context()

    @contextlib.contextmanager
    def again():
        with compute_dtype(dtype), in_context(mesh):
            yield

    return contextlib.nullcontext(), again()


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def randn(gen: torch.Generator, shape, device) -> torch.Tensor:
    """N(0, 1) float32 from ``gen`` (drawn on the generator's device),
    on ``device``.  On ``meta`` nothing is drawn: the tensor has a shape
    and a type only (the templates of a restore, the sharding rules)."""
    device = resolve_device(device)
    if device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device=device)
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device).to(device)



def dense_init(gen, d_in: int, d_out: int, dtype=torch.float32, device=None):
    return (randn(gen, (d_in, d_out), device) / math.sqrt(d_in)).to(dtype)


def embed_init(gen, vocab: int, d: int, dtype=torch.float32, device=None):
    return (randn(gen, (vocab, d), device) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# quant-hooked dense
# ---------------------------------------------------------------------------

def packed_mode(w: dict):
    """(mode, key) of a packed leaf {"codes__<mode>": ..., "scale": ...}."""
    for key in w:
        if key.startswith("codes__"):
            return key.split("__", 1)[1], key
    return None, None


def qdense(x: torch.Tensor, w, qcfg: QuantConfig, cast=None,
           split=None) -> torch.Tensor:
    """x @ w under the QuantConfig numerics (QAT fake-quant, STE grads).

    w may be a packed-code dict {"codes__<mode>": codes, "scale": scale}
    (the serving path).  With an identity ``qcfg`` the ``quant_matmul``
    kernel reads the codes themselves; otherwise they are dequantized,
    fake-quantized and multiplied, as in the reference.  A dense product
    promotes the two types as JAX does (bf16 x with float32 w is a
    float32 product).  ``cast`` (else the ``compute_dtype`` context's
    type) casts x and w after the fake quantization, before the product;
    on packed codes the kernel takes a bfloat16 cast itself (each
    dequantized weight rounded to bfloat16, as the reference rounds code
    x scale), and a float32 one is its float32 product.

    ``split`` (None, "col", "row" or "tokens"): how the ``model`` group
    splits w under the tensor-parallel split (the module docstring).
    """
    ct = cast if cast is not None else current_compute_dtype()
    if isinstance(w, dict):
        mode, key = packed_mode(w)
        codes, scale = w[key], w["scale"]
        if scale.shape[-1] != codes.shape[-1]:
            # column-split codes: the rank's slice of the replicated scale
            n, at = codes.shape[-1], current_split().rank
            scale = scale[..., at * n:(at + 1) * n]
        if qcfg.is_identity:
            if codes.ndim != 2:
                raise ValueError(f"qdense takes one layer's codes, got "
                                 f"{tuple(codes.shape)}: index the layer")
            if ct not in (None, torch.float32, torch.bfloat16):
                raise NotImplementedError(
                    f"qdense: packed weight codes under a {ct} compute "
                    f"type (the kernel casts to bfloat16 only)")
            y = quant_matmul(x.reshape(-1, x.shape[-1]).contiguous(), codes,
                             scale, mode=mode,
                             cast=ct if ct == torch.bfloat16 else None)
            return y.reshape(*x.shape[:-1], y.shape[-1])
        w = DEQUANTIZE[mode](codes, scale)
    if not qcfg.is_identity and split in (None, "tokens"):
        w = fake_quant_weight(w, qcfg)
        x = fake_quant_act(x, qcfg)
    elif not qcfg.is_identity:
        w = fake_quant_weight(w, qcfg, split)
        x = fake_quant_act(x, qcfg, split == "row")
    dt = ct if ct is not None else torch.promote_types(x.dtype, w.dtype)
    x, w = x.to(dt), w.to(dt)
    if split == "tokens" and torch.is_grad_enabled() and w.requires_grad:
        return _TokenSplitGrad.apply(x, w, current_split())
    return torch.matmul(x, w)


class _TokenSplitGrad(torch.autograd.Function):
    """x @ w for a weight and an activation that every rank of the model
    group holds whole (a layer the split leaves whole): the gradient of x
    in full, that of w summed over the group from each rank's slice of
    the tokens (rows of x), so no rank computes the whole contraction."""

    @staticmethod
    def forward(ctx, x, w, split):
        ctx.save_for_backward(x, w)
        ctx.split = split
        return torch.matmul(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        split = ctx.split
        dx = torch.matmul(g, w.transpose(-1, -2)) \
            if ctx.needs_input_grad[0] else None
        x2 = x.reshape(-1, x.shape[-1])
        g2 = g.reshape(-1, g.shape[-1])
        t = x2.shape[0]
        if t % split.size:
            return dx, x2.transpose(0, 1) @ g2, None
        rows = slice(split.rank * t // split.size,
                     (split.rank + 1) * t // split.size)
        dw = x2[rows].transpose(0, 1) @ g2[rows]
        dist.all_reduce(dw, group=split.group)
        return dx, dw, None


def replicated_leaves(p: Params, names) -> Params:
    """The replicated leaves ``names`` of ``p`` entering a split region,
    where each rank uses them for its own heads or columns alone: their
    gradients summed over the group (``copy_to_model``)."""
    return {n: copy_to_model(p[n]) for n in names}


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
            zero_centered: bool = False, split: bool = False) -> torch.Tensor:
    """RMSNorm over x's last axis in float32.  ``split``: x and ``scale``
    hold the rank's columns of a norm over the model group's (the mean
    square summed over the group)."""
    dt = x.dtype
    x = x.to(torch.float32)
    group = current_split() if split else None
    if group:
        # summed over the group, and used for the rank's columns: its
        # gradient, each rank's part, summed too
        total = copy_to_model(reduce_from_model(torch.sum(
            torch.square(x), dim=-1, keepdim=True)))
        var = torch.div(total, torch.tensor(float(x.shape[-1] * group.size),
                                            device=x.device))
    else:
        var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    g = 1.0 + scale if zero_centered else scale  # gemma uses (1 + g)
    return (x * g).to(dt)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in float32 with the biased variance (``jnp.var``)."""
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    return ((x - mu) * torch.rsqrt(var + eps) * scale + bias).to(dt)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=resolve_device(device)) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (B, S) int."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].to(torch.float32) * freqs   # (B, S, Dh/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor,
                sections=(16, 24, 24), theta: float = 10000.0) -> torch.Tensor:
    """Multi-axis RoPE (qwen2-vl): positions (B, S, 3) = (t, h, w) ids.

    The Dh/2 frequency slots are split into ``sections`` groups, each
    rotated by its own position stream.
    """
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to "
                         f"head_dim / 2 = {half}")
    freqs = rope_freqs(x.shape[-1], theta, x.device)   # (half,)
    pos = positions.to(torch.float32)                  # (B, S, 3)
    parts, off = [], 0
    for s_idx, width in enumerate(sections):
        parts.append(pos[..., s_idx:s_idx + 1]
                     * freqs[off:off + width][None, None, :])
        off += width
    ang = torch.cat(parts, dim=-1)                     # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# unified attention, its parameters and cache
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnSpec:
    n_heads: int
    kv_heads: int
    head_dim: int
    causal: bool = True
    window: int = 0             # 0 = global; >0 = sliding window width
    softcap: float = 0.0        # 0 = off (gemma2 uses 50.0)
    qk_norm: bool = False       # qwen3 per-head RMSNorm on q, k
    rope_theta: float = 10000.0
    mrope_sections: tuple = ()  # non-empty -> M-RoPE
    query_scale: float = 0.0    # 0 -> 1/sqrt(head_dim)


def attn_init(gen, d_model: int, spec: AttnSpec, dtype=torch.float32,
              device=None) -> Params:
    p = {
        "wq": dense_init(gen, d_model, spec.n_heads * spec.head_dim, dtype,
                         device),
        "wk": dense_init(gen, d_model, spec.kv_heads * spec.head_dim, dtype,
                         device),
        "wv": dense_init(gen, d_model, spec.kv_heads * spec.head_dim, dtype,
                         device),
        "wo": dense_init(gen, spec.n_heads * spec.head_dim, d_model, dtype,
                         device),
    }
    if spec.qk_norm:
        p["q_norm"] = torch.ones(spec.head_dim, dtype=dtype,
                                 device=resolve_device(device))
        p["k_norm"] = torch.ones(spec.head_dim, dtype=dtype,
                                 device=resolve_device(device))
    return p


def _attend(q, k, v, spec: AttnSpec, q_start, mask_mode: str):
    """Core attention, all of it in float32 with float32 P (the
    reference's ``_attend``).  q: (B, Sq, Hq, Dh); k, v: (B, Skv, Hkv,
    Dh).  mask_mode "causal": query i of row b sits at q_start[b] + i and
    sees keys 0 .. that position (and its window); "full": every key
    (bidirectional / cross).  One ``flash_attention`` launch on the card.
    An fp8 cache goes to the kernel as it is (its codes widen exactly in
    the kernel, as in the plain version's upcast): no float32 copy of the
    whole cache a step."""
    f32 = torch.float32
    if k.dtype != FP8:
        k, v = k.to(f32), v.to(f32)
    out = flash_attention_gqa(
        q.to(f32), k, v, q_start,
        causal=mask_mode == "causal",
        scale=spec.query_scale or 1.0 / math.sqrt(q.shape[-1]),
        round_p=False, window=spec.window, softcap=spec.softcap)
    return out.to(q.dtype)


def query_start(positions: torch.Tensor) -> torch.Tensor:
    """(B,) int32 position of each row's first query, from (B, S)
    positions (M-RoPE: stream 0) that must be start + arange(S) per row:
    the kernel masks by index from one start a row.  ``meta`` positions
    hold no values to check."""
    pos2d = positions if positions.ndim == 2 else positions[..., 0]
    q_start = pos2d[:, 0].to(torch.int32).contiguous()
    ar = torch.arange(pos2d.shape[1], device=pos2d.device)
    if pos2d.device.type != "meta" and not torch.equal(
            pos2d.to(torch.long), q_start.to(torch.long)[:, None] + ar[None]):
        raise ValueError("positions must be start + arange(S) on every row")
    return q_start


def seq_attention(q, k, v, q_start, group, *, causal: bool = True,
                  scale: float = 0.0, round_p: bool = False, window: int = 0,
                  softcap: float = 0.0, reduce: bool = True) -> torch.Tensor:
    """The attention of q over the keys of every rank of ``group``
    (``launch.mesh.SeqGroup``, or any object with its in-place ``max`` and
    ``sum``), of which k and v are this rank's slice and q_start the
    queries' positions less the slice's first row.  Every rank returns the
    group's (B, Sq, Hq, D) float32 result.

    The slice's (M, L) (``flash_attention_stats``), the group's M = max of
    the ranks', each rank's weight w = L e^(M_r - M) and the group's L = sum
    w.  Where P is not rounded (a float32 cache) that is one pass: the
    slice's output, normalized by its own L, times w / L, summed over the
    group.  With ``round_p`` on a bfloat16 or e4m3 cache P = exp(s - M) / L
    must be rounded with the group's (M, L): a second pass over the slice
    (``flash_attention_pass2``), its P V summed over the group.  Three
    all-reduces: the max, the sum of w, the outputs; without ``reduce``
    the rank's partial output is returned unsummed (the caller sums the
    part it keeps)."""
    opts = dict(causal=causal, scale=scale, round_p=round_p, window=window,
                softcap=softcap)
    out, stats = flash_attention_stats(q, k, v, q_start, **opts)
    big_m = group.max(stats[0].clone())
    w = slice_weight(stats, big_m)
    if two_passes(round_p, v):
        big_l = group.sum(w)
        out = flash_attention_pass2(q, k, v, q_start,
                                    torch.stack([big_m, big_l]), **opts)
    else:
        big_l = group.sum(w.clone())
        out = out * torch.div(w, big_l)[..., None]
    return group.sum(out) if reduce else out


def attention(params: Params, x: torch.Tensor, spec: AttnSpec,
              qcfg: QuantConfig, positions: torch.Tensor,
              cache: Params | None = None,
              cross_kv: torch.Tensor | None = None,
              mask_mode: str = "causal", q_start=None):
    """Unified attention layer (the reference's ``layers.attention``).

    x: (B, S, D). positions: (B, S) (or (B, S, 3) for M-RoPE), of the
    form start + arange(S) a row; ``q_start`` ((B,) int32, their first
    column) may be passed to skip that check.  cache: None, or
    ``make_cache``'s dict, written in place at its index (clamped as
    ``dynamic_update_slice`` clamps it) and attended over all its rows
    under the causal mask.  cross_kv: (B, Senc, D) encoder states: K and V
    come from them, no RoPE, every key visible.  Returns (out, cache).

    Under the tensor-parallel split the rank computes its heads
    (``sharding.attn_heads``): ``wq`` / ``wo`` hold its columns / rows
    where the group divides the query heads, ``wk`` / ``wv`` its columns
    where it divides the KV heads too (else every KV head, of which its
    queries read their own), and a cache the rank's KV heads where the
    rules split them; x and the replicated leaves enter the split region
    (``copy_to_model``) and the outputs' partial sums leave it
    (``reduce_from_model``).  A layer left whole takes its weight
    gradients over the rank's tokens."""
    b, s, _ = x.shape
    dh = spec.head_dim
    split = current_split()
    heads = attn_heads(spec.n_heads, spec.kv_heads, spec.kv_heads, split)
    hq = heads.q
    hkv = spec.kv_heads // (split.size if heads.kv_split else 1)
    whole = "tokens" if split and not heads.q_split else None
    kv_src = cross_kv if cross_kv is not None else x
    if heads.q_split:
        own = ("wq", "wo", *(("wk", "wv") if heads.kv_split else ()))
        params = {n: copy_to_model(w) if torch.is_tensor(w) and n not in own
                  else w for n, w in params.items()}
        x = copy_to_model(x)
        kv_src = copy_to_model(kv_src) if cross_kv is not None else x
    q = qdense(x, params["wq"], qcfg, split="col" if heads.q_split
               else whole).reshape(b, s, hq, dh)
    kv_col = "col" if heads.kv_split else whole
    k = qdense(kv_src, params["wk"], qcfg, split=kv_col).reshape(
        b, kv_src.shape[1], hkv, dh)
    v = qdense(kv_src, params["wv"], qcfg, split=kv_col).reshape(
        b, kv_src.shape[1], hkv, dh)
    if spec.qk_norm:
        q = rmsnorm(q, params["q_norm"])
        k = rmsnorm(k, params["k_norm"])
    pos2d = positions if positions.ndim == 2 else positions[..., 0]
    if cross_kv is None:
        if spec.mrope_sections:
            q = apply_mrope(q, positions, spec.mrope_sections,
                            spec.rope_theta)
            k = apply_mrope(k, positions, spec.mrope_sections,
                            spec.rope_theta)
        else:
            q = apply_rope(q, pos2d, spec.rope_theta)
            k = apply_rope(k, pos2d, spec.rope_theta)

    # the KV heads the rank's queries read: all it computed, or those of
    # its queries among the replicated ones (a view)
    lo, hkv = (0, hkv) if hkv == heads.kv else (heads.kv_lo, heads.kv)
    new_cache = cache
    if cache is not None and cross_kv is None:
        ck, cv, idx = cache["k"], cache["v"], cache["index"]
        max_len = ck.shape[1]
        if s > max_len:
            raise ValueError(f"{s} tokens do not fit a cache of {max_len}")
        if ck.shape[2] != k.shape[2]:       # the cache holds the rank's heads
            k, v, lo = k[:, :, lo:lo + hkv], v[:, :, lo:lo + hkv], 0
        at = min(max(idx, 0), max_len - s)
        ck[:, at:at + s] = to_cache(k, ck.dtype)
        cv[:, at:at + s] = to_cache(v, cv.dtype)
        new_cache = {"k": ck, "v": cv, "index": idx + s}
        k, v = ck, cv
    k, v = k[:, :, lo:lo + hkv], v[:, :, lo:lo + hkv]
    mode = "full" if cross_kv is not None else mask_mode
    if mode == "causal" and q_start is None:
        q_start = query_start(pos2d)
    if mode == "causal" and cache is None:
        # the keys are the queries themselves: only their offsets matter
        q_start = torch.zeros_like(q_start)
    out = _attend(q, k, v, spec, q_start if mode == "causal" else None, mode)
    out = qdense(out.reshape(b, s, hq * dh), params["wo"], qcfg,
                 split="row" if heads.q_split else whole)
    return (reduce_from_model(out) if heads.q_split else out), new_cache


FP8 = torch.float8_e4m3fn
# e4m3fn's largest finite value is 448; halfway to the next step (480, a
# NaN code) lies 464, which rounds to even, 448
_E4M3_TIE = 464.0


def to_cache(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x in a cache of ``dtype``, as the reference's ``astype`` writes it.
    To float8_e4m3fn: to nearest even, NaN for |x| past 464 and for inf
    (464 itself ties to 448), where torch's cast saturates to 448; a NaN
    keeps its sign.  Else the plain cast.  Elementwise torch, on the card
    too."""
    if dtype != FP8:
        return x.to(dtype)
    out = torch.where(x.abs() > _E4M3_TIE, torch.copysign(
        torch.full_like(x, math.nan), x), x)
    return out.to(dtype)


def make_cache(batch: int, max_len: int, spec: AttnSpec,
               dtype=torch.bfloat16, device=None) -> Params:
    """KV cache of one layer.  ``index`` (the next write position) is a
    host int: it changes by the same amount on every step, so the engine
    never has to read it back from the card."""
    device = resolve_device(device)
    shape = (batch, max_len, spec.kv_heads, spec.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "index": 0}


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeLU)
# ---------------------------------------------------------------------------

def mlp_init(gen, d_model: int, d_ff: int, gated: bool = True,
             dtype=torch.float32, device=None) -> Params:
    p = {"w_up": dense_init(gen, d_model, d_ff, dtype, device),
         "w_down": dense_init(gen, d_ff, d_model, dtype, device)}
    if gated:
        p["w_gate"] = dense_init(gen, d_model, d_ff, dtype, device)
    return p


def _act(x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "gelu":
        return torch.nn.functional.gelu(x, approximate="tanh")
    return torch.nn.functional.silu(x)


def mlp(params: Params, x: torch.Tensor, qcfg: QuantConfig,
        act: str = "silu", split: bool = False) -> torch.Tensor:
    """The MLP on x.  ``split``: the params hold the rank's hidden columns
    (``w_up`` / ``w_gate`` columns, ``w_down`` rows); x enters the split
    region and the partial products are summed over the model group."""
    if not split:
        return mlp_part(params, x, qcfg, act)
    return reduce_from_model(mlp_part(params, copy_to_model(x), qcfg, act,
                                      True))


def mlp_part(params: Params, x: torch.Tensor, qcfg: QuantConfig,
             act: str = "silu", split: bool = False) -> torch.Tensor:
    """The MLP on x inside a split region: with ``split`` the rank's
    partial sum of its hidden columns."""
    col, row = ("col", "row") if split else (None, None)
    up = qdense(x, params["w_up"], qcfg, split=col)
    if "w_gate" in params:
        h = _act(qdense(x, params["w_gate"], qcfg, split=col), act) * up
    else:
        h = _act(up, act)
    return qdense(h, params["w_down"], qcfg, split=row)


# ---------------------------------------------------------------------------
# the vocabulary split: the embedding's rows, the head's columns
# ---------------------------------------------------------------------------

def split_over(n: int):
    """The ``ModelSplit`` where the group splits a dimension of ``n`` (a
    vocabulary's rows, an MLP's hidden columns), else None."""
    split = current_split()
    return split if split and split.divides(n) else None


def embed_rows(table: torch.Tensor, tokens: torch.Tensor,
               vocab: int) -> torch.Tensor:
    """The rows of ``table`` for ``tokens``; under the vocabulary split
    the table holds the rank's rows: each token looked up where it is the
    rank's, zeros elsewhere, summed over the group (one term is
    nonzero)."""
    split = split_over(vocab)
    if not split:
        return table[tokens]
    rows = table.shape[0]
    lo = split.rank * rows
    mine = (tokens >= lo) & (tokens < lo + rows)
    x = table[torch.where(mine, tokens - lo, 0)]
    return reduce_from_model(torch.where(mine[..., None], x, 0.0))


def head_logits(x: torch.Tensor, w, qcfg: QuantConfig,
                vocab: int) -> torch.Tensor:
    """x @ w, the output head; under the vocabulary split the rank's
    columns (its logits stay the rank's: ``softmax_xent(split=True)`` and
    ``greedy_tokens`` reduce over the group)."""
    split = split_over(vocab)
    if split:
        x = copy_to_model(x)
    return qdense(x, w, qcfg, split="col" if split else None)


def greedy_tokens(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """The argmax over the vocabulary of (..., V) logits, int64, the
    lowest index among equal maxima, as the reference's ``argmax``; under
    a vocabulary split over the ranks' slices (each rank's best gathered
    over the group)."""
    split = split_over(vocab)
    if split is None:
        return torch.argmax(logits, dim=-1)
    at = torch.argmax(logits, dim=-1)
    best = torch.gather(logits, -1, at[..., None])[..., 0].to(torch.float32)
    at = at + split.rank * logits.shape[-1]
    both = torch.stack([best, at.to(torch.float32)]).contiguous()
    parts = [torch.empty_like(both) for _ in range(split.size)]
    dist.all_gather(parts, both, group=split.group)
    vals = torch.stack([q[0] for q in parts])        # (m, ...): rank order
    ids = torch.stack([q[1] for q in parts]).to(torch.int64)
    top = torch.amax(vals, dim=0)
    # among the ranks holding the max, the lowest index: the lowest rank
    first = torch.argmax((vals == top).to(torch.int8), dim=0)
    return torch.gather(ids, 0, first[None])[0]


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 softcap: float = 0.0, split: bool = False) -> torch.Tensor:
    """Mean next-token cross entropy. logits: (..., V); labels: (...) int.

    ``split``: logits are the rank's slice of the vocabulary (rank r's
    V / m columns from r * V / m, the model group's ``current_split``):
    the max, the sum of exponentials and the gold logit are each reduced
    over the group, and no rank holds the whole (..., V)."""
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    logits = logits.to(torch.float32)
    labels = labels[..., None].to(torch.int64)
    if not split:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels)[..., 0]
        return torch.mean(logz - gold)
    v = logits.shape[-1]
    lo = current_split().rank * v
    # the max only steadies the exponentials: it takes no gradient
    top = model_max(torch.amax(logits.detach(), dim=-1))
    total = reduce_from_model(torch.sum(torch.exp(logits - top[..., None]),
                                        dim=-1))
    logz = top + torch.log(total)
    mine = (labels >= lo) & (labels < lo + v)
    gold = torch.gather(logits, -1, torch.where(mine, labels - lo, 0))
    gold = reduce_from_model(torch.where(mine, gold, 0.0)[..., 0])
    return torch.mean(logz - gold)
