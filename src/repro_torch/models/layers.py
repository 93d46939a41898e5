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
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Dict

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import flash_attention_gqa
from repro_torch.kernels.quant_matmul import quant_matmul
from repro_torch.launch.mesh import (  # noqa: F401  (the reference's names)
    activation_sharding, current_dp, current_mesh, in_context,
    saved_context)
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


def qdense(x: torch.Tensor, w, qcfg: QuantConfig,
           cast=None) -> torch.Tensor:
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
    """
    ct = cast if cast is not None else current_compute_dtype()
    if isinstance(w, dict):
        mode, key = packed_mode(w)
        codes, scale = w[key], w["scale"]
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
    if not qcfg.is_identity:
        w = fake_quant_weight(w, qcfg)
        x = fake_quant_act(x, qcfg)
    dt = ct if ct is not None else torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dt), w.to(dt))


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
            zero_centered: bool = False) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
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
    (bidirectional / cross).  One ``flash_attention`` launch on the card."""
    f32 = torch.float32
    out = flash_attention_gqa(
        q.to(f32), k.to(f32), v.to(f32), q_start,
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
    come from them, no RoPE, every key visible.  Returns (out, cache)."""
    b, s, _ = x.shape
    hq, hkv, dh = spec.n_heads, spec.kv_heads, spec.head_dim
    q = qdense(x, params["wq"], qcfg).reshape(b, s, hq, dh)
    kv_src = cross_kv if cross_kv is not None else x
    k = qdense(kv_src, params["wk"], qcfg).reshape(b, kv_src.shape[1], hkv,
                                                   dh)
    v = qdense(kv_src, params["wv"], qcfg).reshape(b, kv_src.shape[1], hkv,
                                                   dh)
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

    new_cache = cache
    if cache is not None and cross_kv is None:
        ck, cv, idx = cache["k"], cache["v"], cache["index"]
        max_len = ck.shape[1]
        if s > max_len:
            raise ValueError(f"{s} tokens do not fit a cache of {max_len}")
        at = min(max(idx, 0), max_len - s)
        ck[:, at:at + s] = k.to(ck.dtype)
        cv[:, at:at + s] = v.to(cv.dtype)
        new_cache = {"k": ck, "v": cv, "index": idx + s}
        k, v = ck, cv
    mode = "full" if cross_kv is not None else mask_mode
    if mode == "causal" and q_start is None:
        q_start = query_start(pos2d)
    if mode == "causal" and cache is None:
        # the keys are the queries themselves: only their offsets matter
        q_start = torch.zeros_like(q_start)
    out = _attend(q, k, v, spec, q_start if mode == "causal" else None, mode)
    out = qdense(out.reshape(b, s, hq * dh), params["wo"], qcfg)
    return out, new_cache


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
        act: str = "silu") -> torch.Tensor:
    up = qdense(x, params["w_up"], qcfg)
    if "w_gate" in params:
        h = _act(qdense(x, params["w_gate"], qcfg), act) * up
    else:
        h = _act(up, act)
    return qdense(h, params["w_down"], qcfg)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 softcap: float = 0.0) -> torch.Tensor:
    """Mean next-token cross entropy. logits: (..., V); labels: (...) int."""
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].to(torch.int64))[..., 0]
    return torch.mean(logz - gold)
