"""Shared model layers with quantization hooks (port of the parts of
``repro.models.layers`` that the serving and training paths run).

Every dense projection goes through ``qdense`` so a model runs under any
of the paper's PE-type numerics (QuantConfig), or on packed weight codes.
Params are plain nested dicts of tensors, keyed like the reference's
pytree; init functions draw from a ``torch.Generator``.

Not ported (ROADMAP A): the activation-sharding and ``compute_dtype``
contexts, ``layernorm`` and the unified ``attention`` (the transformer's
own attention is ported).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.quant_matmul import quant_matmul
from repro_torch.quant.fake_quant import fake_quant_act, fake_quant_weight
from repro_torch.quant.pack import DEQUANTIZE
from repro_torch.quant.qconfig import QuantConfig

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def _normal(gen: torch.Generator, shape, device) -> torch.Tensor:
    """N(0, 1) float32 from ``gen`` (drawn on the generator's device)."""
    device = resolve_device(device)
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device).to(device)


def dense_init(gen, d_in: int, d_out: int, dtype=torch.float32, device=None):
    return (_normal(gen, (d_in, d_out), device) / math.sqrt(d_in)).to(dtype)


def embed_init(gen, vocab: int, d: int, dtype=torch.float32, device=None):
    return (_normal(gen, (vocab, d), device) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# quant-hooked dense
# ---------------------------------------------------------------------------

def packed_mode(w: dict):
    """(mode, key) of a packed leaf {"codes__<mode>": ..., "scale": ...}."""
    for key in w:
        if key.startswith("codes__"):
            return key.split("__", 1)[1], key
    return None, None


def qdense(x: torch.Tensor, w, qcfg: QuantConfig) -> torch.Tensor:
    """x @ w under the QuantConfig numerics (QAT fake-quant, STE grads).

    w may be a packed-code dict {"codes__<mode>": codes, "scale": scale}
    (the serving path).  With an identity ``qcfg`` the ``quant_matmul``
    kernel reads the codes themselves; otherwise they are dequantized,
    fake-quantized and multiplied, as in the reference.  A dense product
    promotes the two types as JAX does (bf16 x with float32 w is a
    float32 product).
    """
    if isinstance(w, dict):
        mode, key = packed_mode(w)
        codes, scale = w[key], w["scale"]
        if qcfg.is_identity:
            if codes.ndim != 2:
                raise ValueError(f"qdense takes one layer's codes, got "
                                 f"{tuple(codes.shape)}: index the layer")
            y = quant_matmul(x.reshape(-1, x.shape[-1]).contiguous(), codes,
                             scale, mode=mode)
            return y.reshape(*x.shape[:-1], y.shape[-1])
        w = DEQUANTIZE[mode](codes, scale)
    if not qcfg.is_identity:
        w = fake_quant_weight(w, qcfg)
        x = fake_quant_act(x, qcfg)
    dt = torch.promote_types(x.dtype, w.dtype)
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
# attention parameters and cache
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
