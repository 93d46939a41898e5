"""Decoder-only transformer LM (port of ``repro.models.transformer`` for
dense, all-global models such as SmolLM-135M).

Params keep the reference's pytree layout: per-layer weights stacked on
a leading L axis under ``params["layers"]``, packed leaves as
``{"codes__<mode>": ..., "scale": ...}``.  The layers run as a Python
loop over that axis where JAX scans.  Every projection goes through
``layers.qdense`` (packed weights: the ``quant_matmul`` kernel) and the
attention through the ``flash_attention`` kernel; the tied output head
stays a ``torch.matmul`` on the dense float32 embedding, as the
reference leaves it to XLA.

Entry points, as in the reference:

  forward(params, tokens, cfg)             -- logits of every position
  loss_fn(params, batch, cfg)              -- next-token cross entropy
  prefill(params, tokens, cfg, cache)      -- fill KV caches, last logits
  decode_step(params, token, cfg, cache)   -- one-token serve step

The KV cache is updated in place (the reference returns a new one; the
port returns the same, written, object).  Configurations this port does
not run raise: MoE, leading dense layers, local/global patterns with a
window, soft-capping, M-RoPE and the perf variants (``kv_replicate_to``,
``attn_block_local``, ``attn_flash``).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import flash_attention_gqa
from repro_torch.models import layers as L
from repro_torch.quant.qconfig import preset

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# layer pattern
# ---------------------------------------------------------------------------

def layer_is_global(cfg) -> np.ndarray:
    """(L,) bool: which layers use global attention."""
    n = cfg.n_layers
    if cfg.layer_pattern == "all_global" or cfg.window <= 0:
        return np.ones(n, bool)
    if cfg.layer_pattern == "alt_local_global":      # gemma2: L,G,L,G,...
        return np.arange(n) % 2 == 1
    if cfg.layer_pattern == "gemma3":                # 5 local : 1 global
        return np.arange(n) % 6 == 5
    raise ValueError(cfg.layer_pattern)


def attn_spec(cfg, is_global: bool = True) -> L.AttnSpec:
    return L.AttnSpec(
        n_heads=cfg.n_heads, kv_heads=cfg.kv_heads, head_dim=cfg.head_dim,
        causal=True, window=0 if is_global else cfg.window,
        softcap=cfg.attn_softcap, qk_norm=cfg.qk_norm,
        rope_theta=cfg.rope_theta, mrope_sections=tuple(cfg.mrope_sections),
        query_scale=cfg.query_scale)


def check_supported(cfg):
    """Raise for a configuration the port's transformer does not run."""
    refused = {
        "family other than lm": cfg.family != "lm",
        "MoE layers": cfg.moe_experts > 0,
        "leading dense layers": cfg.first_dense > 0,
        "local/global window patterns": not layer_is_global(cfg).all(),
        "attention soft-capping": cfg.attn_softcap > 0.0,
        "final soft-capping": cfg.final_softcap > 0.0,
        "M-RoPE": bool(cfg.mrope_sections),
        "kv_replicate_to": cfg.kv_replicate_to > 0,
        "attn_block_local": cfg.attn_block_local,
        "attn_flash": cfg.attn_flash,
    }
    bad = [what for what, on in refused.items() if on]
    if bad:
        raise NotImplementedError(f"{cfg.name}: the port does not run "
                                  f"{', '.join(bad)} yet (ROADMAP A)")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _norm_init(cfg, n, device):
    fill = torch.zeros if cfg.zero_centered_norm else torch.ones
    return fill(n, cfg.d_model, dtype=torch.float32, device=device)


def init_params(cfg, gen: torch.Generator, device=None) -> Params:
    """Random params with the reference's shapes and scales (dense
    1/sqrt(d_in), embed 0.02, norms 1), drawn from ``gen``."""
    check_supported(cfg)
    device = resolve_device(device)
    spec = attn_spec(cfg)
    embed = L.embed_init(gen, cfg.padded_vocab, cfg.d_model, device=device)
    per_layer = [{"attn": L.attn_init(gen, cfg.d_model, spec, device=device),
                  "mlp": L.mlp_init(gen, cfg.d_model, cfg.d_ff, True,
                                    device=device)}
                 for _ in range(cfg.n_layers)]
    stack = lambda key: {k: torch.stack([p[key][k] for p in per_layer])  # noqa: E731
                         for k in per_layer[0][key]}
    params: Params = {
        "embed": embed,
        "layers": {"attn": stack("attn"), "mlp": stack("mlp"),
                   "ln1": _norm_init(cfg, cfg.n_layers, device),
                   "ln2": _norm_init(cfg, cfg.n_layers, device)},
        "final_norm": _norm_init(cfg, 1, device)[0],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, cfg.d_model, cfg.padded_vocab,
                                         device=device)
    return params


def numpy_params(cfg, seed: int = 0) -> Params:
    """Random params as numpy float32 arrays in the reference's pytree
    layout, at the reference's init scales (dense N(0, 1/d_in), embed
    N(0, 0.02^2), norms 1), from ``np.random.default_rng(seed)``.  Both
    packages can load them (``convert.params_from_numpy`` here,
    ``jnp.asarray`` there), so they serve the very same weights."""
    rng = np.random.default_rng(seed)
    n, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
    hq, hkv = cfg.n_heads * cfg.head_dim, cfg.kv_heads * cfg.head_dim

    def dense(*shape):
        scale = np.float32(1.0) / np.sqrt(np.float32(shape[-2]))
        return rng.standard_normal(shape, dtype=np.float32) * scale

    def norm(*shape):
        return (np.zeros if cfg.zero_centered_norm else np.ones)(
            shape, np.float32)

    params = {
        "embed": rng.standard_normal((cfg.padded_vocab, d), dtype=np.float32)
        * np.float32(0.02),
        "layers": {
            "attn": {"wq": dense(n, d, hq), "wk": dense(n, d, hkv),
                     "wv": dense(n, d, hkv), "wo": dense(n, hq, d)},
            "ln1": norm(n, d), "ln2": norm(n, d),
            "mlp": {"w_up": dense(n, d, f), "w_down": dense(n, f, d),
                    "w_gate": dense(n, d, f)},
        },
        "final_norm": norm(d),
    }
    if cfg.qk_norm:
        params["layers"]["attn"]["q_norm"] = norm(n, cfg.head_dim)
        params["layers"]["attn"]["k_norm"] = norm(n, cfg.head_dim)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense(d, cfg.padded_vocab)
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _layer(tree, i: int):
    """Layer i of a stacked params (or cache) tree."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _block(p: Params, x, cfg, qcfg, positions, q_start, cache=None):
    """One transformer block (the reference's ``attn_mode="dyn"`` on an
    all-global model)."""
    h = L.rmsnorm(x, p["ln1"], zero_centered=cfg.zero_centered_norm)
    attn_out, new_cache = _attention_dynwin(p["attn"], h, attn_spec(cfg),
                                            qcfg, positions, q_start, cache)
    x = x + attn_out.to(x.dtype)
    h = L.rmsnorm(x, p["ln2"], zero_centered=cfg.zero_centered_norm)
    ff = L.mlp(p["mlp"], h, qcfg, cfg.act)
    return x + ff.to(x.dtype), new_cache


def _attention_dynwin(p, x, spec: L.AttnSpec, qcfg, positions, q_start,
                      cache):
    """Attention of one global layer, through the flash attention kernel.

    positions: (B, S) absolute token positions (for RoPE).  q_start: (B,)
    int32, the position of each row's first query on the key axis: the
    keys are the cache's rows 0..max_len-1 with a cache, else the prompt
    itself (then 0).  With a cache, this step's k and v are written at
    the cache index first, the start clamped to [0, max_len - S] as
    ``dynamic_update_slice`` clamps it.
    """
    b, s, _ = x.shape
    hq, hkv, dh = spec.n_heads, spec.kv_heads, spec.head_dim
    q = L.qdense(x, p["wq"], qcfg).reshape(b, s, hq, dh)
    k = L.qdense(x, p["wk"], qcfg).reshape(b, s, hkv, dh)
    v = L.qdense(x, p["wv"], qcfg).reshape(b, s, hkv, dh)
    if spec.qk_norm:
        q = L.rmsnorm(q, p["q_norm"])
        k = L.rmsnorm(k, p["k_norm"])
    q = L.apply_rope(q, positions, spec.rope_theta)
    k = L.apply_rope(k, positions, spec.rope_theta)

    new_cache = cache
    if cache is not None:
        ck, cv, idx = cache["k"], cache["v"], cache["index"]
        max_len = ck.shape[1]
        if s > max_len:
            raise ValueError(f"{s} tokens do not fit a cache of {max_len}")
        at = min(max(idx, 0), max_len - s)
        ck[:, at:at + s] = k.to(ck.dtype)
        cv[:, at:at + s] = v.to(cv.dtype)
        new_cache = {"k": ck, "v": cv, "index": idx + s}
        k, v = ck, cv

    # the reference's type rules: K is rounded to q's type inside the
    # product, P to V's type before P V; the kernel takes K and V as they
    # are (a float32 cache is not copied)
    out = flash_attention_gqa(q, k, v, q_start, causal=True,
                              scale=spec.query_scale or 1.0 / float(np.sqrt(dh)),
                              round_p=True)
    out = out.reshape(b, s, hq * dh).to(x.dtype)
    return L.qdense(out, p["wo"], qcfg), new_cache


def _backbone(params, x, cfg, positions, q_start, caches=None):
    """Embed-less forward over all layers. x: (B, S, D) hidden states.

    caches: None, or ``init_cache``'s tree, written in place.  Returns
    (y, caches)."""
    qcfg = preset(cfg.pe_type)
    for i in range(cfg.n_layers):
        cache = None if caches is None else _layer(caches["scan"], i)
        x, cache = _block(_layer(params["layers"], i), x, cfg, qcfg,
                          positions, q_start, cache)
        if caches is not None:
            caches["scan"]["index"][i] = cache["index"]
    return x, caches


def _logits(params, x, cfg):
    qcfg = preset(cfg.pe_type)
    x = L.rmsnorm(x, params["final_norm"], zero_centered=cfg.zero_centered_norm)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return L.qdense(x, w, qcfg)


def _embed(params, tokens, cfg):
    x = params["embed"][tokens]
    if cfg.embed_scale:
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x.to(getattr(torch, cfg.dtype))


def _positions(tokens, positions, start: int):
    """(positions (B, S), q_start (B,) int32 on the tokens' device).

    Without ``positions`` row b holds ``start + arange(S)``.  Given
    positions must have that form per row (the kernel takes one start
    per row); anything else raises."""
    b, s = tokens.shape[:2]
    dev = tokens.device
    ar = torch.arange(s, device=dev)
    if positions is None:
        q_start = torch.full((b,), start, dtype=torch.int32, device=dev)
        return (start + ar)[None].expand(b, s), q_start
    positions = torch.as_tensor(positions, device=dev)
    q_start = positions[:, 0].to(torch.int32)
    if not torch.equal(positions.to(torch.long),
                       q_start.to(torch.long)[:, None] + ar[None]):
        raise ValueError("positions must be start + arange(S) on every row")
    return positions, q_start


def forward(params, tokens, cfg, positions=None):
    """tokens: (B, S) -> logits (B, S, Vp)."""
    check_supported(cfg)
    positions, _ = _positions(tokens, positions, 0)
    # no cache: the keys are the queries themselves, so causal is j <= i
    zero = torch.zeros(tokens.shape[0], dtype=torch.int32,
                       device=tokens.device)
    x = _embed(params, tokens, cfg)
    x, _ = _backbone(params, x, cfg, positions, zero)
    return _logits(params, x, cfg)


def loss_fn(params, batch, cfg):
    """batch: {'tokens': (B, S), 'labels': (B, S)} -> scalar CE loss.

    Differentiable on the card: the attention's backward is the
    ``flash_attention`` backward kernel.  The reference rematerializes
    each layer in its scan (``jax.checkpoint``), which changes no value;
    the port keeps the activations (SmolLM-135M at batch 16 x 256 fits
    the card many times over)."""
    logits = forward(params, batch["tokens"], cfg, batch.get("positions"))
    return L.softmax_xent(logits, batch["labels"])


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None):
    """KV caches of all layers, stacked on a leading L axis; ``index`` is
    one host int per layer, as the reference keeps one per layer."""
    check_supported(cfg)
    one = L.make_cache(batch, max_len, attn_spec(cfg), dtype, device)
    n = cfg.n_layers
    scan = {"k": one["k"][None].repeat(n, 1, 1, 1, 1),
            "v": one["v"][None].repeat(n, 1, 1, 1, 1),
            "index": [0] * n}
    return {"dense": [], "scan": scan}


def prefill(params, tokens, cfg, cache, positions=None):
    """Fill caches with a prompt; returns (logits_last, cache)."""
    check_supported(cfg)
    positions, q_start = _positions(tokens, positions, 0)
    x = _embed(params, tokens, cfg)
    x, cache = _backbone(params, x, cfg, positions, q_start, cache)
    return _logits(params, x[:, -1:], cfg), cache


def decode_step(params, token, cfg, cache, positions=None):
    """token: (B, 1) -> (logits (B, 1, V), new cache)."""
    check_supported(cfg)
    positions, q_start = _positions(token, positions,
                                    cache["scan"]["index"][0])
    x = _embed(params, token, cfg)
    x, cache = _backbone(params, x, cfg, positions, q_start, cache)
    return _logits(params, x, cfg), cache
