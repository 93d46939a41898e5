"""Decoder-only transformer LM (port of ``repro.models.transformer``): the
``lm``, ``moe`` and ``vlm`` families (qwen3 / gemma2 / gemma3 / smollm /
the qwen2-vl backbone / deepseek-moe / phi3.5-moe), on the reference's
baseline path (``attn_mode="dyn"``) and its perf variants.

Params keep the reference's pytree layout: per-layer weights stacked on
a leading L axis under ``params["layers"]`` (MoE blocks under
``"moe"``), leading dense layers (deepseek's ``first_dense``) as an
unstacked ``params["dense_layers"]`` list, packed leaves as
``{"codes__<mode>": ..., "scale": ...}``.  The layers run as a Python
loop where JAX scans.  Every projection goes through
``layers.qdense`` (packed weights: the ``quant_matmul`` kernel) and the
attention through the ``flash_attention`` kernel; the tied output head
stays a ``torch.matmul`` on the dense float32 embedding, as the
reference leaves it to XLA.

Entry points, as in the reference:

  forward(params, tokens, cfg)             -- logits of every position
  loss_fn(params, batch, cfg)              -- next-token cross entropy
  prefill(params, tokens, cfg, cache)      -- fill KV caches, last logits
  decode_step(params, token, cfg, cache)   -- one-token serve step

Local layers (gemma2's alternating, gemma3's 5:1 pattern) pass their
window to the kernel and global ones none; gemma2's attention and final
soft-caps and its query scale go to the kernel and the head.  M-RoPE
takes (B, S) positions broadcast to its 3 streams (or (B, S, 3) ones);
the kernel's query start comes from stream 0.

The perf variants, as the reference takes them:
  * ``kv_replicate_to``: K/V heads repeated up to that count in the
    attention and in ``init_cache`` (the kernel then sees Hq / count
    query heads a KV head);
  * ``attn_block_local`` (no cache, a window, the gemma3 or alternating
    pattern): local layers through ``block_attn.block_local_attention``
    (float32 with float32 P), global ones on the baseline path;
  * ``attn_flash`` (no cache, an all-global pattern): every layer through
    ``flash_attn.flash_attention``, float32 with float32 P;
  * ``moe_ep_shard_map``: ``moe.moe_apply_ep`` (expert parallelism over
    the launcher's mesh; ``moe_apply`` with no mesh, as the reference
    falls back).

The KV cache is updated in place (the reference returns a new one; the
port returns the same, written, object).  The families other than
``lm`` / ``moe`` / ``vlm`` raise here (``encdec`` has its own module).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import flash_attention_gqa, soft_cap
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models.block_attn import block_local_attention
from repro_torch.models.flash_attn import flash_attention as chunked_attention
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
    """Raise for a configuration the port's transformer does not run: a
    family other than ``lm`` / ``moe`` / ``vlm``."""
    if cfg.family not in ("lm", "moe", "vlm"):
        raise NotImplementedError(f"{cfg.name}: the port's transformer does "
                                  f"not run the {cfg.family} family")


def replicated_kv(cfg) -> int:
    """KV heads of the attention and the cache: ``kv_replicate_to`` when
    it exceeds the config's (the perf variant), else the config's."""
    rep = cfg.kv_replicate_to
    return rep if rep and rep > cfg.kv_heads else cfg.kv_heads


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _norm_init(cfg, n, device):
    fill = torch.zeros if cfg.zero_centered_norm else torch.ones
    return fill(n, cfg.d_model, dtype=torch.float32, device=device)


def _stack(trees):
    """A list of equal params trees -> one tree stacked on a leading axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_params(cfg, gen: torch.Generator, device=None) -> Params:
    """Random params with the reference's shapes and scales (dense
    1/sqrt(d_in), embed 0.02, norms 1), drawn from ``gen``."""
    check_supported(cfg)
    device = resolve_device(device)
    spec = attn_spec(cfg)
    n_scan = cfg.n_layers - cfg.first_dense
    embed = L.embed_init(gen, cfg.padded_vocab, cfg.d_model, device=device)

    def layer():
        p = {"attn": L.attn_init(gen, cfg.d_model, spec, device=device)}
        if cfg.moe_experts > 0:
            p["moe"] = MOE.moe_init(gen, cfg, device=device)
        else:
            p["mlp"] = L.mlp_init(gen, cfg.d_model, cfg.d_ff, True,
                                  device=device)
        return p

    per_layer = [layer() for _ in range(n_scan)]
    params: Params = {
        "embed": embed,
        "layers": {**_stack(per_layer),
                   "ln1": _norm_init(cfg, n_scan, device),
                   "ln2": _norm_init(cfg, n_scan, device)},
        "final_norm": _norm_init(cfg, 1, device)[0],
    }
    if cfg.first_dense:   # deepseek: leading dense layer(s), unstacked
        ones = lambda: torch.ones(cfg.d_model, device=device)  # noqa: E731
        params["dense_layers"] = [
            {"attn": L.attn_init(gen, cfg.d_model, spec, device=device),
             "mlp": L.mlp_init(gen, cfg.d_model, cfg.dense_d_ff or cfg.d_ff,
                               True, device=device),
             "ln1": ones(), "ln2": ones()}
            for _ in range(cfg.first_dense)]
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, cfg.d_model, cfg.padded_vocab,
                                         device=device)
    return params


def numpy_params(cfg, seed: int = 0) -> Params:
    """Random params as numpy float32 arrays in the reference's pytree
    layout, at the reference's init scales (dense N(0, 1/d_in), embed
    N(0, 0.02^2), norms 1, or 0 for a zero-centered norm; the qk-norm
    scales 1, as the reference's ``attn_init`` sets them), from
    ``np.random.default_rng(seed)``.  Both packages can load them
    (``convert.params_from_numpy`` here, ``jnp.asarray`` there), so they
    serve the very same weights."""
    rng = np.random.default_rng(seed)
    d, f = cfg.d_model, cfg.d_ff
    n = cfg.n_layers - cfg.first_dense
    hq, hkv = cfg.n_heads * cfg.head_dim, cfg.kv_heads * cfg.head_dim

    def dense(*shape):
        scale = np.float32(1.0) / np.sqrt(np.float32(shape[-2]))
        return rng.standard_normal(shape, dtype=np.float32) * scale

    def norm(*shape):
        return (np.zeros if cfg.zero_centered_norm else np.ones)(
            shape, np.float32)

    def attn(*lead):
        p = {"wq": dense(*lead, d, hq), "wk": dense(*lead, d, hkv),
             "wv": dense(*lead, d, hkv), "wo": dense(*lead, hq, d)}
        if cfg.qk_norm:
            p["q_norm"] = np.ones((*lead, cfg.head_dim), np.float32)
            p["k_norm"] = np.ones((*lead, cfg.head_dim), np.float32)
        return p

    def mlp(*lead, width):
        return {"w_up": dense(*lead, d, width),
                "w_down": dense(*lead, width, d),
                "w_gate": dense(*lead, d, width)}

    params = {
        "embed": rng.standard_normal((cfg.padded_vocab, d), dtype=np.float32)
        * np.float32(0.02),
        "layers": {"attn": attn(n), "ln1": norm(n, d), "ln2": norm(n, d)},
        "final_norm": norm(d),
    }
    if cfg.moe_experts > 0:
        e = cfg.moe_experts
        moe = {"router": dense(n, d, e),
               "experts": mlp(n, e, width=cfg.moe_d_ff)}
        if cfg.moe_shared:
            moe["shared"] = mlp(n, width=cfg.moe_shared * cfg.moe_d_ff)
        params["layers"]["moe"] = moe
    else:
        params["layers"]["mlp"] = mlp(n, width=f)
    if cfg.first_dense:
        params["dense_layers"] = [
            {"attn": attn(), "mlp": mlp(width=cfg.dense_d_ff or f),
             "ln1": np.ones(d, np.float32), "ln2": np.ones(d, np.float32)}
            for _ in range(cfg.first_dense)]
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


def _block(p: Params, x, cfg, qcfg, positions, q_start, is_global: bool,
           cache=None, moe: bool = False, attn_mode: str = "dyn"):
    """One transformer block.  attn_mode "dyn" (the baseline: a local
    layer's attention sees its window, a global one's every earlier key)
    or "local" (the grouped backbone's local layers: the block-local
    window, float32); the grouped backbone's global layers are "dyn"
    ones, as the reference's static "global" mode computes the same."""
    h = L.rmsnorm(x, p["ln1"], zero_centered=cfg.zero_centered_norm)
    attn_out, new_cache = _attention_dynwin(
        p["attn"], h, attn_spec(cfg), qcfg, positions, q_start, cache,
        0 if is_global else max(cfg.window, 1), cfg=cfg, attn_mode=attn_mode)
    x = x + attn_out.to(x.dtype)
    h = L.rmsnorm(x, p["ln2"], zero_centered=cfg.zero_centered_norm)
    if moe:
        moe_fn = MOE.moe_apply_ep if cfg.moe_ep_shard_map else MOE.moe_apply
        ff = moe_fn(p["moe"], h, cfg, qcfg)
    else:
        ff = L.mlp(p["mlp"], h, qcfg, cfg.act)
    return x + ff.to(x.dtype), new_cache


def _attention_dynwin(p, x, spec: L.AttnSpec, qcfg, positions, q_start,
                      cache, window: int = 0, cfg=None,
                      attn_mode: str = "dyn"):
    """Attention of one layer, through the flash attention kernel.

    positions: (B, S) absolute token positions (for RoPE), or (B, S, 3)
    M-RoPE streams.  q_start: (B,) int32, the position of each row's first
    query on the key axis (stream 0's): the keys are the cache's rows
    0..max_len-1 with a cache, else the prompt itself (then 0).  With a
    cache, this step's k and v are written at the cache index first, the
    start clamped to [0, max_len - S] as ``dynamic_update_slice`` clamps
    it.  window: 0 (global) or the local layer's width.  ``cfg`` carries
    the perf variants (``kv_replicate_to``, ``attn_flash``), ``attn_mode``
    "local" the grouped backbone's local layers.
    """
    b, s, _ = x.shape
    hq, hkv, dh = spec.n_heads, spec.kv_heads, spec.head_dim
    q = L.qdense(x, p["wq"], qcfg).reshape(b, s, hq, dh)
    k = L.qdense(x, p["wk"], qcfg).reshape(b, s, hkv, dh)
    v = L.qdense(x, p["wv"], qcfg).reshape(b, s, hkv, dh)
    if spec.qk_norm:
        q = L.rmsnorm(q, p["q_norm"])
        k = L.rmsnorm(k, p["k_norm"])
    pos2d = positions if positions.ndim == 2 else positions[..., 0]
    if spec.mrope_sections:
        # text-only stream: (B, S) positions -> identical t/h/w ids
        pos3 = positions if positions.ndim == 3 else \
            positions[..., None].expand(*positions.shape, 3)
        q = L.apply_mrope(q, pos3, spec.mrope_sections, spec.rope_theta)
        k = L.apply_mrope(k, pos3, spec.mrope_sections, spec.rope_theta)
    else:
        q = L.apply_rope(q, pos2d, spec.rope_theta)
        k = L.apply_rope(k, pos2d, spec.rope_theta)

    # perf variant: K/V heads padded up to the TP degree (replicated GQA
    # groups), so that decode caches shard on heads
    kv = replicated_kv(cfg) if cfg is not None else hkv
    if kv > hkv:
        k = torch.repeat_interleave(k, kv // hkv, dim=2)
        v = torch.repeat_interleave(v, kv // hkv, dim=2)
        hkv = kv
    scale = spec.query_scale or 1.0 / float(np.sqrt(dh))

    if attn_mode == "local" and cache is None:
        # perf variant: static block-banded window, float32 throughout
        out = block_local_attention(q.reshape(b, s, hkv, hq // hkv, dh), k,
                                    v, pos2d, cfg.window, spec.softcap,
                                    spec.query_scale, checked=True)
        out = out.reshape(b, s, hq * dh).to(x.dtype)
        return L.qdense(out, p["wo"], qcfg), cache
    if (cfg is not None and cfg.attn_flash and cache is None
            and (cfg.layer_pattern == "all_global" or cfg.window <= 0)):
        # perf variant: chunked online-softmax prefill (all-global
        # patterns only; the traced window of the scan is 2^30)
        out = chunked_attention(q.reshape(b, s, hkv, hq // hkv, dh), k, v,
                                pos2d, pos2d, 1 << 30, spec.softcap,
                                spec.query_scale,
                                q_start=torch.zeros_like(q_start))
        out = out.reshape(b, s, hq * dh).to(x.dtype)
        return L.qdense(out, p["wo"], qcfg), cache

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
    out = flash_attention_gqa(q, k, v, q_start, causal=True, scale=scale,
                              round_p=True, window=window,
                              softcap=spec.softcap)
    out = out.reshape(b, s, hq * dh).to(x.dtype)
    return L.qdense(out, p["wo"], qcfg), new_cache


def _backbone(params, x, cfg, positions, q_start, caches=None):
    """Embed-less forward over all layers. x: (B, S, D) hidden states.

    caches: None, or ``init_cache``'s tree, written in place.  Returns
    (y, caches)."""
    qcfg = preset(cfg.pe_type)
    for i in range(cfg.first_dense):
        cache = None if caches is None else caches["dense"][i]
        x, cache = _block(params["dense_layers"][i], x, cfg, qcfg, positions,
                          q_start, True, cache)
        if caches is not None:
            caches["dense"][i] = cache
    flags = layer_is_global(cfg)[cfg.first_dense:]
    moe = cfg.moe_experts > 0
    if caches is not None:
        for i, is_global in enumerate(flags):
            x, cache = _block(_layer(params["layers"], i), x, cfg, qcfg,
                              positions, q_start, bool(is_global),
                              _layer(caches["scan"], i), moe=moe)
            caches["scan"]["index"][i] = cache["index"]
        return x, caches

    def layer(i: int, h, is_global: bool, mode: str = "dyn",
              remat: bool = True):
        """Stacked layer i on h, rematerialized unless ``remat`` is
        False."""
        def run(p, h):
            return _block(p, h, cfg, qcfg, positions, q_start, is_global,
                          moe=moe, attn_mode=mode)[0]
        p = _layer(params["layers"], i)
        return L.remat(run, p, h) if remat else run(p, h)

    grouped = _grouped_flags(cfg)
    if grouped is None:
        # the reference's scan of rematerialized layers
        for i, is_global in enumerate(flags):
            x = layer(i, x, bool(is_global))
        return x, None
    # the grouped backbone: each period a rematerialized group of
    # (period - 1) rematerialized local layers and the global one; the
    # leftover local layers rematerialized one by one
    period = _PERIOD[cfg.layer_pattern]
    n_groups = cfg.n_layers // period

    def group(h, first: int, *_group_params):
        for i in range(first, first + period - 1):
            h = layer(i, h, False, "local")
        return layer(first + period - 1, h, True, remat=False)

    for g in range(n_groups):
        x = L.remat(group, x, g * period,
                    *(_layer(params["layers"], i)
                      for i in range(g * period, (g + 1) * period)))
    for i in range(n_groups * period, len(flags)):
        x = layer(i, x, False, "local")
    return x, None


_PERIOD = {"gemma3": 6, "alt_local_global": 2}


def _grouped_flags(cfg):
    """The reference's pattern-grouped backbone (perf variant
    ``attn_block_local``, with no cache, a window and the gemma3 or
    alternating pattern): the stacked layers in periods of (period - 1)
    block-local layers and one global, the leftover layers local.  Returns
    each stacked layer's is_global, or None off that path."""
    if not (cfg.attn_block_local and cfg.window > 0
            and cfg.layer_pattern in ("gemma3", "alt_local_global")):
        return None
    period = _PERIOD[cfg.layer_pattern]
    n_groups = cfg.n_layers // period
    idx = np.arange(cfg.n_layers - cfg.first_dense)
    return (idx < n_groups * period) & (idx % period == period - 1)


def _logits(params, x, cfg):
    qcfg = preset(cfg.pe_type)
    x = L.rmsnorm(x, params["final_norm"], zero_centered=cfg.zero_centered_norm)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = L.qdense(x, w, qcfg)
    if cfg.final_softcap > 0.0:
        logits = soft_cap(logits, cfg.final_softcap)
    return logits


def _embed(params, tokens, cfg):
    x = params["embed"][tokens]
    if cfg.embed_scale:
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x.to(getattr(torch, cfg.dtype))


def _positions(tokens, positions, start: int):
    """(positions (B, S) or (B, S, 3), q_start (B,) int32 on the tokens'
    device).

    Without ``positions`` row b holds ``start + arange(S)``.  Given
    positions (M-RoPE: their stream 0) must have that form per row (the
    kernel takes one start per row); anything else raises."""
    b, s = tokens.shape[:2]
    dev = tokens.device
    if positions is None:
        q_start = torch.full((b,), start, dtype=torch.int32, device=dev)
        return (start + torch.arange(s, device=dev))[None].expand(b, s), \
            q_start
    positions = torch.as_tensor(positions, device=dev)
    return positions, L.query_start(positions)


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
    ``flash_attention`` backward kernel, Gemma's local layers' sliding
    window and Gemma-2's soft-cap included.  Each stacked layer is
    rematerialized (``layers.remat``), as the reference's scan
    checkpoints it: the backward keeps a layer's inputs and runs its
    forward again, which changes no value."""
    logits = forward(params, batch["tokens"], cfg, batch.get("positions"))
    return L.softmax_xent(logits, batch["labels"])


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None):
    """KV caches: the scanned layers' stacked on a leading L axis, the
    leading dense layers' one a layer under ``"dense"``; ``index`` is one
    host int per layer, as the reference keeps one per layer.  With
    ``kv_replicate_to`` the caches hold that many KV heads."""
    check_supported(cfg)
    spec = dataclasses.replace(attn_spec(cfg), kv_heads=replicated_kv(cfg))
    one = L.make_cache(batch, max_len, spec, dtype, device)
    n = cfg.n_layers - cfg.first_dense
    scan = {"k": one["k"][None].repeat(n, 1, 1, 1, 1),
            "v": one["v"][None].repeat(n, 1, 1, 1, 1),
            "index": [0] * n}
    dense = [L.make_cache(batch, max_len, spec, dtype, device)
             for _ in range(cfg.first_dense)]
    return {"dense": dense, "scan": scan}


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
