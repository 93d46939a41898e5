"""Whisper-style encoder-decoder (port of ``repro.models.encdec``).

The conv frame frontend is the reference's stub: the encoder takes
precomputed frame embeddings (B, S_enc, D).  As in Whisper and the
reference: pre-LayerNorm blocks, bidirectional encoder self-attention,
causal decoder self-attention and cross-attention over the encoder
states, GELU (non-gated) MLPs, sinusoidal encoder positions and learned
decoder positions, the output head tied to the token embedding (a
``torch.matmul`` on the dense float32 table, as the reference leaves it
to XLA).

Params keep the reference's pytree layout: ``enc_layers`` and
``dec_layers`` stacked on a leading L axis, ``tok_embed``, ``pos_embed``
(``MAX_DEC_POS`` rows), LayerNorm ``{"scale", "bias"}`` leaves.  The
layers run as a Python loop where JAX scans.  Every projection goes
through ``layers.qdense`` (packed weights: the ``quant_matmul`` kernel)
and every attention through ``layers.attention``, which ends on the
``flash_attention`` kernel: the encoder's with no mask, the decoder's
causal from the cache's rows, the cross-attention with no mask over the
encoder's keys (Skv != Sq).

Entry points, as in the reference:

  encode(params, frames, cfg)                      -- encoder states
  loss_fn(params, batch, cfg)                      -- next-token CE
  prefill(params, batch, cfg, cache)               -- (logits_last, cache,
                                                      enc_out)
  decode_step(params, token, enc_out, cfg, cache)  -- one-token step

The KV cache is written in place, its ``index`` one host int a layer.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.quant.qconfig import preset

Params = Dict[str, Any]

MAX_DEC_POS = 32768 + 8


def check_supported(cfg):
    if cfg.family != "encdec":
        raise NotImplementedError(f"{cfg.name}: the encoder-decoder module "
                                  f"does not run the {cfg.family} family")


def _spec(cfg) -> L.AttnSpec:
    return L.AttnSpec(n_heads=cfg.n_heads, kv_heads=cfg.kv_heads,
                      head_dim=cfg.head_dim, rope_theta=cfg.rope_theta)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def param_shapes(cfg) -> dict:
    """{path: (shape, kind)} of the params tree, kind "dense" (N(0,
    1/d_in)), "embed" (N(0, 0.02^2)), "pos" (N(0, 0.01^2)), "ones",
    "zeros"."""
    d, f, vp = cfg.d_model, cfg.d_ff, cfg.padded_vocab
    hq, hkv = cfg.n_heads * cfg.head_dim, cfg.kv_heads * cfg.head_dim

    def attn(n, name):
        return {f"{name}/wq": ((n, d, hq), "dense"),
                f"{name}/wk": ((n, d, hkv), "dense"),
                f"{name}/wv": ((n, d, hkv), "dense"),
                f"{name}/wo": ((n, hq, d), "dense")}

    def block(n, prefix, attns, norms):
        out = {}
        for a in attns:
            out.update({f"{prefix}/{k}": v for k, v in attn(n, a).items()})
        out[f"{prefix}/mlp/w_up"] = ((n, d, f), "dense")
        out[f"{prefix}/mlp/w_down"] = ((n, f, d), "dense")
        for ln in norms:
            out[f"{prefix}/{ln}/scale"] = ((n, d), "ones")
            out[f"{prefix}/{ln}/bias"] = ((n, d), "zeros")
        return out

    out = block(cfg.enc_layers, "enc_layers", ("attn",), ("ln1", "ln2"))
    out.update(block(cfg.dec_layers, "dec_layers",
                     ("self_attn", "cross_attn"), ("ln1", "ln2", "ln3")))
    out["tok_embed"] = ((vp, d), "embed")
    out["pos_embed"] = ((MAX_DEC_POS, d), "pos")
    for ln in ("enc_ln", "dec_ln"):
        out[f"{ln}/scale"] = ((d,), "ones")
        out[f"{ln}/bias"] = ((d,), "zeros")
    return out


def _nest(flat: dict) -> Params:
    tree: Params = {}
    for path, leaf in flat.items():
        node = tree
        *head, last = path.split("/")
        for key in head:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree


def numpy_params(cfg, seed: int = 0) -> Params:
    """Random params as numpy float32 arrays in the reference's pytree
    layout and init scales (dense N(0, 1/d_in), token embedding N(0,
    0.02^2), decoder positions N(0, 0.01^2), LayerNorm scale 1 and bias
    0), from ``np.random.default_rng(seed)``: both packages can load
    them, so they serve the very same weights."""
    rng = np.random.default_rng(seed)
    flat = {}
    for path, (shape, kind) in param_shapes(cfg).items():
        if kind in ("ones", "zeros"):
            flat[path] = (np.ones if kind == "ones" else np.zeros)(
                shape, np.float32)
            continue
        scale = {"dense": np.float32(1.0) / np.sqrt(np.float32(shape[-2])),
                 "embed": np.float32(0.02), "pos": np.float32(0.01)}[kind]
        flat[path] = rng.standard_normal(shape, dtype=np.float32) * scale
    return _nest(flat)


def init_params(cfg, gen: torch.Generator, device=None) -> Params:
    """Random params with the reference's shapes and scales, drawn from
    ``gen``."""
    check_supported(cfg)
    device = resolve_device(device)
    flat = {}
    for path, (shape, kind) in param_shapes(cfg).items():
        if kind in ("ones", "zeros"):
            flat[path] = (torch.ones if kind == "ones" else torch.zeros)(
                shape, dtype=torch.float32, device=device)
            continue
        scale = {"dense": 1.0 / math.sqrt(shape[-2]), "embed": 0.02,
                 "pos": 0.01}[kind]
        flat[path] = L.randn(gen, shape, device) * scale
    return _nest(flat)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _ln(x, p):
    return L.layernorm(x, p["scale"], p["bias"])


def _layer(tree, i: int):
    """Layer i of a stacked params tree."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _sinusoid(s: int, d: int, dtype, device) -> torch.Tensor:
    """The encoder's position table, computed in float64 as the reference
    computes it, then rounded to ``dtype``."""
    pos = np.arange(s)[:, None]
    dim = np.arange(0, d, 2)[None, :] / d
    ang = pos / (10000.0 ** dim)
    table = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.as_tensor(table).to(device=device, dtype=dtype)


def _arange_positions(b: int, s: int, start: int, device):
    """((B, S) positions start + arange(S), (B,) int32 q_start)."""
    ar = start + torch.arange(s, device=device)
    return (ar[None].expand(b, s),
            torch.full((b,), start, dtype=torch.int32, device=device))


def encode(params, frames, cfg):
    """frames: (B, S_enc, D) precomputed frame embeddings (frontend stub)
    -> encoder states (B, S_enc, D) in the compute type."""
    check_supported(cfg)
    qcfg = preset(cfg.pe_type)
    b, s, d = frames.shape
    dt = getattr(torch, cfg.dtype)
    x = frames.to(dt) + _sinusoid(s, d, dt, frames.device)
    positions, _ = _arange_positions(b, s, 0, frames.device)
    spec = _spec(cfg)

    def layer(p, x):
        a, _ = L.attention(p["attn"], _ln(x, p["ln1"]), spec, qcfg,
                           positions, mask_mode="full")
        x = x + a.to(x.dtype)
        return x + L.mlp(p["mlp"], _ln(x, p["ln2"]), qcfg,
                         "gelu").to(x.dtype)

    # each layer rematerialized, as the reference's scan checkpoints it
    for i in range(cfg.enc_layers):
        x = L.remat(layer, _layer(params["enc_layers"], i), x)
    return _ln(x, params["enc_ln"])


def _decoder(params, tokens, enc_out, cfg, positions, q_start, caches=None):
    """The decoder over all layers: (logits (B, S, Vp), caches)."""
    qcfg = preset(cfg.pe_type)
    spec = _spec(cfg)
    dt = getattr(torch, cfg.dtype)
    x = params["tok_embed"][tokens].to(dt)
    x = x + params["pos_embed"][positions].to(x.dtype)

    def layer(p, x, enc_out, cache=None):
        a, cache = L.attention(p["self_attn"], _ln(x, p["ln1"]), spec, qcfg,
                               positions, cache, q_start=q_start)
        x = x + a.to(x.dtype)
        c, _ = L.attention(p["cross_attn"], _ln(x, p["ln2"]), spec, qcfg,
                           positions, cross_kv=enc_out)
        x = x + c.to(x.dtype)
        x = x + L.mlp(p["mlp"], _ln(x, p["ln3"]), qcfg, "gelu").to(x.dtype)
        return x, cache

    for i in range(cfg.dec_layers):
        p = _layer(params["dec_layers"], i)
        if caches is None:
            # rematerialized without a cache, as the reference's scan
            x = L.remat(lambda p, x, e: layer(p, x, e)[0], p, x, enc_out)
            continue
        cache = {"k": caches["k"][i], "v": caches["v"][i],
                 "index": caches["index"][i]}
        x, cache = layer(p, x, enc_out, cache)
        caches["index"][i] = cache["index"]
    x = _ln(x, params["dec_ln"])
    logits = L.qdense(x, params["tok_embed"].T, qcfg)   # tied embeddings
    return logits, caches


def loss_fn(params, batch, cfg):
    """batch: {'frames': (B, S_enc, D), 'tokens': (B, S_dec), 'labels':
    (B, S_dec)} -> scalar next-token cross entropy.  On the card every
    attention's gradient (bidirectional, causal, cross; head_dim 64 at
    full size, 16 reduced) is the backward kernel's."""
    enc_out = encode(params, batch["frames"], cfg)
    b, s = batch["tokens"].shape
    positions, q_start = _arange_positions(b, s, 0, batch["tokens"].device)
    logits, _ = _decoder(params, batch["tokens"], enc_out, cfg, positions,
                         q_start)
    return L.softmax_xent(logits, batch["labels"])


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None):
    """The decoder's self-attention KV caches, stacked on a leading L
    axis; ``index`` is one host int a layer, as the reference keeps one a
    layer."""
    check_supported(cfg)
    device = resolve_device(device)
    shape = (cfg.dec_layers, batch, max_len, cfg.kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "index": [0] * cfg.dec_layers}


def prefill(params, batch, cfg, cache):
    """Encode the frames and run the decoder prompt through the caches:
    (logits of the last position (B, 1, Vp), cache, enc_out)."""
    enc_out = encode(params, batch["frames"], cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    positions, q_start = _arange_positions(b, s, 0, tokens.device)
    logits, cache = _decoder(params, tokens, enc_out, cfg, positions,
                             q_start, cache)
    return logits[:, -1:], cache, enc_out


def decode_step(params, token, enc_out, cfg, cache, positions=None):
    """token: (B, 1) -> (logits (B, 1, Vp), cache), at the cache index
    (layer 0's) unless ``positions`` ((B, 1), equal rows) say otherwise."""
    check_supported(cfg)
    b = token.shape[0]
    if positions is None:
        positions, q_start = _arange_positions(b, 1, cache["index"][0],
                                               token.device)
    else:
        positions = torch.as_tensor(positions, device=token.device)
        q_start = L.query_start(positions)
    return _decoder(params, token, enc_out, cfg, positions, q_start, cache)
