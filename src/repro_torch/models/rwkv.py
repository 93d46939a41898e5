"""RWKV-6 "Finch", the ``ssm`` family (port of ``repro.models.rwkv``):
an attention-free LM with a data-dependent decay.

As in the reference: token-shift mixing with static per-channel
coefficients (``mu``) for r/k/v/g/w, the r/k/v/g projections through
``layers.qdense``, the decay w_t = exp(-exp(w0 + tanh(x a) b)) from two
plain float32 products, the bonus u, a per-head RMSNorm over ``ln_x``,
and a squared-ReLU channel mix.  The time mix runs through
``ssm_common``: a prompt in chunks, a decode step (one token and a
state) as ``single_step``.  No kernel of its own: on the card its
projections reach ``quant_matmul`` on packed codes and ``fake_quant``
under QAT numerics.

Params keep the reference's layout: per-layer weights stacked on a
leading L axis under ``params["layers"]``.  The serving state is O(1) a
layer, no KV cache: ``init_cache`` gives each layer's ``s`` (B, H, dh,
dh) float32, ``tm_last`` and ``cm_last`` (B, D), stacked on L.  As in
the reference, the last-token states take the hidden states' type after
the first step (bfloat16 for a bfloat16 model), whatever type the cache
started in, and a prompt starts from whatever state the cache holds.

Under the tensor-parallel split (``keeps_model_shard``; the collectives
of ``launch.mesh``) each rank computes its heads of the time
mix (``sharding.ssm_heads``: ``w[rkvg]`` its columns, the scan and the
per-head norm on its heads, ``wo`` its rows, the partial sums summed)
and its columns of the channel mix (``wk`` / ``wr`` its columns, ``wv``
its rows: the value summed over the group, the receptance gathered), and
its vocabulary rows; the replicated ``mu``, ``wa``, ``wb``, ``w0``,
``u`` and ``ln_x`` enter the split region through ``copy_to_model``.
Its serving state is the rank's heads of ``s``; ``tm_last`` /
``cm_last`` stay whole.

The serving packer packs by size: at full width it packs ``mu``, the
decay LoRA ``wa`` / ``wb``, and at 24 layers ``u`` and ``ln_x``, which
the reference then reads as dense tensors and fails on (ROADMAP C); the
port raises ``NotImplementedError`` there, naming that failure.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.launch.mesh import (ModelSplit, copy_to_model,
                                     current_split, gather_from_model,
                                     reduce_from_model)
from repro_torch.launch.sharding import ssm_heads
from repro_torch.models import layers as L
from repro_torch.models import params as P
from repro_torch.models import ssm_common as SSM
from repro_torch.quant.qconfig import preset

Params = Dict[str, Any]

DECAY_LORA = 64

_PACKED_TM = ("the reference's _time_mix reads it as a dense tensor "
              "(KeyError: 0 at mu[0], or a product with a dict; ROADMAP C)")
_PACKED_CM = ("the reference's _channel_mix reads it as a dense tensor "
              "(KeyError: 0 at mu[0]; ROADMAP C)")


def check_supported(cfg):
    if cfg.family != "ssm":
        raise NotImplementedError(f"{cfg.name}: the RWKV module does not run "
                                  f"the {cfg.family} family")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def param_shapes(cfg) -> dict:
    """{path: (shape, kind)} of the params tree (``models.params``'
    kinds), the reference's ``init_params`` shape for shape and scale
    for scale."""
    d, f, n, vp = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.padded_vocab
    h = cfg.ssm_heads
    dh = d // h
    tm = {
        "mu": ((n, 5, d), np.linspace(0.1, 0.9, 5 * d).reshape(5, d)),
        "wr": ((n, d, d), "dense"), "wk": ((n, d, d), "dense"),
        "wv": ((n, d, d), "dense"), "wg": ((n, d, d), "dense"),
        "wo": ((n, d, d), "dense"),
        "w0": ((n, d), np.full((d,), -1.5)),
        "wa": ((n, d, DECAY_LORA), "dense"),
        "wb": ((n, DECAY_LORA, d), "lora_b"),
        "u": ((n, h, dh), np.linspace(-0.5, 0.5, d).reshape(h, dh)),
        "ln_x": ((n, h, dh), "ones"),
    }
    cm = {
        "mu": ((n, 2, d), np.linspace(0.2, 0.8, 2 * d).reshape(2, d)),
        "wk": ((n, d, f), "dense"), "wv": ((n, f, d), "dense"),
        "wr": ((n, d, d), "dense"),
    }
    out = {"embed": ((vp, d), "embed")}
    out.update({f"layers/tm/{k}": v for k, v in tm.items()})
    out.update({f"layers/cm/{k}": v for k, v in cm.items()})
    out["layers/ln1"] = ((n, d), "ones")
    out["layers/ln2"] = ((n, d), "ones")
    out["final_norm"] = ((d,), "ones")
    out["lm_head"] = ((d, vp), "dense")
    return out


def numpy_params(cfg, seed: int = 0) -> Params:
    """Random params as numpy float32 arrays in the reference's layout
    (``models.params.numpy_params``)."""
    check_supported(cfg)
    return P.numpy_params(param_shapes(cfg), seed)


def init_params(cfg, gen: torch.Generator, device=None) -> Params:
    """Random params with the reference's shapes and scales, drawn from
    ``gen``."""
    check_supported(cfg)
    return P.torch_params(param_shapes(cfg), gen, device)


_SPLIT_LEAVES = re.compile(r"(tm/w[rkvgo]|cm/w[kvr])$")


def keeps_model_shard(cfg, path: str, model: int = 0) -> bool:
    """Whether the mesh steps keep this param leaf's ``model`` shard (of a
    ``model`` axis of ``model`` ranks; 0: any) and compute on it: the
    embedding and the head, and the time and channel mixes' products
    where the axis divides the heads and the channel mix's width
    (``sharding.ssm_heads``).  The rest is gathered over ``model`` first:
    the token-shift ``mu``, the decay LoRA ``wa`` / ``wb`` and ``w0``,
    ``u``, ``ln_x`` and the norm scales, which every rank uses whole or
    at its heads."""
    if re.search(r"(^|/)(embed|lm_head)$", path):
        return True
    return bool(_SPLIT_LEAVES.search(path)) and (
        model <= 1 or _heads(cfg, ModelSplit(None, model, 0)).split)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _shift(x, last=None):
    """Token shift: x_{t-1} (zeros, or the ``last`` carry, at t = 0).
    x: (B, S, D).  The concatenation promotes as JAX's does (a float32
    carry makes the shifted row float32)."""
    pad = torch.zeros_like(x[:, :1]) if last is None else last[:, None, :]
    return torch.cat([pad, x[:, :-1]], dim=1)


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with the operands promoted as ``jnp.matmul`` promotes
    them (a float32 state's shift against bfloat16 weights: float32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


def _heads(cfg, split):
    """The rank's ``sharding.SsmHeads`` of a time mix under ``split`` (a
    ``mesh.ModelSplit`` or None; the channel mix splits with it)."""
    return ssm_heads(cfg.ssm_heads, split, cfg.d_ff)


def _time_mix(p, x, cfg, qcfg, state=None, last=None, chunk=16):
    """x: (B, S, D). state: (B, H, dh, dh) or None (under the split the
    rank's heads).  Returns (out, state').  Under the split the rank
    computes its heads: ``w[rkvg]`` hold their columns, ``wo`` their
    rows, and the decay, ``u`` and ``ln_x`` are taken at them."""
    P.refuse_packed(p, ("mu", "wa", "wb", "u", "ln_x"), _PACKED_TM)
    b, s, d = x.shape
    dh = d // cfg.ssm_heads
    heads = _heads(cfg, current_split())
    h, cols = heads.n, slice(heads.lo * dh, (heads.lo + heads.n) * dh)
    whole = "tokens" if current_split() and not heads.split else None
    col = "col" if heads.split else whole
    if heads.split:
        x = copy_to_model(x)
        p = {**p, **L.replicated_leaves(p, ("mu", "wa", "wb", "w0", "u",
                                             "ln_x"))}
    xs = _shift(x, last)
    mu = p["mu"]
    mr = x + mu[0] * (xs - x)
    mk = x + mu[1] * (xs - x)
    mv = x + mu[2] * (xs - x)
    mg = x + mu[3] * (xs - x)
    mw = x + mu[4] * (xs - x)

    r = L.qdense(mr, p["wr"], qcfg, split=col).reshape(b, s, h, dh)
    k = L.qdense(mk, p["wk"], qcfg, split=col).reshape(b, s, h, dh)
    v = L.qdense(mv, p["wv"], qcfg, split=col).reshape(b, s, h, dh)
    g = torch.nn.functional.silu(L.qdense(mg, p["wg"], qcfg, split=col))
    # data-dependent decay (Finch): log w = -exp(w0 + tanh(x a) b) <= 0,
    # two plain products, as the reference writes them (b's columns and
    # w0 at the rank's heads)
    lw = -torch.exp(p["w0"][..., cols] + _matmul(
        torch.tanh(_matmul(mw, p["wa"])), p["wb"][..., cols]))
    lw = lw.reshape(b, s, h, dh)
    u = p["u"][heads.lo:heads.lo + h]

    if s == 1 and state is not None:
        o, new_state = SSM.single_step(r[:, 0], k[:, 0], v[:, 0], lw[:, 0],
                                       u, state)
        o = o[:, None]
    else:
        o, new_state = SSM.chunked_linear_attention(
            r, k, v, lw, u, chunk=chunk, initial_state=state)
    o = L.rmsnorm(o, p["ln_x"][heads.lo:heads.lo + h])   # per-head norm
    o = (o.reshape(b, s, h * dh) * g).to(x.dtype)
    out = L.qdense(o, p["wo"], qcfg, split="row" if heads.split else whole)
    return (reduce_from_model(out) if heads.split else out), new_state


def _channel_mix(p, x, cfg, qcfg, last=None):
    """Under the split ``wk`` / ``wr`` hold the rank's columns and ``wv``
    its rows: the value's partial sums are summed over the group and the
    receptance gathered (both whole on every rank after)."""
    P.refuse_packed(p, ("mu",), _PACKED_CM)
    split = _heads(cfg, current_split()).split
    whole = "tokens" if current_split() and not split else None
    col, row = ("col", "row") if split else (whole, whole)
    if split:
        x = copy_to_model(x)
        p = {**p, **L.replicated_leaves(p, ("mu",))}
    xs = _shift(x, last)
    mu = p["mu"]
    mk = x + mu[0] * (xs - x)
    mr = x + mu[1] * (xs - x)
    k = torch.square(torch.relu(L.qdense(mk, p["wk"], qcfg, split=col)))
    r = torch.sigmoid(L.qdense(mr, p["wr"], qcfg, split=col))
    kv = L.qdense(k, p["wv"], qcfg, split=row)
    if split:
        return gather_from_model(r) * reduce_from_model(kv)
    return r * kv


def _block(p, x, cfg, qcfg, state=None, chunk=16):
    """state: None (training) or {"s": (B, H, dh, dh), "tm_last": (B, D),
    "cm_last": (B, D)}."""
    tm_last = None if state is None else state["tm_last"]
    cm_last = None if state is None else state["cm_last"]
    s_in = None if state is None else state["s"]
    h = L.rmsnorm(x, p["ln1"])
    att, s_out = _time_mix(p["tm"], h, cfg, qcfg, s_in, tm_last, chunk)
    new_tm_last = h[:, -1]
    x = x + att.to(x.dtype)
    h2 = L.rmsnorm(x, p["ln2"])
    x = x + _channel_mix(p["cm"], h2, cfg, qcfg, cm_last).to(x.dtype)
    new_state = None
    if state is not None:
        new_state = {"s": s_out, "tm_last": new_tm_last,
                     "cm_last": h2[:, -1]}
    return x, new_state


def _embed(params, tokens, cfg):
    return L.embed_rows(params["embed"], tokens, cfg.padded_vocab).to(
        getattr(torch, cfg.dtype))


def _logits(params, x, cfg, qcfg):
    x = L.rmsnorm(x, params["final_norm"])
    return L.head_logits(x, params["lm_head"], qcfg, cfg.padded_vocab)


def forward(params, tokens, cfg, positions=None):
    """tokens: (B, S) -> logits (B, S, Vp).  ``positions`` is taken and
    ignored, as in the reference (the model has none)."""
    check_supported(cfg)
    qcfg = preset(cfg.pe_type)
    x = _embed(params, tokens, cfg)
    # each layer rematerialized, as the reference's scan checkpoints it
    for i in range(cfg.n_layers):
        x = L.remat(lambda p, x: _block(p, x, cfg, qcfg)[0],
                    P.layer(params["layers"], i), x)
    return _logits(params, x, cfg, qcfg)


def loss_fn(params, batch, cfg):
    """batch: {'tokens': (B, S), 'labels': (B, S)} -> scalar CE loss.  Each
    layer is rematerialized (``layers.remat``), as the reference's
    ``jax.checkpoint``, which changes no value."""
    logits = forward(params, batch["tokens"], cfg)
    return L.softmax_xent(logits, batch["labels"],
                          split=L.split_over(cfg.padded_vocab) is not None)


# ---------------------------------------------------------------------------
# serving: O(1) state a layer, no KV cache
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int = 0, dtype=torch.float32,
               device=None):
    """Each layer's state, stacked on a leading L axis: ``s`` (L, B, H,
    dh, dh) float32, ``tm_last`` and ``cm_last`` (L, B, D) in ``dtype``.
    ``max_len`` is taken and ignored, as in the reference."""
    check_supported(cfg)
    from repro_torch.device import resolve_device
    device = resolve_device(device)
    h = cfg.ssm_heads
    dh = cfg.d_model // h
    n, d = cfg.n_layers, cfg.d_model
    return {"s": torch.zeros((n, batch, h, dh, dh), dtype=torch.float32,
                             device=device),
            "tm_last": torch.zeros((n, batch, d), dtype=dtype, device=device),
            "cm_last": torch.zeros((n, batch, d), dtype=dtype,
                                   device=device)}


def _apply_with_state(params, tokens, cfg, cache, chunk=16):
    state = cache["tm_last"].dtype
    if state.is_floating_point and state.itemsize == 1:
        raise ValueError(
            f"RWKV6 token-shift states of {state}: the "
            f"reference refuses 8-bit float states (jnp.concatenate with "
            f"the hidden states has no float8 type promotion path)")
    qcfg = preset(cfg.pe_type)
    x = _embed(params, tokens, cfg)
    states = []
    for i in range(cfg.n_layers):
        x, st = _block(P.layer(params["layers"], i), x, cfg, qcfg,
                       P.layer(cache, i), chunk)
        states.append(st)
    new_cache = {k: torch.stack([st[k] for st in states]) for k in states[0]}
    return _logits(params, x, cfg, qcfg), new_cache


def prefill(params, tokens, cfg, cache, positions=None):
    """Run a prompt from the cache's state; returns (logits_last, cache)."""
    check_supported(cfg)
    logits, cache = _apply_with_state(params, tokens, cfg, cache)
    return logits[:, -1:], cache


def decode_step(params, token, cfg, cache, positions=None):
    """token: (B, 1) -> (logits (B, 1, Vp), new cache)."""
    check_supported(cfg)
    return _apply_with_state(params, token, cfg, cache)
