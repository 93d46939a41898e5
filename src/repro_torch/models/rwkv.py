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

The serving packer packs by size: at full width it packs ``mu``, the
decay LoRA ``wa`` / ``wb``, and at 24 layers ``u`` and ``ln_x``, which
the reference then reads as dense tensors and fails on (ROADMAP C); the
port raises ``NotImplementedError`` there, naming that failure.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

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


def _time_mix(p, x, cfg, qcfg, state=None, last=None, chunk=16):
    """x: (B, S, D). state: (B, H, dh, dh) or None.  Returns (out,
    state')."""
    P.refuse_packed(p, ("mu", "wa", "wb", "u", "ln_x"), _PACKED_TM)
    b, s, d = x.shape
    h = cfg.ssm_heads
    dh = d // h
    xs = _shift(x, last)
    mu = p["mu"]
    mr = x + mu[0] * (xs - x)
    mk = x + mu[1] * (xs - x)
    mv = x + mu[2] * (xs - x)
    mg = x + mu[3] * (xs - x)
    mw = x + mu[4] * (xs - x)

    r = L.qdense(mr, p["wr"], qcfg).reshape(b, s, h, dh)
    k = L.qdense(mk, p["wk"], qcfg).reshape(b, s, h, dh)
    v = L.qdense(mv, p["wv"], qcfg).reshape(b, s, h, dh)
    g = torch.nn.functional.silu(L.qdense(mg, p["wg"], qcfg))
    # data-dependent decay (Finch): log w = -exp(w0 + tanh(x a) b) <= 0,
    # two plain products, as the reference writes them
    lw = -torch.exp(p["w0"] + _matmul(torch.tanh(_matmul(mw, p["wa"])),
                                      p["wb"]))
    lw = lw.reshape(b, s, h, dh)

    if s == 1 and state is not None:
        o, new_state = SSM.single_step(r[:, 0], k[:, 0], v[:, 0], lw[:, 0],
                                       p["u"], state)
        o = o[:, None]
    else:
        o, new_state = SSM.chunked_linear_attention(
            r, k, v, lw, p["u"], chunk=chunk, initial_state=state)
    o = L.rmsnorm(o, p["ln_x"])                     # per-head norm
    o = (o.reshape(b, s, d) * g).to(x.dtype)
    return L.qdense(o, p["wo"], qcfg), new_state


def _channel_mix(p, x, cfg, qcfg, last=None):
    P.refuse_packed(p, ("mu",), _PACKED_CM)
    xs = _shift(x, last)
    mu = p["mu"]
    mk = x + mu[0] * (xs - x)
    mr = x + mu[1] * (xs - x)
    k = torch.square(torch.relu(L.qdense(mk, p["wk"], qcfg)))
    r = torch.sigmoid(L.qdense(mr, p["wr"], qcfg))
    return r * L.qdense(k, p["wv"], qcfg)


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
    return params["embed"][tokens].to(getattr(torch, cfg.dtype))


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
    x = L.rmsnorm(x, params["final_norm"])
    return L.qdense(x, params["lm_head"], qcfg)


def loss_fn(params, batch, cfg):
    """batch: {'tokens': (B, S), 'labels': (B, S)} -> scalar CE loss.  Each
    layer is rematerialized (``layers.remat``), as the reference's
    ``jax.checkpoint``, which changes no value."""
    logits = forward(params, batch["tokens"], cfg)
    return L.softmax_xent(logits, batch["labels"])


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
    qcfg = preset(cfg.pe_type)
    x = _embed(params, tokens, cfg)
    states = []
    for i in range(cfg.n_layers):
        x, st = _block(P.layer(params["layers"], i), x, cfg, qcfg,
                       P.layer(cache, i), chunk)
        states.append(st)
    new_cache = {k: torch.stack([st[k] for st in states]) for k in states[0]}
    x = L.rmsnorm(x, params["final_norm"])
    return L.qdense(x, params["lm_head"], qcfg), new_cache


def prefill(params, tokens, cfg, cache, positions=None):
    """Run a prompt from the cache's state; returns (logits_last, cache)."""
    check_supported(cfg)
    logits, cache = _apply_with_state(params, tokens, cfg, cache)
    return logits[:, -1:], cache


def decode_step(params, token, cfg, cache, positions=None):
    """token: (B, 1) -> (logits (B, 1, Vp), new cache)."""
    check_supported(cfg)
    return _apply_with_state(params, token, cfg, cache)
